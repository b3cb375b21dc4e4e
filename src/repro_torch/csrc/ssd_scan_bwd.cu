// The chunked SSD scan's backward (Mamba-2), fp32: given dy and the final
// state's gradient (or none), the gradients of x, dt, A, B, C and of the
// initial state. Per (batch, chunk, head h in group g), with cum the
// within-chunk cumulative sum of dt * A, S0 the chunk's start state, G the
// gradient reaching its end state, L_ts = exp(cum_t - cum_s) for s <= t
// (else 0), CB = C B^T, K = CB o L, dP = dy x^T, M = dP o L and
// w_s = exp(cum_end - cum_s):
//   dx_s  = sum_t K_ts dt_s dy_t + w_s dt_s G B_s
//   dC_t  = sum_s M_ts dt_s B_s + exp(cum_t) S0^T dy_t
//   dB_s  = dt_s sum_t M_ts C_t + w_s dt_s G^T x_s
//   ddt_s = sum_t K_ts dP_ts + w_s x_s . G B_s + A_h sum_{u >= s} dcum_u
//   dcum_t = sum_s W_ts - sum_s W_st + exp(cum_t) dy_t . S0 C_t - V_t
//            (+ sum_s V_s + exp(cum_end) <S0, G> at the chunk's last step),
//   W = K o dt_s o dP = CB o M o dt_s, V_s = dt_s w_s x_s . G B_s;
// sum_t K_ts dP_ts = sum_t CB_ts M_ts, and exp(cum_t) dy_t . S0 C_t is C_t
// dotted with dC_t's state term.
// dA_h sums dt_u sum_{t >= u} dcum_t over batch, chunks and steps; G of
// the chunk before is exp(cum_end) G + sum_t exp(cum_t) dy_t C_t^T, and the
// first chunk's is the initial state's gradient. The plain version is
// kernels/ref.py:ssd_scan_bwd_ref, written step by step.
//
// Replaces: the TPU kernel src/repro/kernels/ssd_scan.py:ssd_scan_pallas
// has no backward; the JAX package differentiates its plain jnp scan
// (src/repro/arch/ssm.py:50) when it trains Mamba2.
//
// Bound on the H100: operations. At the trainer's shape (x (8, 128, 24,
// 64), B and C (8, 128, 1, 128), one chunk of 128, no initial state and no
// final-state gradient) the five products over the causal pairs (C B^T,
// dy x^T, dx, dC, dB) need 1.62 GFLOP, 9.8 us at the 165 TFLOP/s of fp32
// products as 3xTF32 on the tensor cores, against 6.3 us for the bytes
// (chip_smoke.py phase 9 (e) logs the count).
//
// Design: four kernels, launched in order on one stream.
//   1. The state pass (only where some chunk has a G or the initial state
//      wants a gradient: more than one chunk, a final-state gradient or an
//      initial state): one block per (batch, head) walks the chunks last to
//      first with G (p x n) in shared memory, writes each chunk's G for
//      kernel 2 and, after the first chunk, the initial state's gradient
//      (fp32 FMA on the CUDA cores: off the one-chunk path).
//   2a. C B^T: it does not depend on the head, so the heads of a group
//      share it. One block of four warps per (batch, chunk, group) and
//      16-row strip of s forms the strip's 16 x 8 tiles on or past the
//      diagonal (3xTF32 m16n8k8, the strip's B rows held as A fragments)
//      into a scratch in the chunk kernel's fragment layout, a float4 a
//      lane (64 KB a (batch, chunk, group)): 1/24 of the work the heads
//      would each repeat at the trainer's 24 heads a group.
//   2. The chunk kernel, 2a's programmatic dependent (its staging and
//      step a. run while 2a does; it waits for 2a before step b.): one
//      block of 16 warps per (batch, chunk, head),
//      every product as 3xTF32 m16n8k8 steps on the tensor cores
//      (mma_tf32x3.cuh), only over the causal triangle: no 16 x 8 tile
//      wholly above the diagonal is formed, and tiles on it are masked by
//      index, e^(cum_t - cum_s) formed only where s <= t (above the
//      diagonal the exponent is positive and can overflow). B, C and dy of
//      the chunk are staged once by cp.async (16 bytes a thread where the
//      rows allow, else 4; x, B and C read through their batch and length
//      strides, views of the packed projection), with zero fill past the
//      chunk, n and p; x is read straight into registers. Rows are padded
//      to 4 mod 8 floats, so the fragment reads hit distinct banks. Then:
//      a. dP = dy x^T, once: the 16 x 8 tiles on or past each 16-row
//         strip's diagonal, split evenly over the warps; a warp holds its
//         strip's x rows as A fragments, forms up to four tiles at a time
//         and writes M = dP o L into shared memory, s-major, strip j
//         keeping only its columns t >= 16 j (39 KB, not 66).
//      b. Every output by tiles of its own rows:
//         - dx by strips of s (the first S16 warps; a strip pair (j,
//           S16 - 1 - j) split evenly over two warps, the first half's
//           partial written out and, after a named barrier, read back by
//           the second and added in that order): per 8 t, 2a's C B^T tile
//           (16 s x 8 t, the next one's load in flight), K^T o dt formed
//           in registers and fed straight back as the A operand against
//           dy (the header's paired k order), and W = CB o M o dt from M
//           beside it, its row and column sums taken from the same terms
//           (the antisymmetric pair in dcum then cancels as the plain
//           version's does);
//         - dC^T (64 n x 8 t tiles over s <= t: B^T against M o dt read
//           from shared memory, plus e^(cum_t) S0^T dy^T, dotted with
//           C_t for dcum);
//         - dB (16 s x 32 n tiles over t >= s: M^T against C, times dt,
//           plus w_s dt_s x G);
//         the dC and dB tiles drawn by every warp, dx's as they finish,
//         from a list ordered longest first (each tile is one warp's whole
//         sum, so which warp draws it changes no bit).
//      c. dcum, its reverse cumsum, ddt and the block's share of dA: one
//         warp, four steps a lane, a suffix scan by shuffles in a fixed
//         order.
//      About 218 KB of shared memory, so one block of 16 warps an SM.
//   3. The group sums, kernel 2's programmatic dependent (launched under
//      its second wave): dB and dC of group g add its heads' partials
//      (dense (b, l, h, n) scratch from kernel 2) in ascending head order,
//      four heads' loads in flight, float4 where n allows; dA adds the
//      blocks' shares over batch and chunks in order. A cluster per group
//      cannot hold the trainer's 24 heads of one group, and a block
//      walking three heads would leave 64 blocks for 132 SMs.
// No floating-point atomics anywhere: two runs are bit-equal. dy, dfinal
// and the saved states are dense; the gradients are written dense.
//
// C interface: launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "mma_tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int MAXQ = 128;   // largest chunk
constexpr int MAXN = 128;   // largest state size n
constexpr int MAXP = 64;    // largest head dim p
static_assert(MAXQ == 4 * 32, "the cum scans give each lane four steps");

// -- kernel 2, the chunk kernel ----------------------------------------------

constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int STRIPS = MAXQ / 16;   // 16-row strips of s
constexpr int LDN = MAXN + 4;       // B, C rows
constexpr int LDP = MAXP + 4;       // dy rows
constexpr int KN = MAXN / 8;        // most k-steps over n
constexpr int KP = MAXP / 8;        // most k-steps over p, and p-tiles
constexpr int MAX_ITEMS = 2 * (MAXQ / 8) + 4 * STRIPS;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(STRIPS <= WARPS && STRIPS / 2 <= 15, "a named barrier a pair");

// M's strip j: rows s in [16 j, 16 j + 16), columns t in [16 j, MAXQ), rows
// of band_ld(j) floats (4 mod 8) from band_off(j).
__host__ __device__ constexpr int band_ld(int j) { return MAXQ - 16 * j + 4; }
__host__ __device__ constexpr int band_off(int j) {
  return 16 * (j * (MAXQ + 4) - 8 * j * (j - 1));
}

struct ChunkSmem {
  float bs[MAXQ * LDN];           // B of the chunk (rows s)
  float cs[MAXQ * LDN];           // C (rows t)
  float ys[MAXQ * LDP];           // dy
  float mb[band_off(STRIPS)];     // M = dP o L, strip by strip
  float dts[MAXQ], cum[MAXQ], ecum[MAXQ], wq[MAXQ];
  float ddtd[MAXQ];               // sum_t K_ts dP_ts
  float colw[MAXQ];               // sum_t W_ts, W = K o dt_s o dP
  float roww[STRIPS][MAXQ];       // sum_s W_ts over each strip of s
  float t2[MAXQ];                 // w_s x_s . G B_s
  float t5[2][MAXQ];              // e^cum_t dy_t . S0 C_t, n < 64, >= 64
  float red[WARPS];
  int items[MAX_ITEMS];           // the dC and dB tiles, longest first
  int n_items, next;
};

static_assert(sizeof(ChunkSmem) <= 232448, "one block's shared memory");

struct Args {
  const float *x, *dt, *A, *Bm, *Cm, *dy, *states, *gbuf;
  const float4* cbuf;
  float *dx, *ddt, *dbh, *dch, *dapart;
  int64_t L, H, P, G, N, Q, NC;
  int64_t x_sb, x_sl, dt_sb, dt_sl, b_sb, b_sl, c_sb, c_sl;
  int has_init, g_last_zero, vec_b, vec_c, vec_y;
};

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// Rows [0, rows_pad) and columns [0, CC) of dst (rows of ld) from
// src[r * rs + c], by cp.async; zero past rows x cols. 16-byte copies when
// `vec` (cols a multiple of 4, src and rs 16-byte aligned), else 4.
template <int CC, int NT = THREADS>
__device__ __forceinline__ void stage_async(float* dst, int ld, int rows_pad,
                                            const float* src, int64_t rs,
                                            int rows, int cols, bool vec) {
  if (vec) {
    constexpr int C4 = CC / 4;
    for (int e = threadIdx.x; e < rows_pad * C4; e += NT) {
      const int r = e / C4, c = 4 * (e % C4);
      const bool ok = r < rows && c < cols;
      cp_async16(dst + r * ld + c, ok ? src + r * rs + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows_pad * CC; e += NT) {
      const int r = e / CC, c = e % CC;
      const bool ok = r < rows && c < cols;
      cp_async4(dst + r * ld + c, ok ? src + r * rs + c : src, ok);
    }
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&acc)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

__device__ __forceinline__ FragB zero_b() {
  FragB f;
  f.big[0] = f.big[1] = f.small[0] = f.small[1] = 0u;
  return f;
}

// -- kernel 2a, C B^T -----------------------------------------------------

constexpr int CB_WARPS = 4;
constexpr int CB_THREADS = 32 * CB_WARPS;

// Rows of B (the strip's 16) and of C (t from the strip's diagonal on).
struct CbSmem {
  float bs[16 * LDN];
  float cs[MAXQ * LDN];
};

// C B^T of one (batch, chunk, group) and one 16-row strip j of s, for the
// 8-wide tiles of t on or past the strip's diagonal (t-tiles 2 j to
// 2 S16), as transposed tiles (16 s x 8 t) in the accumulator layout of
// the chunk kernel: tile tt of strip j at cbuf[((bcg S16 + j) 2 S16 + tt)
// 32 + lane], a float4 a lane. CB does not depend on the head, so the
// group's heads share it. The block stages the strip's B rows and C's rows
// by cp.async, as the chunk kernel does; a warp forms four tiles at a time.
__global__ void __launch_bounds__(CB_THREADS) ssd_bwd_cb_kernel(
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    float4* __restrict__ cbuf, int64_t G, int64_t N, int64_t Q, int64_t NC,
    int64_t b_sb, int64_t b_sl, int64_t c_sb, int64_t c_sl, int vec_b,
    int vec_c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  CbSmem& sm = *reinterpret_cast<CbSmem*>(smem_raw);
  // the chunk kernel may launch now; it waits for cbuf before it reads it
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x;
  const int64_t bcg = blockIdx.y, bc = bcg / G, grp = bcg % G;
  const int64_t b = bc / NC, c0 = (bc % NC) * Q;
  const int q = static_cast<int>(Q), nn = static_cast<int>(N);
  const int S16 = (q + 15) / 16, NK = (nn + 7) / 8, s0 = 16 * j;
  const int rows = 16 * S16 - s0;   // C's rows t in [s0, 16 S16)
  const float* bb = Bm + b * b_sb + (c0 + s0) * b_sl + grp * N;
  const float* cb = Cm + b * c_sb + (c0 + s0) * c_sl + grp * N;
  stage_async<MAXN, CB_THREADS>(sm.bs, LDN, 16, bb, b_sl, q - s0, nn, vec_b);
  stage_async<MAXN, CB_THREADS>(sm.cs, LDN, rows, cb, c_sl, q - s0, nn,
                                vec_c);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int tt0 = 4 * warp; tt0 < rows / 8; tt0 += 4 * CB_WARPS) {
    float acc[4][4];
    zero(acc);
    for (int kk = 0; kk < NK; ++kk) {
      const FragA af = load_a(sm.bs, LDN, 0, 8 * kk, lane);
      FragB cf[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        cf[u] = tt0 + u < rows / 8
                    ? load_b_nk(sm.cs, LDN, 8 * (tt0 + u), 8 * kk, lane)
                    : zero_b();
      mma3_row<4>(acc, af, cf);
    }
    float4* out = cbuf + ((bcg * S16 + j) * 2 * S16 + 2 * j) * 32 + lane;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (tt0 + u < rows / 8)
        out[(tt0 + u) * 32] =
            make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
  }
}

// Kernel 2: one block per (head, batch x chunk).
__global__ void __launch_bounds__(THREADS, 1)
    ssd_bwd_chunk_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(smem_raw);
  // the group sums may launch now; they wait for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int64_t h = blockIdx.x, bc = blockIdx.y;
  const int64_t b = bc / a.NC, ci = bc % a.NC, c0 = ci * a.Q;
  const int64_t grp = h / (a.H / a.G);
  const int q = static_cast<int>(a.Q), nn = static_cast<int>(a.N);
  const int pp = static_cast<int>(a.P);
  const int S16 = (q + 15) / 16, Q16 = 16 * S16, T8 = (q + 7) / 8;
  const int NK = (nn + 7) / 8, PK = (pp + 7) / 8;
  const float av = a.A[h];
  const float* xb = a.x + b * a.x_sb + c0 * a.x_sl + h * a.P;
  const float* yb = a.dy + ((b * a.L + c0) * a.H + h) * a.P;
  const float* bb = a.Bm + b * a.b_sb + c0 * a.b_sl + grp * a.N;
  const float* cb = a.Cm + b * a.c_sb + c0 * a.c_sl + grp * a.N;
  const float* dtb = a.dt + b * a.dt_sb + c0 * a.dt_sl + h;
  const int64_t orow = (b * a.L + c0) * a.H + h;   // step s: orow + s H
  const int64_t slot = (bc * a.H + h) * a.P * a.N;   // (b, c, h) p x n
  const bool has_g = a.gbuf != nullptr && !(a.g_last_zero && ci == a.NC - 1);
  const bool has_s = a.states != nullptr && !(ci == 0 && !a.has_init);
  const float* gsrc = has_g ? a.gbuf + slot : nullptr;
  const float* ssrc = has_s ? a.states + slot : nullptr;

  // -- dt; dy, then B and C, by cp.async; cum and the tile list ---------
  // (dt's loads go first, ahead of the copies; a. needs dy alone: B and C
  // land while it runs)
  static_assert(MAXQ <= THREADS, "a thread loads one step's dt");
  const float dtv = tid < q ? dtb[tid * a.dt_sl] : 0.f;
  stage_async<MAXP>(sm.ys, LDP, Q16, yb, a.H * a.P, q, pp, a.vec_y);
  cp_async_commit();
  stage_async<MAXN>(sm.bs, LDN, Q16, bb, a.b_sl, q, nn, a.vec_b);
  stage_async<MAXN>(sm.cs, LDN, Q16, cb, a.c_sl, q, nn, a.vec_c);
  cp_async_commit();
  if (tid < MAXQ) {
    sm.dts[tid] = dtv;
    sm.t2[tid] = sm.t5[0][tid] = sm.t5[1][tid] = 0.f;
  }
  if (tid == 0) {
    // dC tiles (8 t wide, k over s <= t: i8 + 1 steps) and dB tiles (16 s
    // high, k over t >= s: 2 (S16 - j) steps) by decreasing length
    int n = 0;
    for (int len = 2 * S16; len > 0; --len) {
      if (len <= T8)
        for (int nh = 0; nh < 2; ++nh)
          if (64 * nh < nn) sm.items[n++] = (nh << 8) | (len - 1);
      if (len % 2 == 0)
        for (int nq = 0; nq < 4; ++nq)
          if (32 * nq < nn) sm.items[n++] = (1 << 16) | (nq << 8) |
                                            (S16 - len / 2);
    }
    sm.n_items = n;
    sm.next = 0;
  }
  __syncthreads();
  if (warp == 0) {
    // cum (inclusive scan of dt * a, cum_end past the chunk), exp(cum_t),
    // w_s: each lane four steps, then the lanes' sums
    float v[4], run = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      run += sm.dts[lane * 4 + e] * av;   // dt is 0 past the chunk
      v[e] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    const float excl = incl - run;
    const float cum_end = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = lane * 4 + e;
      const float c = excl + v[e];
      sm.cum[s] = s < q ? c : cum_end;
      sm.ecum[s] = s < q ? expf(c) : 0.f;
      sm.wq[s] = s < q ? expf(cum_end - c) : 0.f;
    }
  }
  cp_async_wait<1>();   // dy
  __syncthreads();

  // -- a. M = (dy x^T) o L, s-major, by strips ---------------------------
  // The 16 x 8 tiles on or past each strip's diagonal, strip by strip
  // (S16 (S16 + 1) of them), split evenly over the warps; a warp holds the
  // x rows of its current strip as A fragments and forms up to four tiles
  // at a time.
  {
    const int total = S16 * (S16 + 1);
    int lo = total * warp / WARPS;
    const int hi = total * (warp + 1) / WARPS;
    int j = 0, base = 0;   // base: the first tile of strip j in the list
    while (j < S16 && base + 2 * (S16 - j) <= lo) {
      base += 2 * (S16 - j);
      ++j;
    }
    while (lo < hi) {
      const int s0 = 16 * j;
      const int strip_end = base + 2 * (S16 - j);
      const int run_end = hi < strip_end ? hi : strip_end;
      // the strip's x rows as A fragments over p, raw, zero past p, q
      float xf[KP][4];
      const bool ok0 = s0 + g < q, ok1 = s0 + g + 8 < q;
      const float* r0p = xb + (s0 + g) * a.x_sl;
      const float* r1p = xb + (s0 + g + 8) * a.x_sl;
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) {
        const int col = 8 * kk + tq;
        xf[kk][0] = ok0 && col < pp ? r0p[col] : 0.f;
        xf[kk][1] = ok1 && col < pp ? r1p[col] : 0.f;
        xf[kk][2] = ok0 && col + 4 < pp ? r0p[col + 4] : 0.f;
        xf[kk][3] = ok1 && col + 4 < pp ? r1p[col + 4] : 0.f;
      }
      float* band = sm.mb + band_off(j);
      const int ld = band_ld(j);
      const float cs0 = sm.cum[s0 + g], cs1 = sm.cum[s0 + g + 8];
      for (int f = lo; f < run_end; f += 4) {
        const int tt0 = 2 * j + (f - base);
        const int ntl = run_end - f < 4 ? run_end - f : 4;
        float acc[4][4];
        zero(acc);
#pragma unroll
        for (int kk = 0; kk < KP; ++kk) {
          if (kk >= PK) continue;
          const FragA af = split_a(xf[kk][0], xf[kk][1], xf[kk][2],
                                   xf[kk][3]);
          FragB bf[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            bf[u] = u < ntl ? load_b_nk(sm.ys, LDP, (tt0 + u) * 8, kk * 8,
                                        lane)
                            : zero_b();
          mma3_row<4>(acc, af, bf);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (u >= ntl) continue;
          const int t = (tt0 + u) * 8 + 2 * tq;
          float m[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = s0 + g + (e >> 1) * 8, tt = t + (e & 1);
            m[e] = s <= tt && tt < q
                       ? acc[u][e] * fast_exp2((sm.cum[tt] -
                                                (e >> 1 ? cs1 : cs0)) *
                                               LOG2E)
                       : 0.f;
          }
          *reinterpret_cast<float2*>(band + g * ld + t - s0) =
              make_float2(m[0], m[1]);
          *reinterpret_cast<float2*>(band + (g + 8) * ld + t - s0) =
              make_float2(m[2], m[3]);
        }
      }
      lo = run_end;
      base = strip_end;
      ++j;
    }
  }
  cp_async_wait<0>();   // B and C
  asm volatile("griddepcontrol.wait;" ::: "memory");   // kernel 2a's C B^T
  __syncthreads();   // M is whole

  // -- b. dx by strips ---------------------------------------------------
  // One segment: strip j, the 8-wide tiles of t from tb to te. dxa holds
  // its partial dx; dd and cw, of rows g and g + 8 summed over the quad,
  // its sum_t CB_ts M_ts (= K_ts dP_ts) and sum_t W_ts; roww[j][t] gets
  // sum_s W_ts for each of its t. W is formed once, so the row and column
  // sums that dcum subtracts hold the same terms.
  auto dx_segment = [&](int j, int tb, int te, float (&dxa)[KP][4],
                        float (&dd)[2], float (&cw)[2]) {
    const int s0 = 16 * j;
    const float* band = sm.mb + band_off(j);
    const int ld = band_ld(j);
    zero(dxa);
    dd[0] = dd[1] = cw[0] = cw[1] = 0.f;
    const float cs0 = sm.cum[s0 + g], cs1 = sm.cum[s0 + g + 8];
    const float dt0 = sm.dts[s0 + g], dt1 = sm.dts[s0 + g + 8];
    if (tb == 2 * j && has_g) {
      // G B_s, then t2_s = w_s x_s . G B_s and dx = w_s dt_s G B_s
      for (int kk = 0; kk < NK; ++kk) {
        const FragA af = load_a(sm.bs, LDN, s0, kk * 8, lane);
        const int col = kk * 8 + tq;
#pragma unroll
        for (int p0 = 0; p0 < KP; p0 += 4) {
          FragB gf[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int pr = (p0 + u) * 8 + g;
            const float* gr = gsrc + pr * a.N;
            gf[u] = split_b(pr < pp && col < nn ? gr[col] : 0.f,
                            pr < pp && col + 4 < nn ? gr[col + 4] : 0.f);
          }
          mma3_row<4>(&dxa[p0], af, gf);
        }
      }
      float x2[2] = {0.f, 0.f};
#pragma unroll
      for (int pt = 0; pt < KP; ++pt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = s0 + g + (e >> 1) * 8, pc = pt * 8 + 2 * tq + (e & 1);
          if (s < q && pc < pp) x2[e >> 1] += xb[s * a.x_sl + pc] * dxa[pt][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        x2[i] += __shfl_xor_sync(0xffffffffu, x2[i], 1);
        x2[i] += __shfl_xor_sync(0xffffffffu, x2[i], 2);
      }
      const float w0 = sm.wq[s0 + g], w1 = sm.wq[s0 + g + 8];
      if (tq == 0) {
        sm.t2[s0 + g] = w0 * x2[0];
        sm.t2[s0 + g + 8] = w1 * x2[1];
      }
#pragma unroll
      for (int pt = 0; pt < KP; ++pt) {
        dxa[pt][0] *= w0 * dt0;
        dxa[pt][1] *= w0 * dt0;
        dxa[pt][2] *= w1 * dt1;
        dxa[pt][3] *= w1 * dt1;
      }
    }
    // C B^T of the strip's tiles, from kernel 2a; the next tile's is
    // asked for before this one is used
    const float4* cbt_src =
        a.cbuf + ((bc * a.G + grp) * S16 + j) * 2 * S16 * 32 + lane;
    float4 next =
        tb < te ? cbt_src[tb * 32] : make_float4(0.f, 0.f, 0.f, 0.f);
    for (int tt = tb; tt < te; ++tt) {
      const float4 cur = next;
      if (tt + 1 < te) next = cbt_src[(tt + 1) * 32];
      const float cbv4[4] = {cur.x, cur.y, cur.z, cur.w};
      const int t = 8 * tt + 2 * tq;
      const float2 m01 =
          *reinterpret_cast<const float2*>(band + g * ld + t - s0);
      const float2 m23 =
          *reinterpret_cast<const float2*>(band + (g + 8) * ld + t - s0);
      const float mv[4] = {m01.x, m01.y, m23.x, m23.y};
      float kv[4], rw[2];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = s0 + g + (e >> 1) * 8, tc = t + (e & 1);
        const float dts = e >> 1 ? dt1 : dt0;
        const float kd = cbv4[e] * mv[e];   // M is 0 off the triangle
        const float w = kd * dts;
        dd[e >> 1] += kd;
        cw[e >> 1] += w;
        if (e < 2) rw[e] = w;
        else rw[e - 2] += w;
        kv[e] = s <= tc && tc < q
                    ? cbv4[e] * dts *
                          fast_exp2((sm.cum[tc] - (e >> 1 ? cs1 : cs0)) *
                                    LOG2E)
                    : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          rw[i] += __shfl_xor_sync(0xffffffffu, rw[i], off);
      if (g == 0) {
        sm.roww[j][t] = rw[0];
        sm.roww[j][t + 1] = rw[1];
      }
      const FragA ka = acc_as_a(kv);
#pragma unroll
      for (int p0 = 0; p0 < KP; p0 += 4) {
        if (p0 >= PK) continue;
        FragB yf[4];
#pragma unroll
        for (int w = 0; w < 4; ++w)
          yf[w] = load_b_paired(sm.ys, LDP, 8 * tt, (p0 + w) * 8, lane);
        mma3_row<4>(&dxa[p0], ka, yf);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      dd[i] += __shfl_xor_sync(0xffffffffu, dd[i], 1);
      dd[i] += __shfl_xor_sync(0xffffffffu, dd[i], 2);
      cw[i] += __shfl_xor_sync(0xffffffffu, cw[i], 1);
      cw[i] += __shfl_xor_sync(0xffffffffu, cw[i], 2);
    }
  };
  // dx, ddtd and colw of strip j out; with `first`, after the strip's
  // first half, which another warp wrote there, added before this half
  auto dx_out = [&](int j, float (&dxa)[KP][4], float (&dd)[2],
                    float (&cw)[2], bool first) {
    const int s0 = 16 * j;
    if (first) {
      // every load before any store: one trip to L2, not one a value
      float prev[KP][4];
#pragma unroll
      for (int pt = 0; pt < KP; ++pt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = s0 + g + (e >> 1) * 8;
          const int pc = pt * 8 + 2 * tq + (e & 1);
          prev[pt][e] = s < q && pc < pp
                            ? __ldcg(a.dx + (orow + s * a.H) * a.P + pc)
                            : 0.f;
        }
#pragma unroll
      for (int pt = 0; pt < KP; ++pt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dxa[pt][e] = prev[pt][e] + dxa[pt][e];
    }
#pragma unroll
    for (int pt = 0; pt < KP; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = s0 + g + (e >> 1) * 8, pc = pt * 8 + 2 * tq + (e & 1);
        if (s < q && pc < pp) a.dx[(orow + s * a.H) * a.P + pc] = dxa[pt][e];
      }
    if (tq == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int s = s0 + g + 8 * i;
        sm.ddtd[s] = first ? sm.ddtd[s] + dd[i] : dd[i];
        sm.colw[s] = first ? sm.colw[s] + cw[i] : cw[i];
      }
    }
  };
  if (warp < S16) {
    // strip j holds tiles [2 j, 2 S16) of t; a pair (m, S16 - 1 - m) holds
    // 2 S16 + 2, S16 + 1 a warp, as the middle strip (S16 odd) does alone
    const int pairs = S16 / 2, half = S16 + 1;
    float dxa[KP][4], dd[2], cw[2];
    if (warp >= 2 * pairs) {   // the middle strip, whole
      dx_segment(pairs, 2 * pairs, 2 * S16, dxa, dd, cw);
      dx_out(pairs, dxa, dd, cw, false);
    } else if (warp % 2 == 0) {   // strip m's first S16 + 1 tiles
      const int m = warp / 2;
      dx_segment(m, 2 * m, 2 * m + half, dxa, dd, cw);
      dx_out(m, dxa, dd, cw, false);
      __threadfence_block();
      named_arrive(1 + m, 64);
    } else {   // strip S16 - 1 - m whole, then the rest of strip m
      const int m = warp / 2, jb = S16 - 1 - m;
      dx_segment(jb, 2 * jb, 2 * S16, dxa, dd, cw);
      dx_out(jb, dxa, dd, cw, false);
      dx_segment(m, 2 * m + half, 2 * S16, dxa, dd, cw);
      named_sync(1 + m, 64);
      dx_out(m, dxa, dd, cw, true);
    }
  }

  // -- b. the dC and dB tiles, drawn longest first ------------------------
  for (;;) {
    int it = 0;
    if (lane == 0) it = atomicAdd(&sm.next, 1);
    it = __shfl_sync(0xffffffffu, it, 0);
    if (it >= sm.n_items) break;
    const int code = sm.items[it];
    const int sub = (code >> 8) & 0xff, idx = code & 0xff;
    float acc[4][4];
    zero(acc);
    if ((code >> 16) == 0) {
      // dC^T: 64 n (sub) x 8 t (idx); k over s < 8 (idx + 1)
      const int t0 = 8 * idx, n0 = 64 * sub;
      for (int kk = 0; kk <= idx; ++kk) {
        const int j = kk / 2;
        const FragB mf = load_b_paired(
            sm.mb + band_off(j), band_ld(j), 8 * kk - 16 * j, t0 - 16 * j,
            lane, sm.dts[8 * kk + 2 * tq], sm.dts[8 * kk + 2 * tq + 1]);
        FragA af[4];
#pragma unroll
        for (int w = 0; w < 4; ++w)
          af[w] = load_at_paired(sm.bs, LDN, 8 * kk, n0 + 16 * w, lane);
        mma3_col<4>(acc, af, mf);
      }
      if (has_s) {
        // + exp(cum_t) (S0^T dy^T)[n][t]
        float sd[4][4];
        zero(sd);
        for (int kp = 0; kp < PK; ++kp) {
          const FragB yf = load_b_nk(sm.ys, LDP, t0, 8 * kp, lane);
          const int p0 = 8 * kp + tq;
          FragA af[4];
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const int n1 = n0 + 16 * w + g, n2 = n1 + 8;
            const float* s0r = ssrc + p0 * a.N;
            const float* s4r = ssrc + (p0 + 4) * a.N;
            af[w] = split_a(p0 < pp && n1 < nn ? s0r[n1] : 0.f,
                            p0 < pp && n2 < nn ? s0r[n2] : 0.f,
                            p0 + 4 < pp && n1 < nn ? s4r[n1] : 0.f,
                            p0 + 4 < pp && n2 < nn ? s4r[n2] : 0.f);
          }
          mma3_col<4>(sd, af, yf);
        }
        // and t5_t = C_t . e^(cum_t) (S0^T dy_t), over these n
        const float e0 = sm.ecum[t0 + 2 * tq], e1 = sm.ecum[t0 + 2 * tq + 1];
        float rd[2] = {0.f, 0.f};
#pragma unroll
        for (int w = 0; w < 4; ++w)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = n0 + 16 * w + g + (e >> 1) * 8;
            const int t = t0 + 2 * tq + (e & 1);
            const float v = (e & 1 ? e1 : e0) * sd[w][e];
            acc[w][e] += v;
            if (n < nn) rd[e & 1] += sm.cs[t * LDN + n] * v;
          }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            rd[i] += __shfl_xor_sync(0xffffffffu, rd[i], off);
        if (g == 0) {
          sm.t5[sub][t0 + 2 * tq] = rd[0];
          sm.t5[sub][t0 + 2 * tq + 1] = rd[1];
        }
      }
#pragma unroll
      for (int w = 0; w < 4; ++w)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = n0 + 16 * w + g + (e >> 1) * 8;
          const int t = t0 + 2 * tq + (e & 1);
          if (n < nn && t < q) a.dch[(orow + t * a.H) * a.N + n] = acc[w][e];
        }
    } else {
      // dB: 16 s (strip idx) x 32 n (sub); k over t >= 16 idx
      const int s0 = 16 * idx, n0 = 32 * sub;
      const float* band = sm.mb + band_off(idx);
      const int ld = band_ld(idx);
      for (int t0 = s0; t0 < Q16; t0 += 8) {
        const FragA af = load_a(band, ld, 0, t0 - s0, lane);
        FragB cf[4];
#pragma unroll
        for (int w = 0; w < 4; ++w)
          cf[w] = load_b_kn(sm.cs, LDN, t0, n0 + 8 * w, lane);
        mma3_row<4>(acc, af, cf);
      }
      const float d0 = sm.dts[s0 + g], d1 = sm.dts[s0 + g + 8];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        acc[w][0] *= d0;
        acc[w][1] *= d0;
        acc[w][2] *= d1;
        acc[w][3] *= d1;
      }
      if (has_g) {
        // + w_s dt_s (x G)[s][n]
        const float w0 = sm.wq[s0 + g] * d0, w1 = sm.wq[s0 + g + 8] * d1;
        const bool ok0 = s0 + g < q, ok1 = s0 + g + 8 < q;
        const float* x0 = xb + (s0 + g) * a.x_sl;
        const float* x1 = xb + (s0 + g + 8) * a.x_sl;
        for (int kp = 0; kp < PK; ++kp) {
          const int pc = 8 * kp + tq;
          const FragA xa = split_a(
              ok0 && pc < pp ? w0 * x0[pc] : 0.f,
              ok1 && pc < pp ? w1 * x1[pc] : 0.f,
              ok0 && pc + 4 < pp ? w0 * x0[pc + 4] : 0.f,
              ok1 && pc + 4 < pp ? w1 * x1[pc + 4] : 0.f);
          FragB gf[4];
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const int n = n0 + 8 * w + g;
            gf[w] = split_b(pc < pp && n < nn ? gsrc[pc * a.N + n] : 0.f,
                            pc + 4 < pp && n < nn ? gsrc[(pc + 4) * a.N + n]
                                                  : 0.f);
          }
          mma3_row<4>(acc, xa, gf);
        }
      }
#pragma unroll
      for (int w = 0; w < 4; ++w)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = s0 + g + (e >> 1) * 8;
          const int n = n0 + 8 * w + 2 * tq + (e & 1);
          if (s < q && n < nn) a.dbh[(orow + s * a.H) * a.N + n] = acc[w][e];
        }
    }
  }
  __syncthreads();

  // -- c. <S0, G>, dcum, its reverse cumsum, ddt and dA's share ------------
  float sg = 0.f;
  if (has_g && has_s) {
    float v = 0.f;
    for (int e = tid; e < pp * nn; e += THREADS) v += ssrc[e] * gsrc[e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) sm.red[warp] = v;
    __syncthreads();
    for (int w = 0; w < WARPS; ++w) sg += sm.red[w];
  }
  if (warp == 0) {
    const float cum_end = sm.cum[q - 1];
    float vs = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) vs += sm.dts[lane * 4 + e] * sm.t2[lane * 4 + e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      vs += __shfl_xor_sync(0xffffffffu, vs, off);
    float suf[4];
#pragma unroll
    for (int e = 3; e >= 0; --e) {
      const int t = lane * 4 + e;
      float d = 0.f;
      if (t < q) {
        float rw = 0.f;
        for (int j = 0; j <= t / 16; ++j) rw += sm.roww[j][t];
        d = rw - sm.colw[t] + (sm.t5[0][t] + sm.t5[1][t]) -
            sm.dts[t] * sm.t2[t];
        if (t == q - 1) d += vs + expf(cum_end) * sg;
      }
      suf[e] = e < 3 ? d + suf[e + 1] : d;
    }
    const float tot = suf[0];
    float incl = tot;   // sum over this lane and the lanes after it
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += up;
    }
    // the lanes after this one: the next lane's sum, 0 past the last
    float after = __shfl_down_sync(0xffffffffu, incl, 1);
    if (lane == 31) after = 0.f;
    float da = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = lane * 4 + e;
      const float dda = suf[e] + after;   // d(dt A)_t
      if (t < q) {
        a.ddt[orow + t * a.H] = sm.ddtd[t] + sm.t2[t] + av * dda;
        da += sm.dts[t] * dda;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      da += __shfl_xor_sync(0xffffffffu, da, off);
    if (lane == 0) a.dapart[bc * a.H + h] = da;
  }
}

// -- kernel 1, the state pass ---------------------------------------------

constexpr int STATE_THREADS = 256;
constexpr int LDS = MAXN + 1;   // rows of 128-wide tiles (Q x n, p x n)
constexpr int LDY = MAXP + 1;   // rows of Q x p tiles

struct StateSmem {
  float gs[MAXP * LDS];    // G
  float cs[MAXQ * LDS];    // C of the chunk
  float ys[MAXQ * LDY];    // exp(cum_t) dy of the chunk
  float dts[MAXQ], cum[MAXQ], ecum[MAXQ];
};

// dst[r * ld + k] = src[r * rs + k] (times rscale[r] if given) for r < rows
// and k < cols, zero elsewhere in rows < RR and columns < CC.
template <int CC>
__device__ __forceinline__ void stage(float* dst, int ld, int RR,
                                     const float* src, int64_t rs, int rows,
                                     int cols, const float* rscale) {
  for (int e = threadIdx.x; e < RR * CC; e += STATE_THREADS) {
    const int r = e / CC, k = e % CC;
    float v = 0.f;
    if (r < rows && k < cols) {
      v = src[r * rs + k];
      if (rscale != nullptr) v *= rscale[r];
    }
    dst[r * ld + k] = v;
  }
}

// acc[i][j] += sum_{k < kn} A[(ty + 16 i) ar + k ak] Bm[(tx + 16 j) bc + k bk]
template <int RI, int CJ>
__device__ __forceinline__ void mm(float (&acc)[RI][CJ], const float* A,
                                   int ar, int ak, const float* Bm, int bc,
                                   int bk, int kn, int ty, int tx) {
#pragma unroll 2
  for (int k = 0; k < kn; ++k) {
    float a[RI], bv[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = A[(ty + 16 * i) * ar + k * ak];
#pragma unroll
    for (int j = 0; j < CJ; ++j) bv[j] = Bm[(tx + 16 * j) * bc + k * bk];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

// cum (inclusive scan of dt * a over the chunk, cum_end past it) and
// exp(cum_t), by warp 0; dts holds dt, zero past q.
__device__ __forceinline__ void chunk_cum(const float* dts, float* cum,
                                          float* ecum, float a, int q) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 32) return;
  float v[4], run = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    run += dts[lane * 4 + e] * a;
    v[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  const float excl = incl - run;
  const float cum_end = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int s = lane * 4 + e;
    cum[s] = s < q ? excl + v[e] : cum_end;
    ecum[s] = s < q ? expf(excl + v[e]) : 0.f;
  }
}

// Kernel 1: one block per (head, batch), the chunks last to first.
__global__ void __launch_bounds__(STATE_THREADS, 1) ssd_bwd_state_kernel(
    const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ Cm, const float* __restrict__ dy,
    const float* __restrict__ dfinal, float* __restrict__ gbuf,
    float* __restrict__ dinit, int64_t L, int64_t H, int64_t P, int64_t G,
    int64_t N, int64_t Q, int64_t dt_sb, int64_t dt_sl, int64_t c_sb,
    int64_t c_sl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StateSmem& sm = *reinterpret_cast<StateSmem*>(smem_raw);
  const int64_t h = blockIdx.x, b = blockIdx.y, NC = L / Q;
  const int64_t grp = h / (H / G);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q = static_cast<int>(Q), nn = static_cast<int>(N);
  const int pp = static_cast<int>(P);
  const float av = A[h];
  stage<MAXN>(sm.gs, LDS, MAXP,
              dfinal != nullptr ? dfinal + (b * H + h) * P * N : nullptr, N,
              dfinal != nullptr ? pp : 0, nn, nullptr);
  for (int64_t ci = NC - 1; ci >= 0; --ci) {
    const int64_t c0 = ci * Q;
    __syncthreads();   // G of this chunk is in gs
    float* gdst = gbuf + ((b * NC + ci) * H + h) * P * N;
    for (int e = tid; e < pp * nn; e += STATE_THREADS)
      gdst[(e / nn) * N + e % nn] = sm.gs[(e / nn) * LDS + e % nn];
    for (int s = tid; s < MAXQ; s += STATE_THREADS)
      sm.dts[s] = s < q ? dt[b * dt_sb + (c0 + s) * dt_sl + h] : 0.f;
    stage<MAXN>(sm.cs, LDS, MAXQ, Cm + b * c_sb + c0 * c_sl + grp * N, c_sl,
                q, nn, nullptr);
    __syncthreads();
    chunk_cum(sm.dts, sm.cum, sm.ecum, av, q);
    __syncthreads();
    stage<MAXP>(sm.ys, LDY, MAXQ, dy + ((b * L + c0) * H + h) * P, H * P, q,
                pp, sm.ecum);
    __syncthreads();
    // G <- exp(cum_end) G + sum_t (exp(cum_t) dy_t) C_t^T
    const float keep = expf(sm.cum[q - 1]);
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j] = keep * sm.gs[(ty + 16 * i) * LDS + tx + 16 * j];
    mm<4, 8>(acc, sm.ys, 1, LDY, sm.cs, 1, LDS, q, ty, tx);
    __syncthreads();   // every read of gs is done
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sm.gs[(ty + 16 * i) * LDS + tx + 16 * j] = acc[i][j];
  }
  __syncthreads();
  if (dinit != nullptr)
    for (int e = tid; e < pp * nn; e += STATE_THREADS)
      dinit[((b * H + h) * P + e / nn) * N + e % nn] =
          sm.gs[(e / nn) * LDS + e % nn];
}

// Kernel 3: dB, dC of each group (its heads in order) and dA (batch and
// chunks in order). A thread sums V consecutive n (a float4 where n is a
// multiple of 4), its loads for four heads issued before their adds.
__device__ __forceinline__ void acc4(float& s, float v) { s += v; }
__device__ __forceinline__ void acc4(float4& s, float4 v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

template <typename T>
__global__ void ssd_bwd_sum_kernel(const T* __restrict__ dbh,
                                   const T* __restrict__ dch,
                                   const float* __restrict__ dapart,
                                   T* __restrict__ dB, T* __restrict__ dC,
                                   float* __restrict__ dA, int64_t rows,
                                   int64_t H, int64_t G, int64_t NV,
                                   int64_t n_part) {
  asm volatile("griddepcontrol.wait;" ::: "memory");   // kernel 2's sums
  const int64_t total = rows * G * NV, rep = H / G;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e < total) {
    const int64_t k = e % NV, gr = (e / NV) % G, r = e / (NV * G);
    const int64_t base = (r * H + gr * rep) * NV + k;
    T sb = {}, sc = {};
    int64_t u = 0;
    for (; u + 4 <= rep; u += 4) {
      T vb[4], vc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        vb[i] = dbh[base + (u + i) * NV];
        vc[i] = dch[base + (u + i) * NV];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc4(sb, vb[i]);
        acc4(sc, vc[i]);
      }
    }
    for (; u < rep; ++u) {
      acc4(sb, dbh[base + u * NV]);
      acc4(sc, dch[base + u * NV]);
    }
    dB[e] = sb;
    dC[e] = sc;
  }
  if (blockIdx.x == 0)
    for (int64_t hh = threadIdx.x; hh < H; hh += blockDim.x) {
      float s = 0.f;
      for (int64_t u = 0; u < n_part; ++u) s += dapart[u * H + hh];
      dA[hh] = s;
    }
}

cudaError_t allow_smem(const void* fn, int bytes) {
  // The shared-memory limit is a per-device attribute: set it once on each
  // device a launch reaches.
  constexpr int MAX_DEVICES = 64;
  static bool configured[3][MAX_DEVICES] = {};
  const int which =
      fn == reinterpret_cast<const void*>(ssd_bwd_chunk_kernel)  ? 0
      : fn == reinterpret_cast<const void*>(ssd_bwd_cb_kernel) ? 1
                                                                : 2;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < MAX_DEVICES && configured[which][device]) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && device < MAX_DEVICES)
    configured[which][device] = true;
  return err;
}

}  // namespace

// dfinal, states, dinit may be null (no final-state gradient, start states
// all zero but for init, no initial state). gbuf: (batch, L / Q, H, P, N)
// scratch, used when the state pass runs (more than one chunk, a dfinal or
// a dinit). cbuf: (batch * L / Q * G, S16, 2 S16, 32, 4) scratch, S16 =
// ceil(Q / 16); dbh, dch: (batch, L, H, N) scratch; dapart: (batch * L / Q,
// H).
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* dy, const void* dfinal, const void* states,
    void* gbuf, void* cbuf, void* dbh, void* dch, void* dapart, void* dx,
    void* ddt,
    void* dA, void* dB, void* dC, void* dinit, int64_t batch, int64_t L,
    int64_t H, int64_t P, int64_t G, int64_t N, int64_t Q, int64_t has_init,
    int64_t x_sb, int64_t x_sl, int64_t dt_sb, int64_t dt_sl, int64_t b_sb,
    int64_t b_sl, int64_t c_sb, int64_t c_sl, void* stream) {
  if (Q <= 0 || Q > MAXQ || N <= 0 || N > MAXN || P <= 0 || P > MAXP ||
      L <= 0 || L % Q != 0 || G <= 0 || H % G != 0 || H > 65535 ||
      batch * (L / Q) * G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t NC = L / Q;
  const bool state_pass = NC > 1 || dfinal != nullptr || dinit != nullptr;
  cudaError_t err;
  if (state_pass) {
    err = allow_smem(reinterpret_cast<const void*>(ssd_bwd_state_kernel),
                     sizeof(StateSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_bwd_state_kernel<<<dim3(static_cast<unsigned>(H),
                                static_cast<unsigned>(batch)),
                           STATE_THREADS, sizeof(StateSmem), s>>>(
        static_cast<const float*>(dt), static_cast<const float*>(A),
        static_cast<const float*>(Cm), static_cast<const float*>(dy),
        static_cast<const float*>(dfinal), static_cast<float*>(gbuf),
        static_cast<float*>(dinit), L, H, P, G, N, Q, dt_sb, dt_sl, c_sb,
        c_sl);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = allow_smem(reinterpret_cast<const void*>(ssd_bwd_chunk_kernel),
                   sizeof(ChunkSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.x = static_cast<const float*>(x);
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.Bm = static_cast<const float*>(Bm);
  a.Cm = static_cast<const float*>(Cm);
  a.dy = static_cast<const float*>(dy);
  a.states = static_cast<const float*>(states);
  a.gbuf = state_pass ? static_cast<const float*>(gbuf) : nullptr;
  a.dx = static_cast<float*>(dx);
  a.ddt = static_cast<float*>(ddt);
  a.dbh = static_cast<float*>(dbh);
  a.dch = static_cast<float*>(dch);
  a.dapart = static_cast<float*>(dapart);
  a.L = L; a.H = H; a.P = P; a.G = G; a.N = N; a.Q = Q; a.NC = NC;
  a.x_sb = x_sb; a.x_sl = x_sl; a.dt_sb = dt_sb; a.dt_sl = dt_sl;
  a.b_sb = b_sb; a.b_sl = b_sl; a.c_sb = c_sb; a.c_sl = c_sl;
  a.has_init = static_cast<int>(has_init);
  a.g_last_zero = dfinal == nullptr;
  // 16-byte copies where every staged row starts on a 16-byte boundary
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  a.vec_b = aligned(Bm) && N % 4 == 0 && b_sb % 4 == 0 && b_sl % 4 == 0;
  a.vec_c = aligned(Cm) && N % 4 == 0 && c_sb % 4 == 0 && c_sl % 4 == 0;
  a.vec_y = aligned(dy) && P % 4 == 0;
  a.cbuf = static_cast<const float4*>(cbuf);
  const int64_t S16 = (Q + 15) / 16;
  err = allow_smem(reinterpret_cast<const void*>(ssd_bwd_cb_kernel),
                   sizeof(CbSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_cb_kernel<<<dim3(static_cast<unsigned>(S16),
                           static_cast<unsigned>(batch * NC * G)),
                      CB_THREADS, sizeof(CbSmem), s>>>(
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<float4*>(cbuf), G, N, Q, NC, b_sb, b_sl, c_sb, c_sl,
      a.vec_b, a.vec_c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  {
    // kernel 2a's programmatic dependent: its staging and M overlap 2a
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(H),
                       static_cast<unsigned>(batch * NC));
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = sizeof(ChunkSmem);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, ssd_bwd_chunk_kernel, a);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // float4 where every row of the scratch and the outputs is 16-byte
  // aligned (all five are dense)
  const bool vec = N % 4 == 0 && aligned(dbh) && aligned(dch) &&
                   aligned(dB) && aligned(dC);
  const int64_t nv = vec ? N / 4 : N;
  const int64_t blocks = (batch * L * G * nv + 255) / 256;
  // the chunk kernel's programmatic dependent: launched while its second
  // wave runs, on the SMs the wave leaves idle
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(256);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (vec)
    err = cudaLaunchKernelEx(
        &cfg, ssd_bwd_sum_kernel<float4>, static_cast<const float4*>(dbh),
        static_cast<const float4*>(dch), static_cast<const float*>(dapart),
        static_cast<float4*>(dB), static_cast<float4*>(dC),
        static_cast<float*>(dA), batch * L, H, G, nv, batch * NC);
  else
    err = cudaLaunchKernelEx(
        &cfg, ssd_bwd_sum_kernel<float>, static_cast<const float*>(dbh),
        static_cast<const float*>(dch), static_cast<const float*>(dapart),
        static_cast<float*>(dB), static_cast<float*>(dC),
        static_cast<float*>(dA), batch * L, H, G, nv, batch * NC);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
