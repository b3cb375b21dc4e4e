// The chunked SSD scan's backward (Mamba-2), fp32: given dy and the final
// state's gradient (or none), the gradients of x, dt, A, B, C and of the
// initial state. Per (batch, chunk, head h in group g), with cum the
// within-chunk cumulative sum of dt * A, S0 the chunk's start state, G the
// gradient reaching its end state, L_ts = exp(cum_t - cum_s) for s <= t
// (else 0), K = (C B^T) o L, dP = dy x^T, w_s = exp(cum_end - cum_s) dt_s:
//   dx_s  = sum_t K_ts dt_s dy_t + w_s G B_s
//   dC_t  = sum_s dP_ts L_ts dt_s B_s + exp(cum_t) S0^T dy_t
//   dB_s  = dt_s sum_t dP_ts L_ts C_t + w_s G^T x_s
//   ddt_s = sum_t K_ts dP_ts + exp(cum_end - cum_s) x_s . G B_s
//           + A_h sum_{u >= s} dcum_u
//   dcum_t = sum_s W_ts - sum_s W_st + exp(cum_t) dy_t . S0 C_t - V_t
//            (+ sum_s V_s + exp(cum_end) <S0, G> at the chunk's last step),
//   W = K o dt_s o dP, V_s = dt_s exp(cum_end - cum_s) x_s . G B_s;
// dA_h sums dt_u sum_{t >= u} dcum_t over batch, chunks and steps; G of
// the chunk before is exp(cum_end) G + sum_t exp(cum_t) dy_t C_t^T, and the
// first chunk's is the initial state's gradient. The plain version is
// kernels/ref.py:ssd_scan_bwd_ref, written step by step as here.
//
// Replaces: the TPU kernel src/repro/kernels/ssd_scan.py:ssd_scan_pallas
// has no backward; the JAX package differentiates its plain jnp scan
// (src/repro/arch/ssm.py:50) when it trains Mamba2.
//
// Bound on the H100: at the trainer's shape (x (8, 128, 24, 64), B and C
// (8, 128, 1, 128), one chunk of 128, no initial state and no final-state
// gradient) the products over the causal pairs need about 1.7 GFLOP,
// 10 us at the 165 TFLOP/s of fp32 products as 3xTF32 on the tensor
// cores, against about 6.3 us for the bytes (chip_smoke.py phase 9 (e)
// logs the count). This kernel runs every product as fp32 FMA on the CUDA
// cores (67 TFLOP/s) over whole tiles, triangles included: a simple
// kernel that is right first.
//
// Design: three kernels, launched in order on one stream.
//   1. The state pass (only where some chunk has a G or the initial state
//      wants a gradient: more than one chunk, a final-state gradient or an
//      initial state): one block per (batch, head) walks the chunks last to
//      first with G (p x n) in shared memory, writes each chunk's G for
//      kernel 2 and, after the first chunk, the initial state's gradient.
//   2. The chunk kernel: one block per (role, head, batch x chunk), three
//      roles that each recompute the products they need rather than keep
//      four 128 x 128 tiles in shared memory at once: role 0 forms K and
//      dP, their masked row and column sums (ddt, dcum) and dx = (K o
//      dt)^T dy, then the state terms (G B^T, S0 C^T), the reverse cumsum
//      of dcum, ddt and the block's share of dA; role 1 forms dP o L o dt
//      and dC = (dP o L o dt) B (+ exp(cum_t) dy S0); role 2 forms dP o L
//      and dB = dt o (dP o L)^T C (+ w_s x G). Each block's 256 threads own
//      8 x 8 (or 8 x 4) output tiles strided by 16, read from shared memory
//      whose rows are padded to an odd length (no bank conflicts). e^(cum_t
//      - cum_s) is formed only where s <= t (above the diagonal the
//      exponent is positive and can overflow). Every sum runs in a fixed
//      order: lanes by shuffle, then warps' partials in order.
//   3. The group sums: dB and dC of group g add its heads' partials in
//      ascending head order, and dA adds the blocks' shares over batch and
//      chunks in order. No floating-point atomics anywhere: two runs are
//      bit-equal.
// x, B and C are read through their batch and length strides, as the
// forward reads them (views of the packed projection); dy, dfinal and the
// saved states are dense; the gradients are written dense.
//
// C interface: launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

namespace {

constexpr int MAXQ = 128;   // largest chunk
constexpr int MAXN = 128;   // largest state size n
constexpr int MAXP = 64;    // largest head dim p
constexpr int THREADS = 256;
constexpr int LDN = MAXN + 1;   // rows of 128-wide tiles (Q x Q, Q x n, p x n)
constexpr int LDP = MAXP + 1;   // rows of Q x p tiles
static_assert(MAXQ == MAXN, "Q x Q tiles share the Q x n regions");
static_assert(MAXQ == 4 * 32, "the cum scan gives each lane four steps");
static_assert(THREADS == 256, "a 16 x 16 grid of threads owns each tile");

struct ChunkSmem {
  float r0[MAXQ * LDN];    // C, K, G, dP products, S0
  float r1[MAXQ * LDN];    // B, C, S0
  float xs[MAXQ * LDP];    // x of the chunk
  float ys[MAXQ * LDP];    // dy of the chunk
  float colp[2][16][MAXQ];  // column partials by thread row
  float dts[MAXQ], cum[MAXQ], ecum[MAXQ], wq[MAXQ];
  float roww[MAXQ], colw[MAXQ], ddtd[MAXQ], t2[MAXQ], t5[MAXQ];
  float red[THREADS / 32];
};

struct StateSmem {
  float gs[MAXP * LDN];    // G
  float cs[MAXQ * LDN];    // C of the chunk
  float ys[MAXQ * LDP];    // exp(cum_t) dy of the chunk
  float dts[MAXQ], cum[MAXQ], ecum[MAXQ];
};

// dst[r * ld + k] = src[r * rs + k] (times rscale[r] if given) for r < rows
// and k < cols, zero elsewhere in rows < RR and columns < CC.
template <int CC>
__device__ __forceinline__ void stage(float* dst, int ld, int RR,
                                     const float* src, int64_t rs, int rows,
                                     int cols, const float* rscale) {
  for (int e = threadIdx.x; e < RR * CC; e += THREADS) {
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

template <int RI, int CJ>
__device__ __forceinline__ void zero(float (&acc)[RI][CJ]) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
}

// Sum over the 16 lanes of a thread row (tx = 0..15), in a fixed order.
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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

struct Args {
  const float *x, *dt, *A, *Bm, *Cm, *dy, *states, *gbuf;
  float *dx, *ddt, *dbh, *dch, *dapart;
  int64_t L, H, P, G, N, Q, NC;
  int64_t x_sb, x_sl, dt_sb, dt_sl, b_sb, b_sl, c_sb, c_sl;
  int has_init, g_last_zero;
};

// Kernel 2: one block per (role, head, batch x chunk).
__global__ void __launch_bounds__(THREADS, 1)
    ssd_bwd_chunk_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(smem_raw);
  const int role = blockIdx.x;
  const int64_t h = blockIdx.y, bc = blockIdx.z;
  const int64_t b = bc / a.NC, ci = bc % a.NC, c0 = ci * a.Q;
  const int64_t grp = h / (a.H / a.G);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q = static_cast<int>(a.Q), nn = static_cast<int>(a.N);
  const int pp = static_cast<int>(a.P);
  const float av = a.A[h];
  const float* xb = a.x + b * a.x_sb + c0 * a.x_sl + h * a.P;
  const float* yb = a.dy + ((b * a.L + c0) * a.H + h) * a.P;
  const float* bb = a.Bm + b * a.b_sb + c0 * a.b_sl + grp * a.N;
  const float* cb = a.Cm + b * a.c_sb + c0 * a.c_sl + grp * a.N;
  const float* dtb = a.dt + b * a.dt_sb + c0 * a.dt_sl + h;
  const int64_t slot = (bc * a.H + h) * a.P * a.N;   // (b, c, h) p x n
  const bool has_g = a.gbuf != nullptr && !(a.g_last_zero && ci == a.NC - 1);
  const bool has_s = a.states != nullptr && !(ci == 0 && !a.has_init);
  const float* gsrc = has_g ? a.gbuf + slot : nullptr;
  const float* ssrc = has_s ? a.states + slot : nullptr;

  // -- dt, cum, x, dy, and the role's B or C ------------------------------
  for (int s = tid; s < MAXQ; s += THREADS)
    sm.dts[s] = s < q ? dtb[s * a.dt_sl] : 0.f;
  stage<MAXP>(sm.xs, LDP, MAXQ, xb, a.x_sl, q, pp, nullptr);
  stage<MAXP>(sm.ys, LDP, MAXQ, yb, a.H * a.P, q, pp, nullptr);
  // r1: B for roles 0 (C B^T) and 1 (dC), C for role 2 (dB); r0: C for 0
  stage<MAXN>(sm.r1, LDN, MAXQ, role == 2 ? cb : bb,
              role == 2 ? a.c_sl : a.b_sl, q, nn, nullptr);
  if (role == 0) stage<MAXN>(sm.r0, LDN, MAXQ, cb, a.c_sl, q, nn, nullptr);
  __syncthreads();
  chunk_cum(sm.dts, sm.cum, sm.ecum, av, q);
  __syncthreads();
  const float cum_end = sm.cum[q - 1];
  for (int s = tid; s < MAXQ; s += THREADS)
    sm.wq[s] = s < q ? expf(cum_end - sm.cum[s]) : 0.f;

  // -- dP = dy x^T over the block's 8 x 8 tile -------------------------------
  float dp[8][8];
  zero(dp);
  mm<8, 8>(dp, sm.ys, LDP, 1, sm.xs, LDP, 1, pp, ty, tx);

  if (role == 0) {
    // K = (C B^T) o L on the same tile
    float kt[8][8];
    zero(kt);
    mm<8, 8>(kt, sm.r0, LDN, 1, sm.r1, LDN, 1, nn, ty, tx);
    float rw[8], cw[8], cd[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) rw[i] = cw[i] = cd[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s = tx + 16 * j;
        const bool in = s <= t && t < q;
        const float k = in ? kt[i][j] * expf(sm.cum[t] - sm.cum[s]) : 0.f;
        kt[i][j] = k;
        const float kd = k * dp[i][j];
        const float w = kd * sm.dts[s];
        rw[i] += w;
        cw[j] += w;
        cd[j] += kd;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float r = row_sum(rw[i]);
      if (tx == 0) sm.roww[ty + 16 * i] = r;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sm.colp[0][ty][tx + 16 * j] = cw[j];
      sm.colp[1][ty][tx + 16 * j] = cd[j];
    }
    __syncthreads();   // every read of C (r0) is done
    for (int s = tid; s < MAXQ; s += THREADS) {
      float w = 0.f, d = 0.f;
      for (int r = 0; r < 16; ++r) {
        w += sm.colp[0][r][s];
        d += sm.colp[1][r][s];
      }
      sm.colw[s] = w;
      sm.ddtd[s] = d;
      sm.t2[s] = 0.f;
      sm.t5[s] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sm.r0[(ty + 16 * i) * LDN + tx + 16 * j] =
            kt[i][j] * sm.dts[tx + 16 * j];
    __syncthreads();
    // dx[s][p] = sum_t M[t][s] dy[t][p]
    float dxa[8][4];
    zero(dxa);
    mm<8, 4>(dxa, sm.r0, 1, LDN, sm.ys, 1, LDP, q, ty, tx);
    float sg = 0.f;   // <S0, G>, thread 0's
    if (has_g) {
      __syncthreads();   // every read of M is done
      stage<MAXN>(sm.r0, LDN, MAXP, gsrc, a.N, pp, nn, nullptr);
      __syncthreads();
      float gb[8][4];   // (G B_s)[p]
      zero(gb);
      mm<8, 4>(gb, sm.r1, LDN, 1, sm.r0, LDN, 1, nn, ty, tx);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int s = ty + 16 * i;
        const float w = sm.wq[s] * sm.dts[s];
        float xg = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dxa[i][j] += w * gb[i][j];
          xg += sm.xs[s * LDP + tx + 16 * j] * gb[i][j];
        }
        xg = row_sum(xg);
        if (tx == 0) sm.t2[s] = sm.wq[s] * xg;
      }
    }
    if (has_s) {
      __syncthreads();   // every read of B is done
      stage<MAXN>(sm.r1, LDN, MAXP, ssrc, a.N, pp, nn, nullptr);
      __syncthreads();
      if (has_g) {
        float v = 0.f;
        for (int e = tid; e < MAXP * MAXN; e += THREADS) {
          const int r = e / MAXN, k = e % MAXN;
          v += sm.r1[r * LDN + k] * sm.r0[r * LDN + k];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if ((tid & 31) == 0) sm.red[tid >> 5] = v;
      }
      __syncthreads();   // every read of G is done
      stage<MAXN>(sm.r0, LDN, MAXQ, cb, a.c_sl, q, nn, nullptr);
      __syncthreads();
      float sc[8][4];   // (S0 C_t)[p]
      zero(sc);
      mm<8, 4>(sc, sm.r0, LDN, 1, sm.r1, LDN, 1, nn, ty, tx);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = ty + 16 * i;
        float ys = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) ys += sm.ys[t * LDP + tx + 16 * j] * sc[i][j];
        ys = row_sum(ys);
        if (tx == 0) sm.t5[t] = sm.ecum[t] * ys;
      }
      if (has_g && tid == 0)
        for (int w = 0; w < THREADS / 32; ++w) sg += sm.red[w];
    }
    __syncthreads();
    // dcum, its reverse cumsum, ddt and dA's share: thread 0, in order
    if (tid == 0) {
      float vsum = 0.f;
      for (int s = 0; s < q; ++s) vsum += sm.dts[s] * sm.t2[s];
      float run = 0.f, da = 0.f;
      for (int t = q - 1; t >= 0; --t) {
        float d = sm.roww[t] - sm.colw[t] + sm.t5[t] - sm.dts[t] * sm.t2[t];
        if (t == q - 1) d += vsum + expf(cum_end) * sg;
        run += d;
        sm.colw[t] = run;   // d(dt A)_t
        da += sm.dts[t] * run;
      }
      a.dapart[bc * a.H + h] = da;
    }
    __syncthreads();
    for (int s = tid; s < q; s += THREADS)
      a.ddt[((b * a.L + c0 + s) * a.H + h)] =
          sm.ddtd[s] + sm.t2[s] + av * sm.colw[s];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = ty + 16 * i;
      if (s >= q) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        if (p < pp) a.dx[((b * a.L + c0 + s) * a.H + h) * a.P + p] = dxa[i][j];
      }
    }
    return;
  }

  // -- roles 1 and 2: dP o L (o dt for dC) into r0 ---------------------------
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int s = tx + 16 * j;
      float v = 0.f;
      if (s <= t && t < q) {
        v = dp[i][j] * expf(sm.cum[t] - sm.cum[s]);
        if (role == 1) v *= sm.dts[s];
      }
      sm.r0[t * LDN + s] = v;
    }
  }
  __syncthreads();
  float acc[8][8];
  zero(acc);
  float* out;
  if (role == 1) {
    // dC[t][k] = sum_s (dP o L o dt)[t][s] B[s][k]
    mm<8, 8>(acc, sm.r0, LDN, 1, sm.r1, 1, LDN, q, ty, tx);
    if (has_s) {
      __syncthreads();   // every read of r0 is done
      stage<MAXN>(sm.r0, LDN, MAXP, ssrc, a.N, pp, nn, nullptr);
      for (int e = tid; e < MAXQ * MAXP; e += THREADS)
        sm.ys[(e / MAXP) * LDP + e % MAXP] *= sm.ecum[e / MAXP];
      __syncthreads();
      // += exp(cum_t) (dy S0)[t][k]
      mm<8, 8>(acc, sm.ys, LDP, 1, sm.r0, 1, LDN, pp, ty, tx);
    }
    out = a.dch;
  } else {
    // dB[s][k] = dt_s sum_t (dP o L)[t][s] C[t][k]
    mm<8, 8>(acc, sm.r0, 1, LDN, sm.r1, 1, LDN, q, ty, tx);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= sm.dts[ty + 16 * i];
    if (has_g) {
      __syncthreads();
      stage<MAXN>(sm.r0, LDN, MAXP, gsrc, a.N, pp, nn, nullptr);
      for (int e = tid; e < MAXQ * MAXP; e += THREADS) {
        const int s = e / MAXP;
        sm.xs[s * LDP + e % MAXP] *= sm.wq[s] * sm.dts[s];
      }
      __syncthreads();
      // += w_s (x G)[s][k]
      mm<8, 8>(acc, sm.xs, LDP, 1, sm.r0, 1, LDN, pp, ty, tx);
    }
    out = a.dbh;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 16 * i;
    if (r >= q) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = tx + 16 * j;
      if (k < nn) out[((b * a.L + c0 + r) * a.H + h) * a.N + k] = acc[i][j];
    }
  }
}

// Kernel 1: one block per (head, batch), the chunks last to first.
__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_state_kernel(
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
  stage<MAXN>(sm.gs, LDN, MAXP,
              dfinal != nullptr ? dfinal + (b * H + h) * P * N : nullptr, N,
              dfinal != nullptr ? pp : 0, nn, nullptr);
  for (int64_t ci = NC - 1; ci >= 0; --ci) {
    const int64_t c0 = ci * Q;
    __syncthreads();   // G of this chunk is in gs
    float* gdst = gbuf + ((b * NC + ci) * H + h) * P * N;
    for (int e = tid; e < pp * nn; e += THREADS)
      gdst[(e / nn) * N + e % nn] = sm.gs[(e / nn) * LDN + e % nn];
    for (int s = tid; s < MAXQ; s += THREADS)
      sm.dts[s] = s < q ? dt[b * dt_sb + (c0 + s) * dt_sl + h] : 0.f;
    stage<MAXN>(sm.cs, LDN, MAXQ, Cm + b * c_sb + c0 * c_sl + grp * N, c_sl,
                q, nn, nullptr);
    __syncthreads();
    chunk_cum(sm.dts, sm.cum, sm.ecum, av, q);
    __syncthreads();
    stage<MAXP>(sm.ys, LDP, MAXQ, dy + ((b * L + c0) * H + h) * P, H * P, q,
                pp, sm.ecum);
    __syncthreads();
    // G <- exp(cum_end) G + sum_t (exp(cum_t) dy_t) C_t^T
    const float keep = expf(sm.cum[q - 1]);
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j] = keep * sm.gs[(ty + 16 * i) * LDN + tx + 16 * j];
    mm<4, 8>(acc, sm.ys, 1, LDP, sm.cs, 1, LDN, q, ty, tx);
    __syncthreads();   // every read of gs is done
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sm.gs[(ty + 16 * i) * LDN + tx + 16 * j] = acc[i][j];
  }
  __syncthreads();
  if (dinit != nullptr)
    for (int e = tid; e < pp * nn; e += THREADS)
      dinit[((b * H + h) * P + e / nn) * N + e % nn] =
          sm.gs[(e / nn) * LDN + e % nn];
}

// Kernel 3: dB, dC of each group (its heads in order) and dA (batch and
// chunks in order).
__global__ void ssd_bwd_sum_kernel(const float* __restrict__ dbh,
                                   const float* __restrict__ dch,
                                   const float* __restrict__ dapart,
                                   float* __restrict__ dB,
                                   float* __restrict__ dC,
                                   float* __restrict__ dA, int64_t rows,
                                   int64_t H, int64_t G, int64_t N,
                                   int64_t n_part) {
  const int64_t total = rows * G * N, rep = H / G;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e < total) {
    const int64_t k = e % N, gr = (e / N) % G, r = e / (N * G);
    const int64_t base = (r * H + gr * rep) * N + k;
    float sb = 0.f, sc = 0.f;
    for (int64_t u = 0; u < rep; ++u) {
      sb += dbh[base + u * N];
      sc += dch[base + u * N];
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
  static bool configured[2][MAX_DEVICES] = {};
  const int which = fn == reinterpret_cast<const void*>(ssd_bwd_chunk_kernel)
                        ? 0 : 1;
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
// a dinit). dbh, dch: (batch, L, H, N) scratch; dapart: (batch * L / Q, H).
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* dy, const void* dfinal, const void* states,
    void* gbuf, void* dbh, void* dch, void* dapart, void* dx, void* ddt,
    void* dA, void* dB, void* dC, void* dinit, int64_t batch, int64_t L,
    int64_t H, int64_t P, int64_t G, int64_t N, int64_t Q, int64_t has_init,
    int64_t x_sb, int64_t x_sl, int64_t dt_sb, int64_t dt_sl, int64_t b_sb,
    int64_t b_sl, int64_t c_sb, int64_t c_sl, void* stream) {
  if (Q <= 0 || Q > MAXQ || N <= 0 || N > MAXN || P <= 0 || P > MAXP ||
      L <= 0 || L % Q != 0 || G <= 0 || H % G != 0 || H > 65535 ||
      batch * (L / Q) > 65535)
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
                           THREADS, sizeof(StateSmem), s>>>(
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
  ssd_bwd_chunk_kernel<<<dim3(3, static_cast<unsigned>(H),
                              static_cast<unsigned>(batch * NC)),
                         THREADS, sizeof(ChunkSmem), s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = batch * L * G * N;
  const int64_t blocks = (total + 255) / 256;
  ssd_bwd_sum_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      static_cast<const float*>(dbh), static_cast<const float*>(dch),
      static_cast<const float*>(dapart), static_cast<float*>(dB),
      static_cast<float*>(dC), static_cast<float*>(dA), batch * L, H, G, N,
      batch * NC);
  return static_cast<int>(cudaGetLastError());
}
