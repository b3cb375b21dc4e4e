// Chunked SSD scan (Mamba-2) on bf16 x, dt, B and C (A fp32): the
// function of csrc/ssd_scan.cu, with y in bf16 and the state, the final
// state and the chunks' start states in fp32. Per head, with the state S
// (p, n) starting at the given fp32 initial state (or zero) and cum the
// within-chunk cumulative sum of dt * A (fp32):
//   y[t]   = sum_{s <= t in chunk} (C_t . B_s) L_ts dt_s x_s + e_t S' C_t
//   S     <- S exp(cum_end) + sum_s x_s (dt_s w_s B_s)^T
// with L_ts = exp(cum_t - cum_s), w_s = exp(cum_end - cum_s) and
// e_t = exp(cum_t) each rounded to bf16, and S' the state rounded to bf16,
// where the reference rounds them (src/repro/arch/ssm.py:77-107: `L`,
// `decay_to_end`, `state_decay`, `prev_states.astype(wdt)`; the port's
// plain version, kernels/ref.py:ssd_scan_ref, rounds alike). The chunk
// decay exp(cum_end) stays fp32, as there.
//
// Where this kernel rounds otherwise than the reference, it keeps more:
// C B^T stays fp32 before it is multiplied by L (the reference rounds the
// einsum's output, then the product); the diagonal block's weights
// (C B^T) o L o dt are rounded to bf16 once, as the A operand of their
// product with x, where the reference's three-operand einsum rounds where
// its contraction order puts an intermediate; the products accumulate in
// fp32 and y_diag + y_off is rounded once, where the reference rounds each
// einsum's output; dt_s w_s B_s is rounded once as an operand; and a
// chunk's contribution is added to the fp32 state as it accumulates, where
// the reference rounds it (`states`) to bf16 first. A bf16 operand of a
// tensor-core step has to be rounded; nothing else is.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:ssd_scan_pallas
// in bf16 (the reference's model scans in plain jnp in the model's dtype,
// src/repro/arch/ssm.py:50).
//
// Bound on the H100: at the path's shapes (Mamba2-130m prefill: 24 heads,
// p = 64, n = 128, one group, l = 256, b = 3) the fewest FLOPs, 0.654
// GFLOP (kernels/costs.py:ssd_flops), take 0.66 us at the 989 TFLOP/s of
// bf16 on the tensor cores, and its bytes (x, y, dt, B, C in bf16; the
// final state in fp32) about 7.6 MB, 2.3 us at 3.35 TB/s: bytes.
//
// Design: the fp32 kernel's, with bf16 m16n8k16 steps (mma_bf16.cuh) in
// place of 3xTF32. One block per (batch, head, 32 rows of p), four warps,
// carrying its 32 x n slice of the fp32 state through a loop over the
// chunks. B and x of a chunk are staged in shared memory by cp.async, 16
// bytes (8 values) a thread, zero past the chunk, n and p (n and p are
// multiples of 8; rows
// padded to an odd number of 16-byte units, so ldmatrix rows and pair
// reads hit distinct banks); dt is read into fp32. A warp takes the 16-row
// tiles w and 7 - w of the chunk and holds their C rows in registers as
// A fragments (bf16 pairs from device memory); for each:
//   1. the scores C B^T for the column tiles on or below the diagonal and
//   3. the carried state C S'^T, in one pass over n (S' read from the fp32
//      state in shared memory and rounded to bf16 as the B operand);
//   2. the diagonal block: each two neighbouring score tiles scaled in
//      fp32 by L_ts dt_s (formed only where s <= t), rounded to bf16 and
//      fed straight back as the A fragment of a 16-step product with x,
//      whose B fragments come from ldmatrix.trans.
//   4. The update: warp w owns the state's column tiles 2w, 2w + 1,
//      2w + 8, 2w + 9; x^T is the A operand (ldmatrix.trans), and B's
//      fragments (ldmatrix.trans) are scaled by dt_s w_s in fp32 and
//      rounded. The fp32 accumulators are seeded from the state times
//      exp(cum_end) and written back.
// About 62 KB of shared memory a block. The group of head h is read as
// h / (heads / groups). TMA and wgmma are left for later work.
//
// C interface: launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "mma_bf16.cuh"
#include "mma_tf32x3.cuh"

namespace {

using bf16 = __nv_bfloat16;
using bf16mma::round_bf16;
using tf32x3::cp_async16;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;
using tf32x3::fast_exp2;

constexpr int MAXQ = 128;   // largest chunk
constexpr int MAXN = 128;   // largest state size n
constexpr int PS = 32;      // rows of p per block
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int LDB = MAXN + 8;   // B rows, in values (17 units of 16 bytes)
constexpr int LDX = PS + 8;     // x rows, in values (5 units)
constexpr int LDS = MAXN + 8;   // state rows, in floats (8 mod 32)
constexpr int KN = MAXN / 16;   // most k-steps over n
constexpr int QT = MAXQ / 8;    // most 8-column score tiles of a chunk
constexpr int PT = PS / 8;      // n-tiles of y over p
constexpr float LOG2E = 1.4426950408889634f;
static_assert(MAXQ == 4 * 32, "the cum scan gives each lane four steps");
static_assert(MAXQ / 16 == 2 * WARPS, "each warp takes two row tiles");
static_assert(MAXN / 8 == 4 * WARPS, "each warp updates four column tiles");

struct Smem {
  bf16 bs[MAXQ][LDB];    // B of the chunk
  bf16 xs[MAXQ][LDX];    // x of the chunk, the block's rows of p
  float st[PS][LDS];     // the block's slice of the state
  float cum[MAXQ];       // cumulative dt * A within the chunk
  float dts[MAXQ];       // dt
  float wdt[MAXQ];       // dt * bf16(exp(cum_end - cum_s))
};

// Two neighbouring fp32 values of shared memory as a bf16 pair.
__device__ __forceinline__ uint32_t pair_bf16(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return bf16mma::pack(v.x, v.y);
}

// A bf16 pair of B rows s and s + 1 (low, high) scaled by w0 and w1 and
// rounded again.
__device__ __forceinline__ uint32_t scaled(uint32_t r, float w0, float w1) {
  return bf16mma::pack(bf16mma::lo_of(r) * w0, bf16mma::hi_of(r) * w1);
}

__global__ void __launch_bounds__(THREADS, 2) ssd_scan_bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dt,
    const float* __restrict__ A, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, const float* __restrict__ init_state,
    bf16* __restrict__ y, float* __restrict__ final_state,
    float* __restrict__ states, int64_t L, int64_t H, int64_t P, int64_t G,
    int64_t N, int64_t Q, int64_t x_sb, int64_t x_sl, int64_t dt_sb,
    int64_t dt_sl, int64_t b_sb, int64_t b_sl, int64_t c_sb, int64_t c_sl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * PS;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t grp = h / (H / G);
  const int pvalid = static_cast<int>(P - p0 < PS ? P - p0 : PS);
  const int nn = static_cast<int>(N), q = static_cast<int>(Q);
  const int NK = (nn + 15) / 16;         // k-steps over n
  const int MT = (q + 15) / 16;          // 16-row tiles of the chunk
  const int Q16 = MT * 16;
  const float a = A[h];
  const bf16* xb = x + b * x_sb + h * P + p0;
  const bf16* dtb = dt + b * dt_sb + h;
  const bf16* bb = Bm + b * b_sb + grp * N;
  const bf16* cb = Cm + b * c_sb + grp * N;

  // The state slice: the initial state's rows, or zero; padding is zero.
  for (int e = tid; e < PS * LDS; e += THREADS) {
    const int pp = e / LDS, kk = e % LDS;
    float val = 0.f;
    if (init_state != nullptr && pp < pvalid && kk < nn)
      val = init_state[((b * H + h) * P + p0 + pp) * N + kk];
    sm.st[pp][kk] = val;
  }

  // A pair of C values (row tr of the chunk, columns col, col + 1; col
  // even, n a multiple of 8) as a bf16 register, zero past the chunk and n.
  const auto c_pair = [&](int64_t c0, int tr, int col) -> uint32_t {
    if (tr >= q || col >= nn) return 0u;
    return *reinterpret_cast<const uint32_t*>(cb + (c0 + tr) * c_sl + col);
  };

  for (int64_t c0 = 0; c0 < L; c0 += Q) {
    __syncthreads();   // the previous chunk's reads are done

    // -- the chunk's start state, (batch, chunk, head, p, n) ---------------
    if (states != nullptr) {
      float* dst = states + (((b * (L / Q) + c0 / Q) * H + h) * P + p0) * N;
      for (int i = tid; i < pvalid * nn; i += THREADS)
        dst[(i / nn) * N + i % nn] = sm.st[i / nn][i % nn];
    }

    // -- stage B, x and dt of the chunk ------------------------------------
    // Rows up to Q16 and every column are written, zero past the chunk, n
    // and p, so the products run on whole tiles with no guard.
    {
      constexpr int C8 = MAXN / 8, STEP = THREADS / C8;
      const int cc = tid % C8;
      const bool col_ok = 8 * cc < nn;
      for (int s = tid / C8; s < Q16; s += STEP) {
        const bool valid = s < q && col_ok;
        cp_async16(&sm.bs[s][8 * cc],
                   valid ? bb + (c0 + s) * b_sl + 8 * cc : bb, valid);
      }
    }
    {
      constexpr int C8 = PS / 8, STEP = THREADS / C8;
      const int cc = tid % C8;
      const bool col_ok = 8 * cc < pvalid;
      for (int s = tid / C8; s < Q16; s += STEP) {
        const bool valid = s < q && col_ok;
        cp_async16(&sm.xs[s][8 * cc],
                   valid ? xb + (c0 + s) * x_sl + 8 * cc : xb, valid);
      }
    }
    cp_async_commit();
    for (int s = tid; s < MAXQ; s += THREADS)
      sm.dts[s] = s < q ? __bfloat162float(dtb[(c0 + s) * dt_sl]) : 0.f;
    cp_async_wait<0>();
    __syncthreads();

    // -- cum and the state-update weights ----------------------------------
    if (warp == 0) {
      // each lane scans four consecutive steps, then the lanes' sums
      float v[4], run = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        run += sm.dts[lane * 4 + e] * a;   // dt is 0 past the chunk
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
        sm.wdt[s] = s < q ? round_bf16(fast_exp2((cum_end - c) * LOG2E)) *
                                sm.dts[s]
                          : 0.f;
      }
    }
    __syncthreads();

    // -- y: the diagonal block and the carried state -----------------------
    for (int half = 0; half < 2; ++half) {
      const int mi = half == 0 ? warp : 2 * WARPS - 1 - warp;
      if (mi >= MT) continue;
      const int tr0 = mi * 16 + g, tr1 = tr0 + 8;   // the lane's two rows
      uint32_t cf[KN][4];   // the tile's C rows as A fragments over n
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        if (kk < NK) {
          const int col = kk * 16 + 2 * t;
          cf[kk][0] = c_pair(c0, tr0, col);
          cf[kk][1] = c_pair(c0, tr1, col);
          cf[kk][2] = c_pair(c0, tr0, col + 8);
          cf[kk][3] = c_pair(c0, tr1, col + 8);
        }
      }
      const float cum0 = sm.cum[tr0], cum1 = sm.cum[tr1];

      // One pass over n: the scores of every column tile on or below the
      // diagonal, and the carried state's term.
      const int ntl = 2 * mi + 2;
      float sc[QT][4];   // the row tile's score tiles
      float yo[PT][4];
#pragma unroll
      for (int jt = 0; jt < QT; ++jt)
        sc[jt][0] = sc[jt][1] = sc[jt][2] = sc[jt][3] = 0.f;
#pragma unroll
      for (int pt = 0; pt < PT; ++pt)
        yo[pt][0] = yo[pt][1] = yo[pt][2] = yo[pt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        if (kk < NK) {
#pragma unroll
          for (int jt = 0; jt < QT; ++jt) {
            if (jt < ntl) {
              uint32_t bf[2];
              bf16mma::load_b_nk(bf, &sm.bs[0][0], LDB, jt * 8, kk * 16,
                                 lane);
              bf16mma::mma(sc[jt], cf[kk], bf);
            }
          }
#pragma unroll
          for (int pt = 0; pt < PT; ++pt) {
            const float* sp = &sm.st[pt * 8 + g][kk * 16 + 2 * t];
            const uint32_t sf[2] = {pair_bf16(sp), pair_bf16(sp + 8)};
            bf16mma::mma(yo[pt], cf[kk], sf);
          }
        }
      }

      // The diagonal block: each two score tiles decayed, times dt, and fed
      // back as the A fragment of one 16-step product with x.
      float yd[PT][4];
#pragma unroll
      for (int pt = 0; pt < PT; ++pt)
        yd[pt][0] = yd[pt][1] = yd[pt][2] = yd[pt][3] = 0.f;
#pragma unroll
      for (int js = 0; js < QT / 2; ++js) {
        if (2 * js < ntl) {
          float w[2][4];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int s = (2 * js + u) * 8 + 2 * t + (e & 1);
              const int tr = e < 2 ? tr0 : tr1;
              const float ct = e < 2 ? cum0 : cum1;
              w[u][e] = s <= tr && tr < q
                            ? sc[2 * js + u][e] * sm.dts[s] *
                                  round_bf16(fast_exp2((ct - sm.cum[s]) *
                                                       LOG2E))
                            : 0.f;
            }
          }
          uint32_t pa[4];
          bf16mma::acc_pair_as_a(pa, w[0], w[1]);
#pragma unroll
          for (int pt = 0; pt < PT; pt += 2) {
            uint32_t xb0[2], xb1[2];
            bf16mma::load_b_kn_pair(xb0, xb1, &sm.xs[0][0], LDX, js * 16,
                                    pt * 8, lane);
            bf16mma::mma(yd[pt], pa, xb0);
            bf16mma::mma(yd[pt + 1], pa, xb1);
          }
        }
      }

      const float e0 = round_bf16(fast_exp2(cum0 * LOG2E));
      const float e1 = round_bf16(fast_exp2(cum1 * LOG2E));
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
        const int pp = pt * 8 + 2 * t;   // even, and pvalid is even
        if (pp < pvalid) {
          if (tr0 < q)
            *reinterpret_cast<uint32_t*>(
                y + ((b * L + c0 + tr0) * H + h) * P + p0 + pp) =
                bf16mma::pack(yd[pt][0] + e0 * yo[pt][0],
                              yd[pt][1] + e0 * yo[pt][1]);
          if (tr1 < q)
            *reinterpret_cast<uint32_t*>(
                y + ((b * L + c0 + tr1) * H + h) * P + p0 + pp) =
                bf16mma::pack(yd[pt][2] + e1 * yo[pt][2],
                              yd[pt][3] + e1 * yo[pt][3]);
        }
      }
    }
    __syncthreads();   // every carried-state read of st is done

    // -- the state update: warp w owns column tiles 2w, 2w + 1, 2w + 8,
    // 2w + 9 (two pairs, at 16w and 16w + 64) ------------------------------
    // Padded columns of B and of the state are zero and stay zero.
    const float keep = fast_exp2(sm.cum[MAXQ - 1] * LOG2E);  // exp(cum_end)
    float sa[2][4][4];   // [row tile of p][column tile]
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = 16 * warp + 64 * (u >> 1) + 8 * (u & 1) + 2 * t;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = mt * 16 + g;
        const float2 top = *reinterpret_cast<const float2*>(&sm.st[r][c]);
        const float2 bot =
            *reinterpret_cast<const float2*>(&sm.st[r + 8][c]);
        sa[mt][u][0] = top.x * keep;
        sa[mt][u][1] = top.y * keep;
        sa[mt][u][2] = bot.x * keep;
        sa[mt][u][3] = bot.y * keep;
      }
    }
    for (int k0 = 0; k0 < Q16; k0 += 16) {
      uint32_t xa[2][4];
      bf16mma::load_at(xa[0], &sm.xs[0][0], LDX, k0, 0, lane);
      bf16mma::load_at(xa[1], &sm.xs[0][0], LDX, k0, 16, lane);
      const float w0 = sm.wdt[k0 + 2 * t], w1 = sm.wdt[k0 + 2 * t + 1];
      const float w8 = sm.wdt[k0 + 8 + 2 * t], w9 = sm.wdt[k0 + 9 + 2 * t];
      uint32_t wb[4][2];
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        uint32_t r0[2], r1[2];
        bf16mma::load_b_kn_pair(r0, r1, &sm.bs[0][0], LDB, k0,
                                16 * warp + 64 * v, lane);
        wb[2 * v][0] = scaled(r0[0], w0, w1);
        wb[2 * v][1] = scaled(r0[1], w8, w9);
        wb[2 * v + 1][0] = scaled(r1[0], w0, w1);
        wb[2 * v + 1][1] = scaled(r1[1], w8, w9);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) bf16mma::mma(sa[mt][u], xa[mt], wb[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = 16 * warp + 64 * (u >> 1) + 8 * (u & 1) + 2 * t;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = mt * 16 + g;
        *reinterpret_cast<float2*>(&sm.st[r][c]) =
            make_float2(sa[mt][u][0], sa[mt][u][1]);
        *reinterpret_cast<float2*>(&sm.st[r + 8][c]) =
            make_float2(sa[mt][u][2], sa[mt][u][3]);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < pvalid * nn; e += THREADS) {
    const int pp = e / nn, kk = e % nn;
    final_state[((b * H + h) * P + p0 + pp) * N + kk] = sm.st[pp][kk];
  }
}

}  // namespace

extern "C" int ssd_scan_bf16_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* init_state, void* y, void* final_state,
    void* states, int64_t batch, int64_t L, int64_t H, int64_t P, int64_t G,
    int64_t N, int64_t Q, int64_t x_sb, int64_t x_sl, int64_t dt_sb,
    int64_t dt_sl, int64_t b_sb, int64_t b_sl, int64_t c_sb, int64_t c_sl,
    void* stream) {
  // 16-byte staging of whole 8-value units: every row of B and x (and the
  // block's slice of x) starts on a 16-byte boundary, and n and p are
  // multiples of 8 (the wrapper's stride rule implies both)
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (Q <= 0 || Q > MAXQ || N <= 0 || N > MAXN || L % Q != 0 || G <= 0 ||
      H % G != 0 || batch > 65535 || H > 65535 || P % 8 != 0 ||
      N % 8 != 0 || !aligned(x) || !aligned(Bm) || !aligned(Cm) ||
      x_sb % 8 != 0 || x_sl % 8 != 0 || b_sb % 8 != 0 || b_sl % 8 != 0 ||
      c_sb % 8 != 0 || c_sl % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(Smem));
  // The shared-memory limit is a per-device attribute: set it once on each
  // device a launch reaches.
  constexpr int MAX_DEVICES = 64;
  static bool configured[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= MAX_DEVICES || !configured[device]) {
    err = cudaFuncSetAttribute(ssd_scan_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < MAX_DEVICES) configured[device] = true;
  }
  const dim3 grid(static_cast<unsigned>((P + PS - 1) / PS),
                  static_cast<unsigned>(H), static_cast<unsigned>(batch));
  ssd_scan_bf16_kernel<<<grid, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<const float*>(init_state),
      static_cast<bf16*>(y), static_cast<float*>(final_state),
      static_cast<float*>(states), L, H, P, G, N, Q, x_sb, x_sl, dt_sb, dt_sl,
      b_sb, b_sl, c_sb, c_sl);
  return static_cast<int>(cudaGetLastError());
}
