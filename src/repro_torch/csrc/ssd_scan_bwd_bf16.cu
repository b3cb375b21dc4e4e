// The chunked SSD scan's backward (Mamba-2) on bf16 x, dt, B, C and dy (A,
// the initial state and the final state's gradient fp32): dx, ddt, dB and dC in bf16, each summed in fp32 and
// rounded once, dA and the initial state's gradient in fp32. The function
// is ssd_scan_bwd.cu's (whose header derives it): per (batch, chunk, head h
// in group g), with cum the within-chunk cumulative sum of dt * A (fp32),
// S0 the chunk's start state, G the gradient reaching its end state,
// CB = C B^T and dP = dy x^T fp32 sums of exact products, the decays
//   l_ts = exp(cum_t - cum_s) for s <= t (else 0), u_s = exp(cum_end -
//   cum_s), v_t = exp(cum_t), and their bf16 values L, w, e,
// K = CB o L and M = dP o L:
//   dx_s  = sum_t bf16(K_ts dt_s) dy_t + w_s dt_s G B_s
//   dC_t  = sum_s bf16(M_ts dt_s) B_s + e_t S0^T dy_t
//   dB_s  = dt_s sum_t bf16(M_ts) C_t + w_s dt_s G^T x_s
//   ddt_s = sum_t K_ts dP_ts + u_s x_s . G B_s + A_h sum_{u >= s} dcum_u
//   dcum_t = sum_s W_ts - sum_s W_st + v_t dy_t . S0 C_t - V_t
//            (+ sum_s V_s + exp(cum_end) <S0, G> at the chunk's last step)
// with W = CB o l o dt_s o dP and V_s = dt_s u_s x_s . G B_s. The values
// (dx, dB, dC and the sum_t K dP of ddt) take the decays rounded to bf16
// where the reference's bf16 scan rounds them (src/repro/arch/ssm.py: `L`,
// `decay_to_end`, `state_decay`), and the bf16(...) are the operands of
// the tensor-core products, rounded once each. The derivatives through the
// decays (dcum: W, V, the S0 term) take the unrounded exponentials, as
// autograd of the reference differentiates exp by its fp32 output. G and
// S0 are fp32 between the chunks and enter their products as two bf16
// terms (hi = bf16(v), lo = bf16(v - hi)), and the chunks' start states
// S0 are recomputed here in fp32 from the inputs, not read from the bf16
// forward (whose states carry its rounded operands): dA sums the state
// terms exp(cum_end) <S0, G> and v_t dy_t . S0 C_t over every chunk, and
// with S0 and G rounded once to bf16, or with the forward's states, it
// was 3.7 to 13 times the plain bf16 scan's error from the fp32 truth on a
// two-chunk case from an initial state at the trainer's widths (a float64
// replay of this kernel; an H100 run agreed). Every sum is fp32.
// dA_h sums dt_u sum_{t >= u} dcum_t over batch, chunks and steps; G of the
// chunk before is exp(cum_end) G + sum_t v_t dy_t C_t^T, and the first
// chunk's is the initial state's gradient. The plain version is
// kernels/ref.py:ssd_scan_bwd_ref; autograd of the plain bf16 scan is the
// bar it is held to.
//
// Replaces: the TPU kernel src/repro/kernels/ssd_scan.py:ssd_scan_pallas
// has no backward; the JAX package differentiates its plain jnp scan
// (src/repro/arch/ssm.py:50) in the model's dtype when it trains a bf16
// Mamba2 (src/repro/launch/dryrun.py:261).
//
// Bound on the H100: at the trainer's shape (x (8, 128, 24, 64), B and C
// (8, 128, 1, 128), one chunk of 128, no initial state and no final-state
// gradient) it reads x, dt, B, C, dy and writes dx, ddt, dB, dC in bf16:
// 10.58 MB, 3.16 us at 3.35 TB/s; the five products over the causal pairs
// need 1.62 GFLOP, 1.64 us at 989 TFLOP/s (kernels/costs.py). Bytes. Its
// fp32 scratch (each head's dB and dC before the group sums, 2 x 12.6 MB
// written and read at that shape) is not in the bound.
//
// Design: three kernels on one stream, no atomics (two runs are
// bit-equal).
//   1. The state pass (only where some chunk has a G or the initial state
//      wants a gradient: more than one chunk, a final-state gradient or an
//      initial state): one block per (head, batch) walks the chunks first
//      to last for their start states (with more than one chunk or an
//      initial state), then last to first for G, as ssd_scan_bwd.cu's
//      walks G, the state in shared memory in fp32 (FMA on the CUDA
//      cores), the bf16 inputs read as their values.
//   2. The chunk kernel: one block of 8 warps per (head, batch x chunk).
//      B, C, x and dy of the chunk are staged once in bf16 (cp.async, 16
//      bytes where rows allow; zero past the chunk, n and p), the two bf16
//      terms of G and of S0 beside them. Each warp owns one 16-row strip
//      twice:
//      a. as s (rows of x, B): over the 16-column blocks t >= s it forms
//         B C^T and x dy^T (16 x 16 each, mma.sync m16n8k16 bf16 with fp32
//         accumulators), K^T, W's column sums and sum_t K dP on the
//         accumulators, and feeds bf16(K^T o dt) and bf16(M^T) straight
//         back as the A operand of dx += (K o dt)^T dy and dB += M^T C
//         (dy and C by ldmatrix.trans); then the G terms (G B_s, x_s G);
//      b. as t (rows of dy, C): over the blocks s <= t it forms C B^T and
//         dy x^T again, W's row sums, and dC += bf16(M o dt) B; then the
//         S0 term e_t dy_t S0 and its dot with C_t.
//      Strip j has 8 - j blocks in a. and j + 1 in b., so at a chunk of
//      128 each warp runs nine. dx goes out in bf16; dB and dC in fp32
//      per head to a scratch. Then one warp takes dcum, its suffix sum (a
//      fixed shuffle order), ddt and the block's share of dA.
//   3. The group sums: dB and dC of group g add its heads' partials in
//      ascending head order and round once; dA adds the blocks' shares
//      over batch and chunks in order.
// C B^T and dy x^T are formed twice (once a strip each way), the price of
// owning every output row in one warp with no cross-warp sum. About 180
// KB of shared memory a block. Head dim at most 64, n at most 128, chunk
// at most 128.
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
using bf16mma::acc_pair_as_a;
using bf16mma::load_a;
using bf16mma::load_b_kn_pair;
using bf16mma::load_b_nk;
using bf16mma::mma;
using bf16mma::round_bf16;
using tf32x3::cp_async16;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;
using tf32x3::fast_exp2;

constexpr int MAXQ = 128;   // largest chunk
constexpr int MAXN = 128;   // largest state size n
constexpr int MAXP = 64;    // largest head dim p
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int LDN = MAXN + 8;   // bf16 rows of n (4 mod 8 words)
constexpr int LDP = MAXP + 8;   // bf16 rows of p
constexpr int NT8 = MAXN / 8;   // most 8-column tiles of n
constexpr int PT8 = MAXP / 8;   // most 8-column tiles of p
constexpr float LOG2E = 1.4426950408889634f;
static_assert(MAXQ == 16 * WARPS, "a warp a 16-row strip");
static_assert(MAXQ == 4 * 32, "the cum scans give each lane four steps");

struct ChunkSmem {
  bf16 bs[MAXQ * LDN];   // B of the chunk (rows s)
  bf16 cs[MAXQ * LDN];   // C (rows t)
  bf16 xs[MAXQ * LDP];   // x (rows s)
  bf16 ys[MAXQ * LDP];   // dy (rows t)
  bf16 gs[2][MAXP * LDN];   // G as two bf16 terms (hi, lo), rows p
  bf16 ss[2][MAXP * LDN];   // S0 the same
  float dts[MAXQ], cum[MAXQ];
  float ecr[MAXQ], wr[MAXQ];   // bf16(exp(cum_t)), bf16(exp(cum_end - cum_s))
  float ecu[MAXQ], wu[MAXQ];   // the same unrounded
  float colw[MAXQ];      // sum_t W_ts (s-major)
  float ddtd[MAXQ];      // sum_t K_ts dP_ts
  float roww[MAXQ];      // sum_s W_ts (t-major)
  float t2[MAXQ];        // w_s x_s . G B_s
  float t5[MAXQ];        // e_t dy_t . S0 C_t
  float red[WARPS];
  float cum_end, sg;
};

static_assert(sizeof(ChunkSmem) <= 232448, "one block's shared memory");

struct Args {
  const bf16 *x, *dt, *Bm, *Cm, *dy;
  const float *A, *sbuf, *gbuf;
  bf16 *dx, *ddt;
  float *dbh, *dch, *dapart;
  int64_t L, H, P, G, N, Q, NC;
  int64_t x_sb, x_sl, dt_sb, dt_sl, b_sb, b_sl, c_sb, c_sl;
  int has_init, g_last_zero, vec_x, vec_b, vec_c, vec_y;
};

// Rows [0, rows_pad) and columns [0, CC) of dst (rows of ld) from
// src[r * rs + c]; zero past rows x cols. cp.async of 16 bytes when `vec`
// (cols a multiple of 8, src and rs 16-byte aligned), else plain loads.
template <int CC>
__device__ __forceinline__ void stage(bf16* dst, int ld, int rows_pad,
                                      const bf16* src, int64_t rs, int rows,
                                      int cols, bool vec) {
  if (vec) {
    constexpr int C8 = CC / 8;
    for (int e = threadIdx.x; e < rows_pad * C8; e += THREADS) {
      const int r = e / C8, c = 8 * (e % C8);
      const bool ok = r < rows && c < cols;
      cp_async16(dst + r * ld + c, ok ? src + r * rs + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows_pad * CC; e += THREADS) {
      const int r = e / CC, c = e % CC;
      dst[r * ld + c] = r < rows && c < cols ? src[r * rs + c]
                                             : __float2bfloat16_rn(0.f);
    }
  }
}

// A dense (p, n) fp32 state as two bf16 terms, hi = bf16(v) and lo =
// bf16(v - hi) (v to about 2^-17 of itself), into rows of LDN; zero past
// p, n.
__device__ __forceinline__ void stage_state(bf16 (*dst)[MAXP * LDN],
                                            const float* src, int pp,
                                            int nn) {
  for (int e = threadIdx.x; e < MAXP * MAXN; e += THREADS) {
    const int r = e / MAXN, c = e % MAXN;
    const float v = r < pp && c < nn ? src[r * nn + c] : 0.f;
    const bf16 hi = __float2bfloat16_rn(v);
    dst[0][r * LDN + c] = hi;
    dst[1][r * LDN + c] = __float2bfloat16_rn(v - __bfloat162float(hi));
  }
}

// cum (inclusive scan of dt * a over the chunk) by warp 0, each lane four
// steps, then the lanes' sums by shuffles in a fixed order; dts holds dt,
// zero past q. Returns cum_end to every lane of warp 0.
__device__ __forceinline__ float chunk_cum(const float* dts, float* cum,
                                           float a, int q) {
  const int lane = threadIdx.x & 31;
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
  }
  return cum_end;
}

// exp(cum_t - cum_s) where s <= t < q, else 0 (unrounded)
__device__ __forceinline__ float decay(const float* cum, int t, int s,
                                       int q) {
  return s <= t && t < q ? fast_exp2((cum[t] - cum[s]) * LOG2E) : 0.f;
}

__device__ __forceinline__ float bf(const bf16 v) { return __bfloat162float(v); }

// Sum over the four lanes of a quad (the lanes of one accumulator row),
// in a fixed order.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__global__ void __launch_bounds__(THREADS, 1)
    ssd_bwd_bf16_chunk_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int64_t h = blockIdx.x, bc = blockIdx.y;
  const int64_t b = bc / a.NC, ci = bc % a.NC, c0 = ci * a.Q;
  const int64_t grp = h / (a.H / a.G);
  const int q = static_cast<int>(a.Q), nn = static_cast<int>(a.N);
  const int pp = static_cast<int>(a.P);
  const int S16 = (q + 15) / 16, Q16 = 16 * S16;
  const int NK = (nn + 15) / 16, PK = (pp + 15) / 16;   // k16 steps
  const int NT = 2 * NK, PT = 2 * PK;                   // 8-column tiles
  const float av = a.A[h];
  const bf16* xb = a.x + b * a.x_sb + c0 * a.x_sl + h * a.P;
  const bf16* yb = a.dy + ((b * a.L + c0) * a.H + h) * a.P;
  const bf16* bb = a.Bm + b * a.b_sb + c0 * a.b_sl + grp * a.N;
  const bf16* cb = a.Cm + b * a.c_sb + c0 * a.c_sl + grp * a.N;
  const bf16* dtb = a.dt + b * a.dt_sb + c0 * a.dt_sl + h;
  const int64_t orow = (b * a.L + c0) * a.H + h;   // step s: orow + s H
  const int64_t slot = (bc * a.H + h) * a.P * a.N;   // (b, c, h) p x n
  const bool has_g = a.gbuf != nullptr && !(a.g_last_zero && ci == a.NC - 1);
  const bool has_s = a.sbuf != nullptr && !(ci == 0 && !a.has_init);
  const float* gsrc = has_g ? a.gbuf + slot : nullptr;
  const float* ssrc = has_s ? a.sbuf + slot : nullptr;

  stage<MAXN>(sm.bs, LDN, Q16, bb, a.b_sl, q, nn, a.vec_b);
  stage<MAXN>(sm.cs, LDN, Q16, cb, a.c_sl, q, nn, a.vec_c);
  stage<MAXP>(sm.xs, LDP, Q16, xb, a.x_sl, q, pp, a.vec_x);
  stage<MAXP>(sm.ys, LDP, Q16, yb, a.H * a.P, q, pp, a.vec_y);
  cp_async_commit();
  if (has_g) stage_state(sm.gs, gsrc, pp, nn);
  if (has_s) stage_state(sm.ss, ssrc, pp, nn);
  if (tid < MAXQ) {
    sm.dts[tid] = tid < q ? bf(dtb[tid * a.dt_sl]) : 0.f;
    sm.colw[tid] = sm.ddtd[tid] = sm.roww[tid] = 0.f;
    sm.t2[tid] = sm.t5[tid] = 0.f;
  }
  // <S0, G> in fp32, for dcum's last step: a fixed order of partials
  float sg = 0.f;
  if (has_s && has_g)
    for (int e = tid; e < pp * nn; e += THREADS) sg += ssrc[e] * gsrc[e];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sg += __shfl_xor_sync(0xffffffffu, sg, off);
  if (lane == 0) sm.red[warp] = sg;
  __syncthreads();
  if (warp == 0) {
    const float cum_end = chunk_cum(sm.dts, sm.cum, av, q);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = lane * 4 + e;
      const float c = sm.cum[s];
      sm.ecu[s] = s < q ? expf(c) : 0.f;
      sm.wu[s] = s < q ? expf(cum_end - c) : 0.f;
      sm.ecr[s] = round_bf16(sm.ecu[s]);
      sm.wr[s] = round_bf16(sm.wu[s]);
    }
    if (lane == 0) {
      float t = 0.f;
      for (int w = 0; w < WARPS; ++w) t += sm.red[w];
      sm.sg = t;
      sm.cum_end = cum_end;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const int j0 = 16 * warp;   // this warp's strip
  if (j0 < q) {
    const int ra = j0 + g, rb = ra + 8;   // the lane's two rows
    // -- a. the strip as s: dx, dB, W's column sums, sum_t K dP --------
    {
      float dxa[PT8][4], dba[NT8][4];
#pragma unroll
      for (int i = 0; i < PT8; ++i) dxa[i][0] = dxa[i][1] = dxa[i][2] = dxa[i][3] = 0.f;
#pragma unroll
      for (int i = 0; i < NT8; ++i) dba[i][0] = dba[i][1] = dba[i][2] = dba[i][3] = 0.f;
      float colw[2] = {0.f, 0.f}, kdp[2] = {0.f, 0.f};
      const float dtr[2] = {sm.dts[ra], sm.dts[rb]};
      for (int tb = warp; tb < S16; ++tb) {
        const int t0 = 16 * tb;
        float bcm[2][4] = {}, dpm[2][4] = {};
        for (int kk = 0; kk < NK; ++kk) {
          uint32_t af[4], fb[2];
          load_a(af, sm.bs, LDN, j0, 16 * kk, lane);
          load_b_nk(fb, sm.cs, LDN, t0, 16 * kk, lane);
          mma(bcm[0], af, fb);
          load_b_nk(fb, sm.cs, LDN, t0 + 8, 16 * kk, lane);
          mma(bcm[1], af, fb);
        }
        for (int kk = 0; kk < PK; ++kk) {
          uint32_t af[4], fb[2];
          load_a(af, sm.xs, LDP, j0, 16 * kk, lane);
          load_b_nk(fb, sm.ys, LDP, t0, 16 * kk, lane);
          mma(dpm[0], af, fb);
          load_b_nk(fb, sm.ys, LDP, t0 + 8, 16 * kk, lane);
          mma(dpm[1], af, fb);
        }
        // K^T and M^T on the accumulators: c0, c1 are row s = ra, columns
        // t = t0 + 8u + 2tq, + 1; c2, c3 row rb
        float kd[2][4], mr[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, s = r ? rb : ra;
            const int t = t0 + 8 * u + 2 * tq + (e & 1);
            const float lu = decay(sm.cum, t, s, q), l = round_bf16(lu);
            const float k = bcm[u][e] * l, dp = dpm[u][e];
            colw[r] += bcm[u][e] * lu * dtr[r] * dp;
            kdp[r] += k * dp;
            kd[u][e] = k * dtr[r];
            mr[u][e] = dp * l;
          }
        uint32_t ka[4], ma[4];
        acc_pair_as_a(ka, kd[0], kd[1]);
        acc_pair_as_a(ma, mr[0], mr[1]);
#pragma unroll
        for (int nb = 0; nb < PT8; nb += 2) {
          if (nb >= PT) continue;
          uint32_t b0[2], b1[2];
          load_b_kn_pair(b0, b1, sm.ys, LDP, t0, 8 * nb, lane);
          mma(dxa[nb], ka, b0);
          mma(dxa[nb + 1], ka, b1);
        }
#pragma unroll
        for (int nb = 0; nb < NT8; nb += 2) {
          if (nb >= NT) continue;
          uint32_t b0[2], b1[2];
          load_b_kn_pair(b0, b1, sm.cs, LDN, t0, 8 * nb, lane);
          mma(dba[nb], ma, b0);
          mma(dba[nb + 1], ma, b1);
        }
      }
      // dB's first term times dt_s
#pragma unroll
      for (int i = 0; i < NT8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) dba[i][e] *= dtr[e >> 1];
      // the G terms: dx += w_s dt_s G B_s, t2 = w_s x_s . G B_s,
      // dB += w_s dt_s x_s G
      float xgb[2] = {0.f, 0.f};
      if (has_g) {
        const float wsr[2] = {sm.wr[ra] * dtr[0], sm.wr[rb] * dtr[1]};
#pragma unroll
        for (int nb = 0; nb < PT8; nb += 2) {
          if (nb >= PT) continue;
          float gb[2][4] = {};
          for (int kk = 0; kk < NK; ++kk) {
            uint32_t af[4], fb[2];
            load_a(af, sm.bs, LDN, j0, 16 * kk, lane);
#pragma unroll
            for (int part = 0; part < 2; ++part) {
              load_b_nk(fb, sm.gs[part], LDN, 8 * nb, 16 * kk, lane);
              mma(gb[0], af, fb);
              load_b_nk(fb, sm.gs[part], LDN, 8 * nb + 8, 16 * kk, lane);
              mma(gb[1], af, fb);
            }
          }
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              const int col = 8 * (nb + u) + 2 * tq + (e & 1);
              dxa[nb + u][e] += wsr[r] * gb[u][e];
              xgb[r] += bf(sm.xs[(r ? rb : ra) * LDP + col]) * gb[u][e];
            }
        }
#pragma unroll
        for (int nb = 0; nb < NT8; nb += 2) {
          if (nb >= NT) continue;
          float xg[2][4] = {};
          for (int kk = 0; kk < PK; ++kk) {
            uint32_t af[4], b0[2], b1[2];
            load_a(af, sm.xs, LDP, j0, 16 * kk, lane);
#pragma unroll
            for (int part = 0; part < 2; ++part) {
              load_b_kn_pair(b0, b1, sm.gs[part], LDN, 16 * kk, 8 * nb, lane);
              mma(xg[0], af, b0);
              mma(xg[1], af, b1);
            }
          }
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) dba[nb + u][e] += wsr[e >> 1] * xg[u][e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        colw[r] = quad_sum(colw[r]);
        kdp[r] = quad_sum(kdp[r]);
        xgb[r] = quad_sum(xgb[r]);
      }
      if (tq == 0) {
        if (ra < q) {
          sm.colw[ra] = colw[0];
          sm.ddtd[ra] = kdp[0];
          sm.t2[ra] = sm.wu[ra] * xgb[0];
        }
        if (rb < q) {
          sm.colw[rb] = colw[1];
          sm.ddtd[rb] = kdp[1];
          sm.t2[rb] = sm.wu[rb] * xgb[1];
        }
      }
      // dx in bf16; dB's fp32 partial of this head
#pragma unroll
      for (int nb = 0; nb < PT8; ++nb) {
        if (nb >= PT) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = e >> 1 ? rb : ra, col = 8 * nb + 2 * tq + (e & 1);
          if (s < q && col < pp)
            a.dx[(orow + s * a.H) * a.P + col] = __float2bfloat16_rn(dxa[nb][e]);
        }
      }
#pragma unroll
      for (int nb = 0; nb < NT8; ++nb) {
        if (nb >= NT) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = e >> 1 ? rb : ra, col = 8 * nb + 2 * tq + (e & 1);
          if (s < q && col < nn) a.dbh[(orow + s * a.H) * a.N + col] = dba[nb][e];
        }
      }
    }
    // -- b. the strip as t: dC, W's row sums, the S0 term -----------------
    {
      float dca[NT8][4];
#pragma unroll
      for (int i = 0; i < NT8; ++i) dca[i][0] = dca[i][1] = dca[i][2] = dca[i][3] = 0.f;
      float roww[2] = {0.f, 0.f};
      for (int sb = 0; sb <= warp; ++sb) {
        const int s0 = 16 * sb;
        float cbm[2][4] = {}, dpm[2][4] = {};
        for (int kk = 0; kk < NK; ++kk) {
          uint32_t af[4], fb[2];
          load_a(af, sm.cs, LDN, j0, 16 * kk, lane);
          load_b_nk(fb, sm.bs, LDN, s0, 16 * kk, lane);
          mma(cbm[0], af, fb);
          load_b_nk(fb, sm.bs, LDN, s0 + 8, 16 * kk, lane);
          mma(cbm[1], af, fb);
        }
        for (int kk = 0; kk < PK; ++kk) {
          uint32_t af[4], fb[2];
          load_a(af, sm.ys, LDP, j0, 16 * kk, lane);
          load_b_nk(fb, sm.xs, LDP, s0, 16 * kk, lane);
          mma(dpm[0], af, fb);
          load_b_nk(fb, sm.xs, LDP, s0 + 8, 16 * kk, lane);
          mma(dpm[1], af, fb);
        }
        // c0, c1 are row t = ra, columns s = s0 + 8u + 2tq, + 1; c2, c3 rb
        float md[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, t = r ? rb : ra;
            const int s = s0 + 8 * u + 2 * tq + (e & 1);
            const float lu = decay(sm.cum, t, s, q);
            const float m = dpm[u][e] * sm.dts[s];
            roww[r] += cbm[u][e] * lu * m;
            md[u][e] = m * round_bf16(lu);
          }
        uint32_t ma[4];
        acc_pair_as_a(ma, md[0], md[1]);
#pragma unroll
        for (int nb = 0; nb < NT8; nb += 2) {
          if (nb >= NT) continue;
          uint32_t b0[2], b1[2];
          load_b_kn_pair(b0, b1, sm.bs, LDN, s0, 8 * nb, lane);
          mma(dca[nb], ma, b0);
          mma(dca[nb + 1], ma, b1);
        }
      }
      // the S0 term: dC += e_t S0^T dy_t, t5 = C_t . that
      float t5[2] = {0.f, 0.f};
      const float eu[2] = {sm.ecu[ra], sm.ecu[rb]};
      if (has_s) {
        const float er[2] = {sm.ecr[ra], sm.ecr[rb]};
#pragma unroll
        for (int nb = 0; nb < NT8; nb += 2) {
          if (nb >= NT) continue;
          float ds[2][4] = {};
          for (int kk = 0; kk < PK; ++kk) {
            uint32_t af[4], b0[2], b1[2];
            load_a(af, sm.ys, LDP, j0, 16 * kk, lane);
#pragma unroll
            for (int part = 0; part < 2; ++part) {
              load_b_kn_pair(b0, b1, sm.ss[part], LDN, 16 * kk, 8 * nb, lane);
              mma(ds[0], af, b0);
              mma(ds[1], af, b1);
            }
          }
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              const int col = 8 * (nb + u) + 2 * tq + (e & 1);
              dca[nb + u][e] += er[r] * ds[u][e];
              t5[r] += bf(sm.cs[(r ? rb : ra) * LDN + col]) * ds[u][e];
            }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        roww[r] = quad_sum(roww[r]);
        t5[r] = quad_sum(t5[r]);
      }
      if (tq == 0) {
        if (ra < q) {
          sm.roww[ra] = roww[0];
          sm.t5[ra] = eu[0] * t5[0];
        }
        if (rb < q) {
          sm.roww[rb] = roww[1];
          sm.t5[rb] = eu[1] * t5[1];
        }
      }
#pragma unroll
      for (int nb = 0; nb < NT8; ++nb) {
        if (nb >= NT) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = e >> 1 ? rb : ra, col = 8 * nb + 2 * tq + (e & 1);
          if (t < q && col < nn) a.dch[(orow + t * a.H) * a.N + col] = dca[nb][e];
        }
      }
    }
  }
  __syncthreads();

  // -- c. dcum, its suffix sum, ddt and the block's share of dA -----------
  if (warp == 0) {
    float vs = 0.f;   // sum_t V_t = sum_t dt_t t2_t
#pragma unroll
    for (int e = 0; e < 4; ++e) vs += sm.dts[lane * 4 + e] * sm.t2[lane * 4 + e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      vs += __shfl_xor_sync(0xffffffffu, vs, off);
    float suf[4];   // sums over this lane's steps e.. 3
#pragma unroll
    for (int e = 3; e >= 0; --e) {
      const int t = lane * 4 + e;
      float d = 0.f;
      if (t < q) {
        d = sm.roww[t] - sm.colw[t] + sm.t5[t] - sm.dts[t] * sm.t2[t];
        if (t == q - 1) d += vs + expf(sm.cum_end) * sm.sg;
      }
      suf[e] = e < 3 ? d + suf[e + 1] : d;
    }
    float incl = suf[0];   // sum over this lane and the lanes after it
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += up;
    }
    float after = __shfl_down_sync(0xffffffffu, incl, 1);
    if (lane == 31) after = 0.f;
    float da = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = lane * 4 + e;
      const float dda = suf[e] + after;   // d(dt A)_t
      if (t < q) {
        a.ddt[orow + t * a.H] =
            __float2bfloat16_rn(sm.ddtd[t] + sm.t2[t] + av * dda);
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
constexpr int LDS = MAXN + 1;   // rows of 128-wide fp32 tiles (Q x n, p x n)
constexpr int LDY = MAXP + 1;   // rows of Q x p tiles

struct StateSmem {
  float gs[MAXP * LDS];    // G
  float cs[MAXQ * LDS];    // C of the chunk
  float ys[MAXQ * LDY];    // e_t dy of the chunk
  float dts[MAXQ], cum[MAXQ], ecum[MAXQ];
};

// dst[r * ld + k] = src[r * rs + k] (times rscale[r] if given) as fp32 for
// r < rows and k < cols, zero elsewhere in rows < RR and columns < CC.
template <int CC, typename T>
__device__ __forceinline__ void stage_f32(float* dst, int ld, int RR,
                                          const T* src, int64_t rs, int rows,
                                          int cols, const float* rscale) {
  for (int e = threadIdx.x; e < RR * CC; e += STATE_THREADS) {
    const int r = e / CC, k = e % CC;
    float v = 0.f;
    if (r < rows && k < cols) {
      v = static_cast<float>(src[r * rs + k]);
      if (rscale != nullptr) v *= rscale[r];
    }
    dst[r * ld + k] = v;
  }
}

// One chunk's step of a walk over the states (p x n in gs):
// st <- keep st + sum_k ys[k] cs[k]^T, with ys (Q x p) and cs (Q x n) rows
// of the chunk; fp32 FMA on the CUDA cores, k in order.
__device__ __forceinline__ void walk_step(StateSmem& sm, float keep, int q) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[i][j] = keep * sm.gs[(ty + 16 * i) * LDS + tx + 16 * j];
#pragma unroll 2
  for (int k = 0; k < q; ++k) {
    float av4[4], bv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) av4[i] = sm.ys[k * LDY + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = sm.cs[k * LDS + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av4[i], bv[j], acc[i][j]);
  }
  __syncthreads();   // every read of gs is done
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      sm.gs[(ty + 16 * i) * LDS + tx + 16 * j] = acc[i][j];
}

// One block per (head, batch). With `sbuf`, first the chunks' start
// states, first to last, into sbuf: S <- exp(cum_end) S + sum_s (dt_s
// u_s x_s) B_s^T from the initial state (or zero), u_s = exp(cum_end -
// cum_s) unrounded. Then G, last to first, into gbuf:
// G <- exp(cum_end) G + sum_t (v_t dy_t) C_t^T, v_t = exp(cum_t), from
// dfinal (or zero); the first chunk's is dinit.
__global__ void __launch_bounds__(STATE_THREADS, 1) ssd_bwd_bf16_state_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dt,
    const float* __restrict__ A, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
    const float* __restrict__ init, const float* __restrict__ dfinal,
    float* __restrict__ sbuf, float* __restrict__ gbuf,
    float* __restrict__ dinit, int64_t L, int64_t H, int64_t P, int64_t G,
    int64_t N, int64_t Q, int64_t x_sb, int64_t x_sl, int64_t dt_sb,
    int64_t dt_sl, int64_t b_sb, int64_t b_sl, int64_t c_sb, int64_t c_sl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StateSmem& sm = *reinterpret_cast<StateSmem*>(smem_raw);
  const int64_t h = blockIdx.x, b = blockIdx.y, NC = L / Q;
  const int64_t grp = h / (H / G);
  const int tid = threadIdx.x;
  const int q = static_cast<int>(Q), nn = static_cast<int>(N);
  const int pp = static_cast<int>(P);
  const float av = A[h];
  const int64_t slot = (b * H + h) * P * N;
  // dt of the chunk at c0, cum and the rows' scale (dt_s u_s for the
  // states, v_t for G) into ecum
  auto tables = [&](int64_t c0, bool states) {
    for (int s = tid; s < MAXQ; s += STATE_THREADS)
      sm.dts[s] = s < q ? bf(dt[b * dt_sb + (c0 + s) * dt_sl + h]) : 0.f;
    __syncthreads();
    if (tid < 32) {
      const float cum_end = chunk_cum(sm.dts, sm.cum, av, q);
      for (int e = 0; e < 4; ++e) {
        const int s = tid * 4 + e;
        sm.ecum[s] = s >= q ? 0.f
                     : states ? sm.dts[s] * expf(cum_end - sm.cum[s])
                              : expf(sm.cum[s]);
      }
    }
    __syncthreads();
  };
  auto store = [&](float* dst) {   // gs (p x n) to a dense slot
    for (int e = tid; e < pp * nn; e += STATE_THREADS)
      dst[(e / nn) * N + e % nn] = sm.gs[(e / nn) * LDS + e % nn];
  };
  if (sbuf != nullptr) {
    stage_f32<MAXN>(sm.gs, LDS, MAXP, init != nullptr ? init + slot : init,
                    N, init != nullptr ? pp : 0, nn, nullptr);
    for (int64_t ci = 0; ci < NC; ++ci) {
      const int64_t c0 = ci * Q;
      __syncthreads();   // the state of this chunk's start is in gs
      store(sbuf + ((b * NC + ci) * H + h) * P * N);
      if (ci == NC - 1) break;
      stage_f32<MAXN>(sm.cs, LDS, MAXQ, Bm + b * b_sb + c0 * b_sl + grp * N,
                      b_sl, q, nn, nullptr);
      tables(c0, true);
      stage_f32<MAXP>(sm.ys, LDY, MAXQ, x + b * x_sb + c0 * x_sl + h * P,
                      x_sl, q, pp, sm.ecum);
      __syncthreads();
      walk_step(sm, expf(sm.cum[q - 1]), q);
    }
    __syncthreads();
  }
  stage_f32<MAXN>(sm.gs, LDS, MAXP, dfinal != nullptr ? dfinal + slot : dfinal,
                  N, dfinal != nullptr ? pp : 0, nn, nullptr);
  for (int64_t ci = NC - 1; ci >= 0; --ci) {
    const int64_t c0 = ci * Q;
    __syncthreads();   // G of this chunk is in gs
    store(gbuf + ((b * NC + ci) * H + h) * P * N);
    stage_f32<MAXN>(sm.cs, LDS, MAXQ, Cm + b * c_sb + c0 * c_sl + grp * N,
                    c_sl, q, nn, nullptr);
    tables(c0, false);
    stage_f32<MAXP>(sm.ys, LDY, MAXQ, dy + ((b * L + c0) * H + h) * P, H * P,
                    q, pp, sm.ecum);
    __syncthreads();
    walk_step(sm, expf(sm.cum[q - 1]), q);
  }
  __syncthreads();
  if (dinit != nullptr) store(dinit + slot);
}

// -- kernel 3, the group sums ---------------------------------------------

// dB, dC of each group (its heads' fp32 partials in ascending order,
// rounded once) and dA (the blocks' shares over batch and chunks in order).
__global__ void ssd_bwd_bf16_sum_kernel(const float* __restrict__ dbh,
                                        const float* __restrict__ dch,
                                        const float* __restrict__ dapart,
                                        bf16* __restrict__ dB,
                                        bf16* __restrict__ dC,
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
    dB[e] = __float2bfloat16_rn(sb);
    dC[e] = __float2bfloat16_rn(sc);
  }
  if (blockIdx.x == 0)
    for (int64_t hh = threadIdx.x; hh < H; hh += blockDim.x) {
      float s = 0.f;
      for (int64_t u = 0; u < n_part; ++u) s += dapart[u * H + hh];
      dA[hh] = s;
    }
}

cudaError_t allow_smem(const void* fn, int bytes, int which) {
  // The shared-memory limit is a per-device attribute: set it once on each
  // device a launch reaches.
  constexpr int MAX_DEVICES = 64;
  static bool configured[2][MAX_DEVICES] = {};
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

// dfinal, init, dinit may be null (no final-state gradient, no initial
// state); init and dinit are null together. sbuf: (batch, L / Q, H, P, N)
// fp32 scratch for the chunks' start states, which the state pass
// recomputes (with more than one chunk or an initial state; else null).
// gbuf: the same shape, G of each chunk, used when the state pass runs
// (more than one chunk, a dfinal or a dinit); dbh, dch: (batch, L, H, N)
// fp32 scratch; dapart: (batch * L / Q, H) fp32. x, dt, B, C, dy, dx, ddt,
// dB, dC are bf16; A, dfinal, init, dA, dinit fp32; dy, dx, ddt, dB, dC
// dense.
extern "C" int ssd_scan_bwd_bf16_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* dy, const void* dfinal, const void* init,
    void* sbuf, void* gbuf, void* dbh, void* dch, void* dapart, void* dx,
    void* ddt, void* dA, void* dB, void* dC, void* dinit, int64_t batch, int64_t L,
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
    err = allow_smem(reinterpret_cast<const void*>(ssd_bwd_bf16_state_kernel),
                     sizeof(StateSmem), 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_bwd_bf16_state_kernel<<<dim3(static_cast<unsigned>(H),
                                     static_cast<unsigned>(batch)),
                                STATE_THREADS, sizeof(StateSmem), s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dt),
        static_cast<const float*>(A), static_cast<const bf16*>(Bm),
        static_cast<const bf16*>(Cm), static_cast<const bf16*>(dy),
        static_cast<const float*>(init), static_cast<const float*>(dfinal),
        static_cast<float*>(sbuf), static_cast<float*>(gbuf),
        static_cast<float*>(dinit), L, H, P, G, N, Q, x_sb, x_sl, dt_sb,
        dt_sl, b_sb, b_sl, c_sb, c_sl);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = allow_smem(reinterpret_cast<const void*>(ssd_bwd_bf16_chunk_kernel),
                   sizeof(ChunkSmem), 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.dt = static_cast<const bf16*>(dt);
  a.A = static_cast<const float*>(A);
  a.Bm = static_cast<const bf16*>(Bm);
  a.Cm = static_cast<const bf16*>(Cm);
  a.dy = static_cast<const bf16*>(dy);
  a.sbuf = static_cast<const float*>(sbuf);
  a.gbuf = state_pass ? static_cast<const float*>(gbuf) : nullptr;
  a.dx = static_cast<bf16*>(dx);
  a.ddt = static_cast<bf16*>(ddt);
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
  a.vec_x = aligned(x) && P % 8 == 0 && x_sb % 8 == 0 && x_sl % 8 == 0;
  a.vec_b = aligned(Bm) && N % 8 == 0 && b_sb % 8 == 0 && b_sl % 8 == 0;
  a.vec_c = aligned(Cm) && N % 8 == 0 && c_sb % 8 == 0 && c_sl % 8 == 0;
  a.vec_y = aligned(dy) && P % 8 == 0;
  ssd_bwd_bf16_chunk_kernel<<<dim3(static_cast<unsigned>(H),
                                   static_cast<unsigned>(batch * NC)),
                              THREADS, sizeof(ChunkSmem), s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (batch * L * G * N + 255) / 256;
  ssd_bwd_bf16_sum_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      static_cast<const float*>(dbh), static_cast<const float*>(dch),
      static_cast<const float*>(dapart), static_cast<bf16*>(dB),
      static_cast<bf16*>(dC), static_cast<float*>(dA), batch * L, H, G, N,
      batch * NC);
  return static_cast<int>(cudaGetLastError());
}
