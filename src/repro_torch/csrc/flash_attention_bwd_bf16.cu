// Backward of blockwise (flash) attention with grouped KV heads, bf16: given
// bf16 q, k, v, the forward's bf16 output o and its fp32 row log-sum-exp
// lse (natural log, (B, H, Sq), from flash_attention_bf16.cu), and bf16 dO,
// it writes bf16 dq, dk and dv, each summed in fp32 and rounded once:
//   P[i, j]  = exp(s[i, j] - lse[i]),  s[i, j] = q[i] . k[j] * D^-0.5
//   dv[j]    = sum_i bf16(P[i, j]) dO[i]
//   dS[i, j] = P[i, j] (dO[i] . v[j] - D[i]),  D[i] = dO[i] . o[i]
//   dq[i]    = D^-0.5 sum_j bf16(dS[i, j]) k[j]
//   dk[j]    = D^-0.5 sum_i bf16(dS[i, j]) q[i]
// per query head h, with k and v read from (and dk, dv summed into) the kv
// head h / G. S, dP and D are fp32 sums of exact products of bf16 values;
// P is rounded to bf16 where the forward rounds it (the A operand of
// dV = P^T dO), and dS, formed in fp32 from the unrounded P, is rounded
// only as the operand of dQ = dS K and dK = dS^T Q. The masks are the
// forward's: causal (j > i masked) and a window (i - j >= window masked),
// so a masked pair has P = dS = 0; a row that sees no key (only with a
// window, i >= Skv - 1 + window) averages every key in the forward:
// P = 1 / Skv, dS = 0. Non-causal attention with Sq != Skv (cross
// attention) is the same arithmetic without a mask.
//
// The JAX package has no backward kernel: its trainer differentiates the
// plain jnp attention in the model's dtype (src/repro/arch/layers.py:81
// _sdpa, the model built at dtype=jnp.bfloat16 by
// src/repro/launch/dryrun.py:261). This is the backward of the port's bf16
// forward kernel, which replaces
// src/repro/kernels/flash_attention.py:flash_attention_kernel in bf16;
// flash_attention_bwd.cu is the fp32 form.
//
// Bound on the H100: at the trainer's shape (Qwen2-0.5B, B = 8, S = 128,
// 14 query heads over 2 KV heads, D = 64, causal) it reads q, o, dO, k, v
// in bf16 and lse in fp32 and writes dq, dk, dv in bf16: about 8.45 MB,
// 2.52 us at 3.35 TB/s; the five products over the causal pairs are about
// 0.59 GFLOP, 0.60 us at 989 TFLOP/s. Bytes. At the vision model's cross
// shape (q (8, 128, 32, 128), k/v (8, 1024, 8, 128), non-causal) the
// 42.9 GFLOP take 43.4 us: operations (kernels/costs.py).
//
// Design: flash_attention_bwd.cu's three kernels, grids and roles, with
// every product a bf16 `mma.sync` m16n8k16 step with fp32 accumulators
// (mma_bf16.cuh) in place of the 3xTF32 m16n8k8 steps, deterministic (no
// atomics):
//   1. rowdot: D[i] = dO[i] . o[i] in fp32, D / 8 lanes a row, 16-byte
//      loads, a fixed shuffle order.
//   2. dkdv: one CTA of 4 warps per (batch, query head, 64 keys), each warp
//      16 keys; the G CTAs of a kv head form one thread-block cluster (up
//      to 8 ranks; beyond G = 8 a rank takes ceil(G / 8) heads in order, so
//      G up to 64 fits). K and V of the CTA's keys stay in shared memory;
//      Q, dO, lse and D of each 64-row query tile are double-buffered by
//      cp.async. A warp forms S^T = K Q^T and dP^T = V dO^T (K and V rows
//      the A operand, Q and dO rows read as B by plain 32-bit loads), P^T
//      and dS^T on the accumulators, and feeds two neighbouring 8-query
//      tiles of each, rounded to bf16, straight back as the A operand of
//      dV += P^T dO and dK += dS^T Q, with dO and Q as B by
//      ldmatrix.trans. The ranks' fp32 partials meet in shared memory and
//      rank r sums its 1/C slice over ranks 0, 1, ..., C - 1 in that order
//      (distributed shared memory), scales, rounds and writes it.
//   3. dq: one CTA of 4 warps per (batch, head, 64 query rows), K/V tiles
//      double-buffered by cp.async; S = Q K^T and dP = dO V^T again, then
//      dQ += dS K with dS from the accumulators and K by ldmatrix.trans;
//      launched as dk/dv's programmatic dependent so the two overlap.
// Shared-memory rows are D + 8 bf16 (a row stride of 4 mod 8 words and an
// odd multiple of 16 bytes), so both the 32-bit fragment reads and
// ldmatrix hit distinct banks. Q, K, V, o and dO need 16-byte aligned
// rows: strides in multiples of 8 elements (the wrapper checks).
//
// C interface: launches on the given stream, does not synchronise,
// allocates nothing (the wrapper passes D's (B, H, Sq) fp32 scratch) and
// returns the first non-zero error. `parts` picks the kernels (1 rowdot,
// 2 dkdv, 4 dq; 7 all), so that each can be timed alone.

#include <cooperative_groups.h>
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
using tf32x3::cp_async16;
using tf32x3::cp_async4;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;
using tf32x3::fast_exp2;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWDOT_THREADS = 256;
constexpr int BQ = 64;           // query rows per tile
constexpr int BKV = 16 * WARPS;  // keys per dk/dv CTA
constexpr int MAX_CLUSTER = 8;   // the portable cluster size
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const bf16 *q, *k, *v, *o, *dout;
  const float* lse;
  float* dvec;
  bf16 *dq, *dk, *dv;
  int64_t B, Sq, Skv, H, KV, G;
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int64_t osb, oss, osh, dsb, dss, dsh;
  int causal;
  int64_t window;
  int cluster, heads_per_rank;   // dk/dv: C ranks of ceil(G / 8) heads
  float scale, scale_log2;
};

template <int D>
struct Tile {
  static constexpr int LD = D + 8;               // padded bf16 row
  static constexpr int LDF = D + 4;              // padded fp32 partial row
  static constexpr int QN = D <= 64 ? 64 : 32;   // dkdv: queries a pass
  static constexpr int BK = D <= 64 ? 64 : 32;   // dq: keys per tile
  // dkdv: K, V; then two stages of Q, dO and of the rows' lse and D, whose
  // room the fp32 dK and dV partials take at the end
  static constexpr int KV_BYTES = 2 * 2 * BKV * LD;
  static constexpr int STAGE_BYTES = 2 * 4 * BQ * LD + 4 * 4 * BQ;
  static constexpr int PART_BYTES = 4 * 2 * BKV * LDF;
  static constexpr int DKDV_BYTES =
      KV_BYTES + (STAGE_BYTES > PART_BYTES ? STAGE_BYTES : PART_BYTES);
  // dq: Q, dO; two stages of K and V
  static constexpr int DQ_BYTES = 2 * (2 * BQ * LD + 4 * BK * LD);
};

// D[(b * H + h) * Sq + i] = dO[b, i, h] . o[b, i, h] in fp32: D / 8 lanes a
// row, the rows (b, i, h) in memory order.
template <int D>
__global__ void __launch_bounds__(ROWDOT_THREADS)
    flash_attention_bwd_bf16_rowdot_kernel(Args a, int64_t rows) {
  constexpr int L = D / 8;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (ROWDOT_THREADS / L) +
                      threadIdx.x / L;
  const int c = threadIdx.x % L;
  const bool ok = row < rows;
  const int64_t h = row % a.H, i = row / a.H % a.Sq, b = row / (a.H * a.Sq);
  float s = 0.f;
  if (ok) {
    const uint4 x = *reinterpret_cast<const uint4*>(
        a.o + b * a.osb + i * a.oss + h * a.osh + 8 * c);
    const uint4 y = *reinterpret_cast<const uint4*>(
        a.dout + b * a.dsb + i * a.dss + h * a.dsh + 8 * c);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
    const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s += bf16mma::lo_of(xs[e]) * bf16mma::lo_of(ys[e]) +
           bf16mma::hi_of(xs[e]) * bf16mma::hi_of(ys[e]);
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (ok && c == 0) a.dvec[(b * a.H + h) * a.Sq + i] = s;
}

// `rows` rows of D bf16 from row r0 of `src` (row stride rs) into shared
// memory at a stride of LD, by cp.async, zero-filled past row n.
template <int D>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src,
                                          int64_t rs, int64_t r0, int64_t n,
                                          int rows) {
  constexpr int C8 = D / 8, LD = Tile<D>::LD;
  for (int e = threadIdx.x; e < rows * C8; e += THREADS) {
    const int r = e / C8, c = e % C8;
    const int64_t row = r0 + r;
    const bool valid = row < n;
    cp_async16(dst + r * LD + 8 * c, src + (valid ? row : 0) * rs + 8 * c,
               valid);
  }
}

// The query tiles a dk/dv CTA at key j0 visits for each of its heads:
// n1 from qa, then the rest from s2, in steps of BQ (flash_attention_bwd.cu).
struct QueryTiles {
  int64_t qa, n1, s2, n;
  __device__ int64_t at(int64_t idx) const {
    return idx < n1 ? qa + idx * BQ : s2 + (idx - n1) * BQ;
  }
};

__device__ QueryTiles query_tiles(const Args& a, int64_t j0,
                                  int64_t nokey) {
  int64_t qa = 0, qhi = a.Sq;
  if (a.causal) {
    qa = j0 / BQ * BQ;
    if (a.window > 0 && j0 + BKV - 1 + a.window < a.Sq)
      qhi = j0 + BKV - 1 + a.window;
  }
  QueryTiles r;
  r.qa = qa;
  r.n1 = qhi > qa ? (qhi - qa + BQ - 1) / BQ : 0;
  const int64_t e1 = qa + r.n1 * BQ;
  int64_t s2 = nokey - BQ + 1;   // the first tile with i0 + BQ > nokey
  s2 = s2 > 0 ? (s2 + BQ - 1) / BQ * BQ : 0;
  r.s2 = s2 > e1 ? s2 : e1;
  r.n = r.n1 + (r.s2 < a.Sq ? (a.Sq - r.s2 + BQ - 1) / BQ : 0);
  return r;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_attention_bwd_bf16_dkdv_kernel(Args a) {
  using T = Tile<D>;
  constexpr int LD = T::LD, LDF = T::LDF, QN = T::QN, NQ = QN / 8;
  constexpr int KT = D / 8, KS = D / 16, C4 = D / 4, STAGE = BQ * LD;
  static_assert(NQ % 2 == 0 && KT % 2 == 0, "tiles taken in pairs");
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [BKV][LD]
  bf16* vs = ks + BKV * LD;                       // [BKV][LD]
  bf16* qs = vs + BKV * LD;                       // [2][BQ][LD]
  bf16* dos = qs + 2 * STAGE;                     // [2][BQ][LD]
  float* lses = reinterpret_cast<float*>(dos + 2 * STAGE);   // [2][BQ]
  float* dvs = lses + 2 * BQ;                                // [2][BQ]

  // dq, launched next, reads nothing this kernel writes: let it start on
  // the SMs this grid leaves free.
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t cid = blockIdx.x / a.cluster;
  const int64_t kvh = cid % a.KV, b = cid / a.KV % a.B;
  const int64_t j0 = cid / (a.KV * a.B) * BKV;
  const int64_t jw = j0 + 16 * warp;   // the warp's first key
  const int64_t h0 = kvh * a.G + rank * a.heads_per_rank;
  const int64_t left = a.G - rank * a.heads_per_rank;
  const int64_t nh = left < a.heads_per_rank ? left : a.heads_per_rank;
  const int64_t nokey = a.causal && a.window > 0 ? a.Skv - 1 + a.window
                                                 : a.Sq;
  const QueryTiles tiles = query_tiles(a, j0, nokey);
  const int64_t n_it = nh > 0 ? nh * tiles.n : 0;
  const float inv_skv = 1.f / static_cast<float>(a.Skv);

  copy_rows<D>(ks, a.k + b * a.ksb + kvh * a.ksh, a.kss, j0, a.Skv, BKV);
  copy_rows<D>(vs, a.v + b * a.vsb + kvh * a.vsh, a.vss, j0, a.Skv, BKV);
  auto load_tile = [&](int64_t it, int stage) {
    const int64_t h = h0 + it / tiles.n, i0 = tiles.at(it % tiles.n);
    copy_rows<D>(qs + stage * STAGE, a.q + b * a.qsb + h * a.qsh, a.qss, i0,
                 a.Sq, BQ);
    copy_rows<D>(dos + stage * STAGE, a.dout + b * a.dsb + h * a.dsh, a.dss,
                 i0, a.Sq, BQ);
    const int64_t at = (b * a.H + h) * a.Sq;
    for (int r = tid; r < BQ; r += THREADS) {
      const bool valid = i0 + r < a.Sq;
      const int64_t src = at + (valid ? i0 + r : 0);
      cp_async4(lses + stage * BQ + r, a.lse + src, valid);
      cp_async4(dvs + stage * BQ + r, a.dvec + src, valid);
    }
    cp_async_commit();
  };

  float dk[KT][4], dv[KT][4];
#pragma unroll
  for (int n = 0; n < KT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  if (n_it > 0)
    load_tile(0, 0);   // one group with the K/V tile
  else
    cp_async_commit();
  for (int64_t it = 0; it < n_it; ++it) {
    const int stage = static_cast<int>(it & 1);
    if (it + 1 < n_it)
      load_tile(it + 1, stage ^ 1);
    else
      cp_async_commit();   // an empty group keeps the wait count uniform
    cp_async_wait<1>();    // tile it has landed
    __syncthreads();

    const int64_t i0 = tiles.at(it % tiles.n);
    const bf16* qt = qs + stage * STAGE;
    const bf16* dot = dos + stage * STAGE;
    const float* lt = lses + stage * BQ;
    const float* dt = dvs + stage * BQ;
    // Causal: the 8-query columns below the warp's first key see none of
    // its keys.
    int nlo = 0;
    if (a.causal && jw > i0)
      nlo = jw - i0 >= BQ ? BQ / 8 : static_cast<int>((jw - i0) / 8);
    bool need_mask = i0 + BQ > a.Sq;
    if (a.causal)
      need_mask = need_mask || i0 < j0 + BKV - 1 ||
                  (a.window > 0 &&
                   (i0 + BQ - 1 - j0 >= a.window || i0 + BQ > nokey));
    if (jw < a.Skv && nlo < BQ / 8) {
#pragma unroll 1
      for (int q0 = 0; q0 < BQ; q0 += QN) {
        const int nlo_q = nlo - q0 / 8;   // in this pass's columns
        if (nlo_q >= NQ) continue;
        float st[NQ][4], dpt[NQ][4];
#pragma unroll
        for (int n = 0; n < NQ; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
        // S^T = K Q^T and dP^T = V dO^T over D, 16 at a step
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t ka[4], va[4];
          load_a(ka, ks, LD, 16 * warp, kk * 16, lane);
          load_a(va, vs, LD, 16 * warp, kk * 16, lane);
#pragma unroll
          for (int n = 0; n < NQ; ++n) {
            if (n < nlo_q) continue;   // masked whole: P = dS = 0 below
            uint32_t fb[2];
            load_b_nk(fb, qt, LD, q0 + n * 8, kk * 16, lane);
            mma(st[n], ka, fb);
            load_b_nk(fb, dot, LD, q0 + n * 8, kk * 16, lane);
            mma(dpt[n], va, fb);
          }
        }
        // P^T and dS^T on the accumulators: c0, c1 are key g, queries 2t
        // and 2t + 1 of the 8-query column; c2, c3 key g + 8.
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          const int qc = q0 + n * 8 + 2 * t;
          const float l0 = lt[qc] * LOG2E, l1 = lt[qc + 1] * LOG2E;
          const float d0 = dt[qc], d1 = dt[qc + 1];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = fast_exp2(st[n][e] * a.scale_log2 - (e & 1 ? l1 : l0));
            float ds = p * (dpt[n][e] - (e & 1 ? d1 : d0));
            if (need_mask) {
              const int64_t i = i0 + qc + (e & 1);
              const int64_t j = jw + g + (e & 2 ? 8 : 0);
              if (i >= a.Sq) {
                p = ds = 0.f;
              } else if (a.causal) {
                if (i >= nokey) {
                  p = inv_skv;
                  ds = 0.f;
                } else if (j > i || (a.window > 0 && i - j >= a.window)) {
                  p = ds = 0.f;
                }
              }
            }
            st[n][e] = p;
            dpt[n][e] = ds;
          }
        }
        // dV += bf16(P^T) dO and dK += bf16(dS^T) Q, 16 queries a step
#pragma unroll
        for (int n = 0; n < NQ; n += 2) {
          if (n + 1 < nlo_q) continue;
          uint32_t pa[4], sa[4];
          acc_pair_as_a(pa, st[n], st[n + 1]);
          acc_pair_as_a(sa, dpt[n], dpt[n + 1]);
#pragma unroll
          for (int nb = 0; nb < KT; nb += 2) {
            uint32_t b0[2], b1[2];
            load_b_kn_pair(b0, b1, dot, LD, q0 + n * 8, nb * 8, lane);
            mma(dv[nb], pa, b0);
            mma(dv[nb + 1], pa, b1);
            load_b_kn_pair(b0, b1, qt, LD, q0 + n * 8, nb * 8, lane);
            mma(dk[nb], sa, b0);
            mma(dk[nb + 1], sa, b1);
          }
        }
      }
    }
    __syncthreads();   // every warp is done with this Q/dO stage
  }

  // The cluster's sum: fp32 partial dK, dV into this rank's shared memory
  // (the Q/dO stages are free), then rank r sums its slice over the ranks.
  cp_async_wait<0>();
  __syncthreads();
  float* part = reinterpret_cast<float*>(qs);   // [2][BKV][LDF]: dK, dV
#pragma unroll
  for (int n = 0; n < KT; ++n) {
    const int row = 16 * warp + g, col = n * 8 + 2 * t;
    *reinterpret_cast<float2*>(part + row * LDF + col) =
        make_float2(dk[n][0], dk[n][1]);
    *reinterpret_cast<float2*>(part + (row + 8) * LDF + col) =
        make_float2(dk[n][2], dk[n][3]);
    *reinterpret_cast<float2*>(part + (BKV + row) * LDF + col) =
        make_float2(dv[n][0], dv[n][1]);
    *reinterpret_cast<float2*>(part + (BKV + row + 8) * LDF + col) =
        make_float2(dv[n][2], dv[n][3]);
  }
  cluster.sync();   // every rank's partials are written
  {
    const int total = 2 * BKV * C4;   // float4s of the dK and dV tiles
    const int lo = total * rank / a.cluster;
    const int hi = total * (rank + 1) / a.cluster;
    for (int e = lo + tid; e < hi; e += THREADS) {
      const int which = e / (BKV * C4), r = e / C4 % BKV, c = e % C4;
      const int off = (which * BKV + r) * LDF + 4 * c;
      float4 x[MAX_CLUSTER];   // every rank's loads in flight, then summed
#pragma unroll
      for (int rr = 0; rr < MAX_CLUSTER; ++rr)
        if (rr < a.cluster)
          x[rr] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(part + off, rr));
      float4 s = x[0];
#pragma unroll
      for (int rr = 1; rr < MAX_CLUSTER; ++rr) {
        if (rr >= a.cluster) break;
        s.x += x[rr].x;
        s.y += x[rr].y;
        s.z += x[rr].z;
        s.w += x[rr].w;
      }
      const int64_t j = j0 + r;
      if (j >= a.Skv) continue;
      const float w = which ? 1.f : a.scale;
      uint2 out;
      out.x = bf16mma::pack(s.x * w, s.y * w);
      out.y = bf16mma::pack(s.z * w, s.w * w);
      *reinterpret_cast<uint2*>((which ? a.dv : a.dk) +
                                ((b * a.Skv + j) * a.KV + kvh) * D + 4 * c) =
          out;
    }
  }
  cluster.sync();   // no rank leaves while another reads its partials
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_attention_bwd_bf16_dq_kernel(Args a) {
  using T = Tile<D>;
  constexpr int LD = T::LD, BK = T::BK, NK = BK / 8, KT = D / 8, KS = D / 16;
  constexpr int STAGE = BK * LD;
  static_assert(NK % 2 == 0 && KT % 2 == 0, "tiles taken in pairs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD]
  bf16* dos = qs + BQ * LD;                       // [BQ][LD]
  bf16* ks = dos + BQ * LD;                       // [2][BK][LD]
  bf16* vs = ks + 2 * STAGE;                      // [2][BK][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t b = blockIdx.x / a.H, h = blockIdx.x % a.H, kvh = h / a.G;
  // the last query tiles see the most keys: they go first
  const int64_t i0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * BQ;
  const int64_t r0 = i0 + 16 * warp;       // the warp's first row
  const int64_t ia = r0 + g, ib = ia + 8;  // the lane's two rows
  const int64_t nokey = a.causal && a.window > 0 ? a.Skv - 1 + a.window
                                                 : a.Sq;

  copy_rows<D>(qs, a.q + b * a.qsb + h * a.qsh, a.qss, i0, a.Sq, BQ);
  copy_rows<D>(dos, a.dout + b * a.dsb + h * a.dsh, a.dss, i0, a.Sq, BQ);
  // the rows' base-2 lse and D (0 past Sq, where Q and dO are 0 too)
  const int64_t at = (b * a.H + h) * a.Sq;
  const float lse_a = ia < a.Sq ? a.lse[at + ia] * LOG2E : 0.f;
  const float lse_b = ib < a.Sq ? a.lse[at + ib] * LOG2E : 0.f;
  const float d_a = ia < a.Sq ? a.dvec[at + ia] : 0.f;
  const float d_b = ib < a.Sq ? a.dvec[at + ib] : 0.f;

  // Key tiles the rows see: up to the diagonal when causal, from the
  // window's first key with one (a row that sees no key has dS = 0).
  int64_t lo = 0, hi = a.Skv;
  if (a.causal) {
    const int64_t last = (i0 + BQ < a.Sq ? i0 + BQ : a.Sq) - 1;
    hi = last + 1 < a.Skv ? last + 1 : a.Skv;
    if (a.window > 0) {
      const int64_t first = i0 - a.window + 1;
      lo = first > 0 ? first / BK * BK : 0;
    }
  }
  const bf16* kb = a.k + b * a.ksb + kvh * a.ksh;
  const bf16* vb = a.v + b * a.vsb + kvh * a.vsh;
  auto load_tile = [&](int64_t j0, int stage) {
    copy_rows<D>(ks + stage * STAGE, kb, a.kss, j0, a.Skv, BK);
    copy_rows<D>(vs + stage * STAGE, vb, a.vss, j0, a.Skv, BK);
    cp_async_commit();
  };

  float dq[KT][4];
#pragma unroll
  for (int n = 0; n < KT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  const int64_t ntiles = lo < hi ? (hi - lo + BK - 1) / BK : 0;
  if (ntiles > 0)
    load_tile(lo, 0);   // one group with Q and dO
  else
    cp_async_commit();
  for (int64_t it = 0; it < ntiles; ++it) {
    const int64_t j0 = lo + it * BK;
    const int stage = static_cast<int>(it & 1);
    if (it + 1 < ntiles)
      load_tile(j0 + BK, stage ^ 1);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const bool live =
        r0 < a.Sq && !(a.causal && j0 > r0 + 15) &&
        !(a.causal && a.window > 0 && r0 - (j0 + BK - 1) >= a.window);
    if (live) {
      const bf16* kt = ks + stage * STAGE;
      const bf16* vt = vs + stage * STAGE;
      // causal: the 8-key columns past the warp's last row are masked
      int nhi = NK;
      if (a.causal && r0 + 15 - j0 < BK - 8)
        nhi = static_cast<int>((r0 + 15 - j0) / 8) + 1;
      float s[NK][4], dp[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qa[4], oa[4];
        load_a(qa, qs, LD, 16 * warp, kk * 16, lane);
        load_a(oa, dos, LD, 16 * warp, kk * 16, lane);
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          if (n >= nhi) continue;   // masked whole: dS = 0 below
          uint32_t fb[2];
          load_b_nk(fb, kt, LD, n * 8, kk * 16, lane);
          mma(s[n], qa, fb);
          load_b_nk(fb, vt, LD, n * 8, kk * 16, lane);
          mma(dp[n], oa, fb);
        }
      }
      bool need_mask = j0 + BK > a.Skv;
      if (a.causal)
        need_mask = need_mask || j0 + BK - 1 > r0 ||
                    (a.window > 0 &&
                     (r0 + 15 - j0 >= a.window || r0 + 15 >= nokey));
      // dS on the accumulators: c0, c1 are row ia, keys 2t and 2t + 1 of
      // the 8-key column; c2, c3 row ib.
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              fast_exp2(s[n][e] * a.scale_log2 - (e & 2 ? lse_b : lse_a));
          float ds = p * (dp[n][e] - (e & 2 ? d_b : d_a));
          if (need_mask) {
            const int64_t i = e & 2 ? ib : ia;
            const int64_t j = j0 + n * 8 + 2 * t + (e & 1);
            if (j >= a.Skv ||
                (a.causal && (i >= nokey || j > i ||
                              (a.window > 0 && i - j >= a.window))))
              ds = 0.f;
          }
          s[n][e] = ds;
        }
      }
      // dQ += bf16(dS) K, 16 keys a step
#pragma unroll
      for (int n = 0; n < NK; n += 2) {
        if (n >= nhi) continue;
        uint32_t sa[4];
        acc_pair_as_a(sa, s[n], s[n + 1]);
#pragma unroll
        for (int nb = 0; nb < KT; nb += 2) {
          uint32_t b0[2], b1[2];
          load_b_kn_pair(b0, b1, kt, LD, n * 8, nb * 8, lane);
          mma(dq[nb], sa, b0);
          mma(dq[nb + 1], sa, b1);
        }
      }
    }
    __syncthreads();   // every warp is done with this K/V stage
  }
  cp_async_wait<0>();

  bf16* out = a.dq + (b * a.Sq * a.H + h) * D;
#pragma unroll
  for (int n = 0; n < KT; ++n) {
    const int c = n * 8 + 2 * t;
    if (ia < a.Sq)
      *reinterpret_cast<uint32_t*>(out + ia * a.H * D + c) =
          bf16mma::pack(dq[n][0] * a.scale, dq[n][1] * a.scale);
    if (ib < a.Sq)
      *reinterpret_cast<uint32_t*>(out + ib * a.H * D + c) =
          bf16mma::pack(dq[n][2] * a.scale, dq[n][3] * a.scale);
  }
  // Started early beside dk/dv (programmatic dependent launch): finish
  // only after it has, so that what follows on the stream finds dk and dv
  // written. A no-op when launched on its own.
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The shared-memory limit is a per-device attribute: set it once on each
// device a launch reaches, for both kernels of a head dim.
template <int D>
cudaError_t configure() {
  constexpr int MAX_DEVICES = 64;
  static bool configured[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < MAX_DEVICES && configured[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_attention_bwd_bf16_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tile<D>::DKDV_BYTES);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attention_bwd_bf16_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tile<D>::DQ_BYTES);
  if (err != cudaSuccess) return err;
  if (device < MAX_DEVICES) configured[device] = true;
  return cudaSuccess;
}

template <int D>
int launch(const Args& a, int64_t parts, cudaStream_t stream) {
  cudaError_t err = configure<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (parts & 1) {
    constexpr int RPB = ROWDOT_THREADS / (D / 8);   // rows a block
    const int64_t rows = a.B * a.Sq * a.H;
    flash_attention_bwd_bf16_rowdot_kernel<D>
        <<<static_cast<unsigned>((rows + RPB - 1) / RPB), ROWDOT_THREADS, 0,
           stream>>>(a, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (parts & 2) {
    // clusters (key tile, batch, kv head), key tile slowest: j0 = 0 first
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(
        (a.Skv + BKV - 1) / BKV * a.B * a.KV * a.cluster));
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = Tile<D>::DKDV_BYTES;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(a.cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, flash_attention_bwd_bf16_dkdv_kernel<D>, a);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (parts & 4) {
    // right after dk/dv, as its programmatic dependent: the two overlap
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(a.B * a.H),
                       static_cast<unsigned>((a.Sq + BQ - 1) / BQ));
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = Tile<D>::DQ_BYTES;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = parts & 2 ? 1 : 0;
    err = cudaLaunchKernelEx(&cfg, flash_attention_bwd_bf16_dq_kernel<D>, a);
    if (err == cudaSuccess) err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" int flash_attention_bwd_bf16_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dvec, void* dq, void* dk,
    void* dv, int64_t B, int64_t Sq, int64_t Skv, int64_t H, int64_t KV,
    int64_t D, int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
    int64_t kss, int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
    int64_t osb, int64_t oss, int64_t osh, int64_t dsb, int64_t dss,
    int64_t dsh, int64_t causal, int64_t window, int64_t parts,
    void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0 ||
      (Sq + BQ - 1) / BQ > 65535 || parts < 0 || parts > 7)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.dvec = static_cast<float*>(dvec);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.B = B;
  a.Sq = Sq;
  a.Skv = Skv;
  a.H = H;
  a.KV = KV;
  a.G = H / KV;
  a.qsb = qsb, a.qss = qss, a.qsh = qsh;
  a.ksb = ksb, a.kss = kss, a.ksh = ksh;
  a.vsb = vsb, a.vss = vss, a.vsh = vsh;
  a.osb = osb, a.oss = oss, a.osh = osh;
  a.dsb = dsb, a.dss = dss, a.dsh = dsh;
  a.causal = causal ? 1 : 0;
  a.window = window;
  // ceil(G / 8) heads a rank, so that a cluster has at most 8 ranks
  a.heads_per_rank =
      static_cast<int>((a.G + MAX_CLUSTER - 1) / MAX_CLUSTER);
  a.cluster = static_cast<int>((a.G + a.heads_per_rank - 1) /
                               a.heads_per_rank);
  a.scale = 1.f / sqrtf(static_cast<float>(D));
  a.scale_log2 = LOG2E / sqrtf(static_cast<float>(D));   // as the forward's
  const auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(a, parts, st);
    case 32:
      return launch<32>(a, parts, st);
    case 64:
      return launch<64>(a, parts, st);
    case 128:
      return launch<128>(a, parts, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
