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
// Design (Hopper: TMA, mbarriers, wgmma; hopper_bf16.cuh), three kernels
// on one stream, deterministic (no atomics):
//   1. rows: one table entry per row of a query tile, in the tiles' row
//      order (below): log2(e) lse and D = dO . o (fp32, D / 8 lanes a row,
//      a fixed shuffle order), 64 + 64 floats a tile, +inf and 0 for a row
//      past Sq or past the tile's G x QB rows, so that such a row's P is 0
//      with no mask; one bulk copy brings a tile's 512 bytes.
//   2. dk/dv: the G query heads of a kv head are folded into the rows of a
//      query tile, as in the forward: row r = (i - i_first) G + (h - kvh G)
//      for QB = 64 / G queries i_first.. (one TMA box of 64 values of D by
//      the G heads by the QB queries, zeros past Sq). A CTA owns 64 keys
//      of a kv head: a producer warp loads its K and V once by TMA and
//      streams the query tiles' Q, dO and table rows through a ring of two
//      stages (`full`/`empty` mbarriers); one consumer warpgroup runs
//      S^T = K Q^T and dP^T = V dO^T as wgmma with both operands K-major
//      from shared memory, P^T and dS^T on the fp32 accumulators with the
//      masks, then dV += bf16(P^T) dO and dK += bf16(dS^T) Q with the
//      register A operand (`acc_pair_as_a`) and dO or Q an MN-major B.
//      Folding the heads into the rows sums dK and dV over the G heads in
//      the accumulators, so K and V are loaded once a kv head and no CTA
//      holds a copy of them per query head (a cluster of one rank a query
//      head would load K and V G times and meet through an fp32 DSMEM sum
//      of G partials). The tiles a CTA visits are split in order over the C ranks of a
//      thread-block cluster, C = the card's CTA slots (132 SMs, two CTAs
//      an SM at D <= 64) / (key tiles x KV x B), clamped to 1..8 and to
//      the tiles, so that a shape with few key tiles still fills the card
//      (the trainer's: 32 CTAs of 15 or 8 tiles at C = 1; 256 of one or
//      two at C = 8); the ranks' fp32 partials meet in shared memory and
//      rank r sums its 1/C slice over ranks 0, 1, ..., C - 1 in that order
//      (distributed shared memory), scales, rounds and writes it. At the
//      cross shape (1024 CTAs) C = 1 and each CTA writes its own rows.
//      The epilogue is one straight loop for each case of a tile (no mask;
//      causal only; a window or rows that see no key) with 32-bit index
//      steps: a 64-bit division or a per-element branch between the cases
//      took it from about 1.2k to 2.5k-10k cycles a tile on an H100
//      (tools/kernel_phases.py flash_bwd_bf16_phases).
//   3. dq: one CTA per (query tile, kv head, batch), the forward's
//      geometry: the producer loads the tile's Q and dO once and streams
//      the K/V tiles it sees; the consumers form S = Q K^T and
//      dP = dO V^T again (both K-major), dS on the accumulators, and
//      dQ += bf16(dS) K with K an MN-major B. Forming S and dP a second
//      time costs 7/5 of the bound's products but needs no shared state:
//      the alternative, dQ from a dS tile in shared memory summed over the
//      key tiles in a fixed order behind a counter, adds a global fp32
//      round trip of dQ per key tile and a serial wait per query tile; at
//      the trainer's shape the products are 0.6 us of tensor time and the
//      kernel is latency. Launched as dk/dv's programmatic dependent, so
//      the two overlap.
// Ragged tiles are whole tiles with TMA's zeros (wgmma's N is fixed); rows
// of a stage past the tile's G x QB rows are zeroed once (TMA writes only
// the box). The tensor maps are prefetched and the barriers armed before
// the first wait. D is 16, 32, 64 or 128 (a head dim under 64 fills the
// 64-wide tiles with TMA's zeros), at most 64 query heads a kv head.
//
// C interface: launches on the given stream, does not synchronise,
// allocates nothing (the wrapper passes the row table, B x KV x tiles x 128
// fp32, as `dvec`) and returns the first non-zero error. `parts` picks the
// kernels (1 rows, 2 dkdv, 4 dq; 7 all), so that each can be timed alone.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>
#include <math.h>
#include <type_traits>

#include "hopper_bf16.cuh"
#include "mma_tf32x3.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hopper::Wgmma;
using tf32x3::fast_exp2;

constexpr int THREADS = 160;   // one consumer warpgroup, one producer warp
constexpr int ROWS_THREADS = 256;
constexpr int BM = 64;         // rows of a query tile; keys of a K/V tile
constexpr int NS = 2;          // stages of a ring
constexpr int BLK = 64 * 128;  // bytes of a [64][64] bf16 tile
constexpr int TAB = 2 * BM;    // floats of a tile's table rows
constexpr int MAX_CLUSTER = 8;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const bf16 *o, *dout;
  const float* lse;
  float* tab;   // (B, KV, NQT, 2, 64): log2(e) lse, then D
  bf16 *dq, *dk, *dv;
  int64_t B, Sq, Skv, H, KV;
  int64_t osb, oss, osh, dsb, dss, dsh;
  int G, QB, NQT, cluster, causal;
  int64_t window;
  float scale, scale_log2;
};

// Rows with no key see none (only with a window); beyond Sq otherwise.
__device__ __forceinline__ int64_t no_key_row(const Args& a) {
  return a.causal && a.window > 0 ? a.Skv - 1 + a.window : a.Sq;
}

// The table: for row r of query tile qt of (b, kvh), query i = qt QB + r / G
// of head kvh G + r % G: log2(e) lse and dO . o, D / 8 lanes a row.
template <int D>
__global__ void __launch_bounds__(ROWS_THREADS)
    flash_attention_bwd_bf16_rows_kernel(Args a, int64_t rows) {
  constexpr int L = D / 8;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (ROWS_THREADS / L) +
                      threadIdx.x / L;
  const int c = threadIdx.x % L;
  const int r = static_cast<int>(row % BM);
  const int64_t tile = row / BM;   // ((b KV + kvh) NQT + qt)
  const int64_t qt = tile % a.NQT, kvh = tile / a.NQT % a.KV;
  const int64_t b = tile / (a.NQT * a.KV);
  const int64_t i = qt * a.QB + r / a.G, h = kvh * a.G + r % a.G;
  const bool ok = row < rows && r < a.G * a.QB && i < a.Sq;
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
      s += hopper::lo_of(xs[e]) * hopper::lo_of(ys[e]) +
           hopper::hi_of(xs[e]) * hopper::hi_of(ys[e]);
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row < rows && c == 0) {
    a.tab[tile * TAB + r] =
        ok ? a.lse[(b * a.H + h) * a.Sq + i] * LOG2E : INFINITY;
    a.tab[tile * TAB + BM + r] = s;
  }
}

// The query tiles a dk/dv CTA at key j0 visits: n1 from qa, then the rest
// from s2 (tiles holding rows that see no key), in steps of QB queries.
struct QueryTiles {
  int qa, n1, s2, n;
  __device__ int at(int idx, int QB) const {
    return idx < n1 ? qa + idx * QB : s2 + (idx - n1) * QB;
  }
};

// (32-bit divisions: Sq, Skv and the window's reach are below 2^31, and a
// 64-bit division cost the set-up thousands of cycles)
__device__ QueryTiles query_tiles(const Args& a, int64_t j0) {
  const int QB = a.QB, sq = static_cast<int>(a.Sq), j = static_cast<int>(j0);
  const int64_t nk64 = no_key_row(a);
  const int nokey = static_cast<int>(nk64 < (1 << 30) ? nk64 : (1 << 30));
  int qa = 0, qhi = sq;
  if (a.causal) {
    qa = j / QB * QB;
    if (a.window > 0 && j0 + BM - 1 + a.window < a.Sq)
      qhi = static_cast<int>(j0 + BM - 1 + a.window);
  }
  QueryTiles r;
  r.qa = qa;
  r.n1 = qhi > qa ? (qhi - qa + QB - 1) / QB : 0;
  const int e1 = qa + r.n1 * QB;
  int s2 = nokey - QB + 1;   // the first tile with i0 + QB > nokey
  s2 = s2 > 0 ? (s2 + QB - 1) / QB * QB : 0;
  r.s2 = s2 > e1 ? s2 : e1;
  r.n = r.n1 + (r.s2 < sq ? (sq - r.s2 + QB - 1) / QB : 0);
  return r;
}

// Rows rows..63 of `n` 64-row tiles (bf16, 128 bytes a row) to zero, then
// visible to TMA and wgmma.
__device__ __forceinline__ void zero_rows(unsigned char* const* tiles, int n,
                                          int rows, int tid) {
  if (rows >= BM) return;
  const int per = (BM - rows) * 8;   // 16-byte units a tile
  for (int e = tid; e < n * per; e += THREADS)
    *reinterpret_cast<uint4*>(tiles[e / per] + rows * 128 + (e % per) * 16) =
        make_uint4(0, 0, 0, 0);
  hopper::fence_async_smem();
}

template <int D>
struct DkdvSmem {
  static constexpr int DB = D <= 64 ? 1 : 2;   // column blocks of D
  static constexpr int LDF = D + 4;            // fp32 partial rows
  unsigned char k[DB][BLK];
  unsigned char v[DB][BLK];
  struct __align__(1024) Stage {
    unsigned char q[DB][BLK];
    unsigned char dout[DB][BLK];
    float tab[TAB];
  };
  Stage stage[NS];
  uint64_t kvbar, full[NS], empty[NS];
};

template <int D>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 2 : 1)
    flash_attention_bwd_bf16_dkdv_kernel(
        const __grid_constant__ CUtensorMap map_q,
        const __grid_constant__ CUtensorMap map_k,
        const __grid_constant__ CUtensorMap map_v,
        const __grid_constant__ CUtensorMap map_do, const Args a) {
  using S = DkdvSmem<D>;
  constexpr int DB = S::DB, DK = D / 16, KT = D / 8, LDF = S::LDF;
  static_assert(sizeof(float) * 2 * BM * LDF <= offsetof(S, kvbar),
                "the partials fit below the barriers");
  namespace cg = cooperative_groups;
  extern __shared__ unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023));

  // dq, launched next, reads nothing this kernel writes: let it start on
  // the SMs this grid leaves free.
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  cg::cluster_group cluster = cg::this_cluster();
  // (32-bit index arithmetic throughout the set-up: its 64-bit divisions
  // cost thousands of cycles a CTA)
  const int C = a.cluster, rank = static_cast<int>(cluster.block_rank());
  const int cid = static_cast<int>(blockIdx.x) / C;
  const int KV = static_cast<int>(a.KV), nb = static_cast<int>(a.B);
  const int kvh = cid % KV, b = cid / KV % nb;
  const int64_t j0 = static_cast<int64_t>(cid / (KV * nb)) * BM;
  const int G = a.G, QB = a.QB, rows = G * QB;
  const QueryTiles tiles = query_tiles(a, j0);
  const int first = tiles.n * rank / C;
  const int n_it = tiles.n * (rank + 1) / C - first;

  // Query tile it of this rank into stage it % NS.
  const auto load_tile = [&](int it) {
    const int s = it % NS;
    const int i_first = tiles.at(first + it, QB);
    auto& stg = sm.stage[s];
    hopper::mbar_arrive_expect_tx(&sm.full[s],
                                  2 * DB * rows * 128 + TAB * 4);
    for (int db = 0; db < DB; ++db) {
      hopper::tma_load_4d(stg.q[db], &map_q, &sm.full[s], 64 * db, kvh * G,
                          i_first, b);
      hopper::tma_load_4d(stg.dout[db], &map_do, &sm.full[s], 64 * db,
                          kvh * G, i_first, b);
    }
    hopper::bulk_load(stg.tab,
                      a.tab + (static_cast<int64_t>(b * KV + kvh) * a.NQT +
                               i_first / QB) * TAB,
                      TAB * 4, &sm.full[s]);
  };
  if (tid == 4 * 32) {
    // The producer's lane: the barriers, then K, V and the first tiles at
    // once, while the other threads set up.
    hopper::prefetch_map(&map_q);
    hopper::prefetch_map(&map_k);
    hopper::prefetch_map(&map_v);
    hopper::prefetch_map(&map_do);
    hopper::mbar_init(&sm.kvbar, 1);
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&sm.full[s], 1);
      hopper::mbar_init(&sm.empty[s], 4);   // the consumer's warps
    }
    hopper::fence_barrier_init();
    hopper::mbar_arrive_expect_tx(&sm.kvbar, 2 * DB * BLK);
    for (int db = 0; db < DB; ++db) {
      hopper::tma_load_4d(sm.k[db], &map_k, &sm.kvbar, 64 * db, kvh,
                          static_cast<int>(j0), b);
      hopper::tma_load_4d(sm.v[db], &map_v, &sm.kvbar, 64 * db, kvh,
                          static_cast<int>(j0), b);
    }
    for (int it = 0; it < NS && it < n_it; ++it) load_tile(it);
  }
  {
    unsigned char* zt[2 * NS * DB];
    for (int s = 0; s < NS; ++s)
      for (int db = 0; db < DB; ++db) {
        zt[(2 * s) * DB + db] = sm.stage[s].q[db];
        zt[(2 * s + 1) * DB + db] = sm.stage[s].dout[db];
      }
    zero_rows(zt, 2 * NS * DB, rows, tid);
  }
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g, r1 = r0 + 8;   // the lane's two keys
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dk[e] = dv[e] = 0.f;

  if (warp == 4) {
    // ---- producer: the rest of the ring --------------------------------
    if (lane == 0)
      for (int it = NS; it < n_it; ++it) {
        hopper::mbar_wait(&sm.empty[it % NS], ((it / NS) - 1) & 1);
        load_tile(it);
      }
  } else {
    // ---- consumer warpgroup: rows are the CTA's 64 keys ----------------
    const int64_t nokey = no_key_row(a);
    const float inv_skv = 1.f / static_cast<float>(a.Skv);
    // A tile row c's query offset in the tile, c / G, is (c recip) >> 16
    // for c < 64 (exact: G <= 64); the masks take int32 steps relative to
    // j0 (a 64-bit division per element made every tile's epilogue three
    // to ten times slower).
    const int recip = (65536 + G - 1) / G;
    const int win = a.window > 0 ? (a.window < (1 << 30)
                                        ? static_cast<int>(a.window)
                                        : (1 << 30))
                                 : 0;
    hopper::mbar_wait(&sm.kvbar, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % NS;
      const int64_t i_first = tiles.at(first + it, QB);
      const int64_t i_last = (i_first + QB < a.Sq ? i_first + QB : a.Sq) - 1;
      hopper::mbar_wait(&sm.full[s], (it / NS) & 1);
      const auto& stg = sm.stage[s];

      float st[BM / 2], dpt[BM / 2];   // S^T, dP^T: keys x rows
      hopper::wg_fence();
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        Wgmma<BM>::ss<0, 0>(st, hopper::desc_k(sm.k[0], kk, BLK),
                            hopper::desc_k(stg.q[0], kk, BLK), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        Wgmma<BM>::ss<0, 0>(dpt, hopper::desc_k(sm.v[0], kk, BLK),
                            hopper::desc_k(stg.dout[0], kk, BLK), kk > 0);
      hopper::wg_commit();
      hopper::wg_wait<0>();
      hopper::fence_regs(st);
      hopper::fence_regs(dpt);

      // P^T and dS^T: d[4j + e] is key r0 (e < 2) or r1, tile row
      // c = 8j + 2t + (e & 1). Rows past the tile's have P = 0 by their
      // table entry; the masks only where a pair of the tile can be one,
      // relative to j0: row c's query i_first + cq - j0 against key r.
      // Causal alone (no window, no row that sees no key): a pair is cut
      // where its key passes its query, and a row past the tile's or past
      // Sq has P = 0 already. Otherwise the general masks.
      const bool general = a.window > 0 || i_last >= nokey;
      const bool need_mask =
          a.causal && (i_first < j0 + BM - 1 || general);
      const int di = static_cast<int>(i_first - j0);
      const int sq = static_cast<int>(a.Sq - j0);
      const int nk = static_cast<int>(nokey - j0);
      // one straight loop for each of the three cases (a per-element
      // branch between them cost the epilogue some 2k cycles a tile)
      const auto epilogue = [&](auto mode_const) {
        constexpr int MODE = decltype(mode_const)::value;   // 0, 1, 2
#pragma unroll
        for (int j = 0; j < BM / 8; ++j) {
          const float2 lj =
              *reinterpret_cast<const float2*>(stg.tab + 8 * j + 2 * t);
          const float2 dd = *reinterpret_cast<const float2*>(
              stg.tab + BM + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int u = e & 1;
            float p = fast_exp2(st[4 * j + e] * a.scale_log2 -
                                (u ? lj.y : lj.x));
            float ds = p * (dpt[4 * j + e] - (u ? dd.y : dd.x));
            if (MODE > 0) {
              const int cq = ((8 * j + 2 * t + u) * recip) >> 16;
              const int i = di + cq, r = e < 2 ? r0 : r1;
              if (MODE == 1) {
                p = r > i ? 0.f : p;
                ds = r > i ? 0.f : ds;
              } else {
                const bool row = cq < QB && i < sq;
                const bool blind = row && i >= nk;
                const bool cut = r > i || (win > 0 && i - r >= win);
                p = blind ? inv_skv : (row && cut ? 0.f : p);
                ds = blind || (row && cut) ? 0.f : ds;
              }
            }
            st[4 * j + e] = p;
            dpt[4 * j + e] = ds;
          }
        }
      };
      if (!need_mask)
        epilogue(std::integral_constant<int, 0>{});
      else if (!general)
        epilogue(std::integral_constant<int, 1>{});
      else
        epilogue(std::integral_constant<int, 2>{});
      uint32_t pa[BM / 16][4], sa[BM / 16][4];
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        hopper::acc_pair_as_a(pa[kk], st, kk);
        hopper::acc_pair_as_a(sa[kk], dpt, kk);
      }
      hopper::wg_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        Wgmma<D>::template rs<1>(dv, pa[kk],
                                 hopper::desc_mn(stg.dout[0], kk, BLK), 1);
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        Wgmma<D>::template rs<1>(dk, sa[kk],
                                 hopper::desc_mn(stg.q[0], kk, BLK), 1);
      hopper::wg_commit();
      hopper::wg_wait<0>();
      hopper::fence_regs(dk);
      hopper::fence_regs(dv);
      if (lane == 0) hopper::mbar_arrive(&sm.empty[s]);
    }
  }

  const int64_t kvrow = static_cast<int64_t>(b) * a.Skv;
  if (C == 1) {
    // one rank: each consumer lane writes its rows
    if (warp < 4) {
#pragma unroll
      for (int nt = 0; nt < KT; ++nt) {
        const int c = 8 * nt + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int64_t j = j0 + (half ? r1 : r0);
          if (j >= a.Skv) continue;
          const int64_t at = ((kvrow + j) * a.KV + kvh) * D + c;
          *reinterpret_cast<uint32_t*>(a.dk + at) =
              hopper::pack(dk[4 * nt + 2 * half] * a.scale,
                           dk[4 * nt + 2 * half + 1] * a.scale);
          *reinterpret_cast<uint32_t*>(a.dv + at) = hopper::pack(
              dv[4 * nt + 2 * half], dv[4 * nt + 2 * half + 1]);
        }
      }
    }
    return;
  }

  // The cluster's sum: fp32 partial dK, dV over this rank's shared memory
  // (every tile is consumed), then rank r sums its slice over the ranks
  // (loads of every rank's partials; pushing each partial to its rank by
  // stores instead took the sum from 8k to 13k cycles a CTA on an H100).
  __syncthreads();
  float* part = reinterpret_cast<float*>(&sm);   // [2][BM][LDF]: dK, dV
  if (warp < 4) {
#pragma unroll
    for (int nt = 0; nt < KT; ++nt) {
      const int col = 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(part + r0 * LDF + col) =
          make_float2(dk[4 * nt], dk[4 * nt + 1]);
      *reinterpret_cast<float2*>(part + r1 * LDF + col) =
          make_float2(dk[4 * nt + 2], dk[4 * nt + 3]);
      *reinterpret_cast<float2*>(part + (BM + r0) * LDF + col) =
          make_float2(dv[4 * nt], dv[4 * nt + 1]);
      *reinterpret_cast<float2*>(part + (BM + r1) * LDF + col) =
          make_float2(dv[4 * nt + 2], dv[4 * nt + 3]);
    }
  }
  cluster.sync();   // every rank's partials are written
  {
    constexpr int C4 = D / 4;
    const int total = 2 * BM * C4;   // float4s of the dK and dV tiles
    const int lo = total * rank / C, hi = total * (rank + 1) / C;
    for (int e = lo + tid; e < hi; e += THREADS) {
      const int which = e / (BM * C4), r = e / C4 % BM, c = e % C4;
      const int off = (which * BM + r) * LDF + 4 * c;
      float4 x[MAX_CLUSTER];   // every rank's loads in flight, then summed
#pragma unroll
      for (int rr = 0; rr < MAX_CLUSTER; ++rr)
        if (rr < C)
          x[rr] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(part + off, rr));
      float4 sum = x[0];
#pragma unroll
      for (int rr = 1; rr < MAX_CLUSTER; ++rr) {
        if (rr >= C) break;
        sum.x += x[rr].x;
        sum.y += x[rr].y;
        sum.z += x[rr].z;
        sum.w += x[rr].w;
      }
      const int64_t j = j0 + r;
      if (j >= a.Skv) continue;
      const float w = which ? 1.f : a.scale;
      uint2 out;
      out.x = hopper::pack(sum.x * w, sum.y * w);
      out.y = hopper::pack(sum.z * w, sum.w * w);
      *reinterpret_cast<uint2*>((which ? a.dv : a.dk) +
                                ((kvrow + j) * a.KV + kvh) * D + 4 * c) = out;
    }
  }
  cluster.sync();   // no rank leaves while another reads its partials
}

template <int D>
struct DqSmem {
  static constexpr int DB = D <= 64 ? 1 : 2;
  unsigned char q[DB][BLK];
  unsigned char dout[DB][BLK];
  struct __align__(1024) Stage {
    unsigned char k[DB][BLK];
    unsigned char v[DB][BLK];
  };
  Stage stage[NS];
  uint64_t qbar, full[NS], empty[NS];
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_bwd_bf16_dq_kernel(
        const __grid_constant__ CUtensorMap map_q,
        const __grid_constant__ CUtensorMap map_k,
        const __grid_constant__ CUtensorMap map_v,
        const __grid_constant__ CUtensorMap map_do, const Args a) {
  using S = DqSmem<D>;
  constexpr int DB = S::DB, DK = D / 16, NT = BM / 8, KT = D / 8;
  extern __shared__ unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the last query tiles see the most keys: they go first
  const int qt = static_cast<int>(gridDim.x - 1 - blockIdx.x);
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.G, QB = a.QB, rows = G * QB;
  const int64_t i_first = static_cast<int64_t>(qt) * QB;
  const int64_t i_last = (i_first + QB < a.Sq ? i_first + QB : a.Sq) - 1;
  const int64_t nokey = no_key_row(a);

  // Key tiles the rows see: up to the diagonal when causal, from the
  // window's first key with one (a row that sees no key has dS = 0).
  int64_t lo = 0, hi = a.Skv;
  if (a.causal) {
    hi = i_last + 1 < a.Skv ? i_last + 1 : a.Skv;
    if (a.window > 0) {
      const int64_t f = i_first - a.window + 1;
      lo = f > 0 ? f / BM * BM : 0;
    }
  }
  const int ntiles = lo < hi ? static_cast<int>((hi - lo + BM - 1) / BM) : 0;

  const auto load_tile = [&](int it) {
    const int s = it % NS;
    hopper::mbar_arrive_expect_tx(&sm.full[s], 2 * DB * BLK);
    const int j0 = static_cast<int>(lo) + it * BM;
    for (int db = 0; db < DB; ++db) {
      hopper::tma_load_4d(sm.stage[s].k[db], &map_k, &sm.full[s], 64 * db,
                          kvh, j0, b);
      hopper::tma_load_4d(sm.stage[s].v[db], &map_v, &sm.full[s], 64 * db,
                          kvh, j0, b);
    }
  };
  if (tid == 4 * 32) {
    hopper::prefetch_map(&map_q);
    hopper::prefetch_map(&map_k);
    hopper::prefetch_map(&map_v);
    hopper::prefetch_map(&map_do);
    hopper::mbar_init(&sm.qbar, 1);
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&sm.full[s], 1);
      hopper::mbar_init(&sm.empty[s], 4);
    }
    hopper::fence_barrier_init();
    hopper::mbar_arrive_expect_tx(&sm.qbar,
                                  static_cast<uint32_t>(2 * DB * rows * 128));
    for (int db = 0; db < DB; ++db) {
      hopper::tma_load_4d(sm.q[db], &map_q, &sm.qbar, 64 * db, kvh * G,
                          static_cast<int>(i_first), b);
      hopper::tma_load_4d(sm.dout[db], &map_do, &sm.qbar, 64 * db, kvh * G,
                          static_cast<int>(i_first), b);
    }
    for (int it = 0; it < NS && it < ntiles; ++it) load_tile(it);
  }
  {
    unsigned char* zt[2 * DB];
    for (int db = 0; db < DB; ++db) {
      zt[db] = sm.q[db];
      zt[DB + db] = sm.dout[db];
    }
    zero_rows(zt, 2 * DB, rows, tid);
  }
  __syncthreads();

  if (warp == 4) {
    if (lane == 0)
      for (int it = NS; it < ntiles; ++it) {
        hopper::mbar_wait(&sm.empty[it % NS], ((it / NS) - 1) & 1);
        load_tile(it);
      }
  } else {
    const int g = lane >> 2, t = lane & 3;
    const int r0 = 16 * warp + g, r1 = r0 + 8;   // the lane's two rows
    const int64_t i0 = i_first + r0 / G, i1 = i_first + r1 / G;
    const float* tab =
        a.tab + ((static_cast<int64_t>(b) * a.KV + kvh) * a.NQT + qt) * TAB;
    const float l0 = tab[r0], l1 = tab[r1];
    const float d0 = tab[BM + r0], d1 = tab[BM + r1];
    float acc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;

    hopper::mbar_wait(&sm.qbar, 0);
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % NS;
      const int64_t j0 = lo + static_cast<int64_t>(it) * BM;
      hopper::mbar_wait(&sm.full[s], (it / NS) & 1);
      const auto& stg = sm.stage[s];

      float sf[BM / 2], dp[BM / 2];   // S, dP: column tile j at [4j..4j+3]
      hopper::wg_fence();
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        Wgmma<BM>::ss<0, 0>(sf, hopper::desc_k(sm.q[0], kk, BLK),
                            hopper::desc_k(stg.k[0], kk, BLK), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        Wgmma<BM>::ss<0, 0>(dp, hopper::desc_k(sm.dout[0], kk, BLK),
                            hopper::desc_k(stg.v[0], kk, BLK), kk > 0);
      hopper::wg_commit();
      hopper::wg_wait<0>();
      hopper::fence_regs(sf);
      hopper::fence_regs(dp);

      const bool need_mask =
          j0 + BM > a.Skv ||
          (a.causal && (j0 + BM - 1 > i_first ||
                        (a.window > 0 && i_last - j0 >= a.window) ||
                        i_last >= nokey));
      // In tile columns c: keys end at `left`; row i sees lo_i <= c <= hi_i
      // (causal: c <= i - j0, and with a window c > i - j0 - window); a
      // row that sees no key, none.
      const int left = static_cast<int>(a.Skv - j0 < BM ? a.Skv - j0 : BM);
      int hi0 = BM, hi1 = BM, lo0 = -1, lo1 = -1;
      if (a.causal) {
        const int64_t e0 = i0 - j0, e1 = i1 - j0;
        hi0 = i0 >= nokey ? -1 : static_cast<int>(e0 < BM ? e0 : BM);
        hi1 = i1 >= nokey ? -1 : static_cast<int>(e1 < BM ? e1 : BM);
        if (a.window > 0) {
          const int64_t f0 = e0 - a.window + 1, f1 = e1 - a.window + 1;
          lo0 = static_cast<int>(f0 > -1 ? (f0 < BM ? f0 : BM) : -1);
          lo1 = static_cast<int>(f1 > -1 ? (f1 < BM ? f1 : BM) : -1);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              fast_exp2(sf[4 * j + e] * a.scale_log2 - (e < 2 ? l0 : l1));
          float ds = p * (dp[4 * j + e] - (e < 2 ? d0 : d1));
          if (need_mask) {
            const int c = 8 * j + 2 * t + (e & 1);
            if (c >= left || c > (e < 2 ? hi0 : hi1) ||
                c < (e < 2 ? lo0 : lo1))
              ds = 0.f;
          }
          dp[4 * j + e] = ds;
        }
      }
      uint32_t sa[BM / 16][4];
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        hopper::acc_pair_as_a(sa[kk], dp, kk);
      hopper::wg_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        Wgmma<D>::template rs<1>(acc, sa[kk],
                                 hopper::desc_mn(stg.k[0], kk, BLK), 1);
      hopper::wg_commit();
      hopper::wg_wait<0>();
      hopper::fence_regs(acc);
      if (lane == 0) hopper::mbar_arrive(&sm.empty[s]);
    }

    const bool ok0 = r0 < rows && i0 < a.Sq, ok1 = r1 < rows && i1 < a.Sq;
    const int64_t h0 = static_cast<int64_t>(kvh) * G + r0 % G;
    const int64_t h1 = static_cast<int64_t>(kvh) * G + r1 % G;
    bf16* q0 = a.dq + ((b * a.Sq + i0) * a.H + h0) * D;
    bf16* q1 = a.dq + ((b * a.Sq + i1) * a.H + h1) * D;
#pragma unroll
    for (int nt = 0; nt < KT; ++nt) {
      const int c = 8 * nt + 2 * t;
      if (ok0)
        *reinterpret_cast<uint32_t*>(q0 + c) =
            hopper::pack(acc[4 * nt] * a.scale, acc[4 * nt + 1] * a.scale);
      if (ok1)
        *reinterpret_cast<uint32_t*>(q1 + c) = hopper::pack(
            acc[4 * nt + 2] * a.scale, acc[4 * nt + 3] * a.scale);
    }
  }
  // Started early beside dk/dv (programmatic dependent launch): finish
  // only after it has, so that what follows on the stream finds dk and dv
  // written. A no-op when launched on its own.
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <int D>
int launch(const void* q, const void* k, const void* v, const Args& a,
           const int64_t* qst, const int64_t* kst, const int64_t* vst,
           const int64_t* dst, int64_t parts, cudaStream_t stream) {
  int err = 0;
  if (parts & 1) {
    constexpr int RPB = ROWS_THREADS / (D / 8);   // rows a block
    const int64_t rows = a.B * a.KV * a.NQT * BM;
    flash_attention_bwd_bf16_rows_kernel<D>
        <<<static_cast<unsigned>((rows + RPB - 1) / RPB), ROWS_THREADS, 0,
           stream>>>(a, rows);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  if (!(parts & 6)) return 0;
  // q and dO (B, Sq, H, D) as (D, H, Sq, B), their box the G heads of a kv
  // head by QB queries; k and v (B, Skv, KV, D) as (D, KV, Skv, B), 64 keys
  CUtensorMap mq, mk, mv, mdo;
  const int64_t qd[4] = {D, a.H, a.Sq, a.B}, kd[4] = {D, a.KV, a.Skv, a.B};
  const int qbox[4] = {64, a.G, a.QB, 1}, kbox[4] = {64, 1, BM, 1};
  err = hopper::make_map(&mq, q, 4, qd, qst, qbox);
  if (err == 0) err = hopper::make_map(&mdo, a.dout, 4, qd, dst, qbox);
  if (err == 0) err = hopper::make_map(&mk, k, 4, kd, kst, kbox);
  if (err == 0) err = hopper::make_map(&mv, v, 4, kd, vst, kbox);
  if (err != 0) return err;
  if (parts & 2) {
    const int smem = static_cast<int>(sizeof(DkdvSmem<D>)) + 1024;
    err = hopper::allow_smem<flash_attention_bwd_bf16_dkdv_kernel<D>>(smem);
    if (err != 0) return err;
    // clusters (key tile, batch, kv head), key tile slowest: j0 = 0 first
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(
        (a.Skv + BM - 1) / BM * a.B * a.KV * a.cluster));
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(a.cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t e = cudaLaunchKernelEx(
        &cfg, flash_attention_bwd_bf16_dkdv_kernel<D>, mq, mk, mv, mdo, a);
    if (e == cudaSuccess) e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (parts & 4) {
    const int smem = static_cast<int>(sizeof(DqSmem<D>)) + 1024;
    err = hopper::allow_smem<flash_attention_bwd_bf16_dq_kernel<D>>(smem);
    if (err != 0) return err;
    // right after dk/dv, as its programmatic dependent: the two overlap
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(a.NQT),
                       static_cast<unsigned>(a.KV),
                       static_cast<unsigned>(a.B));
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = parts & 2 ? 1 : 0;
    cudaError_t e = cudaLaunchKernelEx(
        &cfg, flash_attention_bwd_bf16_dq_kernel<D>, mq, mk, mv, mdo, a);
    if (e == cudaSuccess) e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
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
  // TMA reads q, k, v and dO: 16-byte aligned bases, strides in multiples
  // of 8 values (the wrapper's rule); the rows kernel reads o and dO by
  // 16 bytes
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0 ||
      H / KV > BM || KV > 65535 || B > 65535 || parts < 0 || parts > 7 ||
      !aligned(q) || !aligned(k) || !aligned(v) || !aligned(o) ||
      !aligned(dout) || !aligned(dvec) || qsb % 8 || qss % 8 || qsh % 8 ||
      ksb % 8 || kss % 8 || ksh % 8 || vsb % 8 || vss % 8 || vsh % 8 ||
      osb % 8 || oss % 8 || osh % 8 || dsb % 8 || dss % 8 || dsh % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.tab = static_cast<float*>(dvec);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.B = B;
  a.Sq = Sq;
  a.Skv = Skv;
  a.H = H;
  a.KV = KV;
  a.osb = osb, a.oss = oss, a.osh = osh;
  a.dsb = dsb, a.dss = dss, a.dsh = dsh;
  a.G = static_cast<int>(H / KV);
  a.QB = BM / a.G;
  a.NQT = static_cast<int>((Sq + a.QB - 1) / a.QB);
  a.causal = causal ? 1 : 0;
  a.window = window;
  // ranks a dk/dv cluster: enough CTAs for the card's 132 SMs (two an SM
  // at D <= 64), at most 8 and at most the query tiles
  const int64_t ctas = (Skv + BM - 1) / BM * B * KV;
  int64_t c = (D <= 64 ? 264 : 132) / ctas;
  c = c < 1 ? 1 : (c > MAX_CLUSTER ? MAX_CLUSTER : c);
  a.cluster = static_cast<int>(c < a.NQT ? c : a.NQT);
  a.scale = 1.f / sqrtf(static_cast<float>(D));
  a.scale_log2 = LOG2E / sqrtf(static_cast<float>(D));   // as the forward's
  const int64_t qst[3] = {qsh, qss, qsb}, kst[3] = {ksh, kss, ksb};
  const int64_t vst[3] = {vsh, vss, vsb}, dst[3] = {dsh, dss, dsb};
  const auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, a, qst, kst, vst, dst, parts, st);
    case 32:
      return launch<32>(q, k, v, a, qst, kst, vst, dst, parts, st);
    case 64:
      return launch<64>(q, k, v, a, qst, kst, vst, dst, parts, st);
    case 128:
      return launch<128>(q, k, v, a, qst, kst, vst, dst, parts, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
