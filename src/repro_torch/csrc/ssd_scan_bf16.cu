// Chunked SSD scan (Mamba-2) on bf16 x, dt, B and C (A fp32): the
// function of csrc/ssd_scan.cu, with y in bf16 and the state, the final
// state and the chunks' start states in fp32. Per head, with the state S
// (p, n) starting at the given fp32 initial state (or zero) and cum the
// within-chunk cumulative sum of dt * A (fp32):
//   y[t]   = sum_{s <= t in chunk} (C_t . B_s) L_ts dt_s x_s + e_t S' C_t
//   S     <- S exp(cum_end) + sum_s (dt_s w_s x_s) B_s^T
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
// einsum's output; dt_s w_s x_s is rounded once as an operand; and a
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
// final state in fp32) about 7.6 MB, 2.3 us at 3.35 TB/s: bytes. At 72
// blocks of two chunks each the time is the chain of dependent steps of
// one block, not either bound.
//
// Design (Hopper: TMA, mbarriers, wgmma; hopper_bf16.cuh). One block per
// (head, batch) carries its head's whole p x n state (p <= 64) through the
// chunks: a block of one head, so C B^T is formed once per (batch, head,
// chunk), where splitting p over two blocks would form it twice. Sharing
// C B^T between heads would take the blocks below the 72 of the path's
// shape (3 batches x 24 heads, one group) and give each block the other
// products of every head it holds; splitting p to reach 132
// would form C B^T once per slice again and halve the state update's 64
// rows. So the path runs 72 blocks, one an SM, each with the least work a
// head needs (tests/test_torch_bf16_replay.py replays blocks of more heads
// sharing C B^T: the same bits).
//
// A producer warp keeps the next chunk in flight through a ring of two
// stages, one `full` and one `empty` mbarrier a stage: its lane 0 issues
// the TMA loads of C and B (64-value column blocks of n, one box each) and
// x (the head's p <= 64 values), 128-byte swizzled, the first two chunks'
// before the block's barrier, and all its lanes read dt (whose row
// stride, h values, TMA cannot take), form cum by a warp scan and the
// update weights wdt_s = dt_s bf16(w_s), store them with the stage and
// arrive. A chunk shorter than the 64- or 128-row tile leaves the tiles'
// last rows zero (zeroed once; TMA writes only the chunk's rows), so every
// product runs on whole tiles; n and p past their sizes come as zeros from
// the tensor maps.
//
// The consumers are one warpgroup per 64 rows of the chunk (two for
// chunks over 64); warpgroup r owns column block r of the state (one
// warpgroup owns both for short chunks), in its registers in fp32 across
// the chunks. Per chunk, warpgroup r:
//   1. forms the update's A operand, (wdt o x)^T: x^T's fragments by
//      ldmatrix.trans from the swizzled tile, scaled by wdt_s and rounded;
//   2. runs C B^T for its 64 rows against every s (C and B K-major from
//      shared memory, n as k) and C S'^T (S' = bf16 of the state, K-major
//      in shared memory), in one batch;
//   3. runs the update S <- S exp(cum_end) + (wdt o x)^T B (B MN-major);
//   4. meanwhile scales the carried term's rows by e_t and forms the
//      diagonal block's weights (C B^T) o L o dt in fp32 on the score
//      accumulators, each warp only for the k16 steps its rows reach (no
//      mask below its own 16 x 16 block), rounds them to bf16 and feeds
//      them as the register A operand of the product with x (MN-major);
//   5. releases the stage, writes bf16 of its block of the new state as
//      the next chunk's S' (two buffers, so the only barrier between the
//      warpgroups is the one before C S'^T) and stores y in bf16.
// Scaling x for the update, rather than B in place, saves a barrier
// between the warpgroups and about 1200 cycles a chunk on an H100
// (tools/kernel_phases.py ssd_bf16_phases). About 195 KB of shared memory
// a block. The group of head h is read as h / (heads / groups).
//
// C interface: launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>
#include <type_traits>

#include "hopper_bf16.cuh"
#include "mma_tf32x3.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hopper::Wgmma;
using hopper::round_bf16;
using tf32x3::fast_exp2;

constexpr int MAXQ = 128;   // largest chunk
constexpr int MAXN = 128;   // largest state size n: two column blocks
constexpr int MAXP = 64;    // largest head dim p: one column block
constexpr int NS = 2;       // stages of the ring
constexpr float LOG2E = 1.4426950408889634f;

// QT: the chunk's row tile (64 or 128), one consumer warpgroup per 64.
template <int QT>
struct Smem {
  static constexpr int TILE = QT * 128;   // bytes of a [QT][64] bf16 tile
  struct __align__(1024) Stage {
    unsigned char c[2][TILE];   // C, column blocks of n
    unsigned char b[2][TILE];   // B (scaled in place for the update)
    unsigned char x[TILE];      // x of the head
    float dt[QT];               // dt, zero past the chunk
    float cl[QT];               // log2(e) x the cumulative dt * A
    float wdt[QT];              // dt * bf16(exp(cum_end - cum_s))
    float cl_end;               // log2(e) x cum_end
  };
  Stage stage[NS];
  // S', two buffers (chunks alternate): [buffer][n block][p][64 values]
  __align__(1024) unsigned char sp[2][2][64 * 128];
  uint64_t full[NS], empty[NS];
};

// QT as in Smem; NB: column blocks of n (1 for n <= 64, else 2).
template <int QT, int NB>
__global__ void __launch_bounds__(2 * QT + 32, 1) ssd_scan_bf16_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_b,
    const __grid_constant__ CUtensorMap map_c, const bf16* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ init_state,
    bf16* __restrict__ y, float* __restrict__ final_state,
    float* __restrict__ states, int64_t L, int64_t H, int64_t P, int64_t G,
    int64_t N, int64_t Q, int64_t dt_sb, int64_t dt_sl) {
  constexpr int NWG = QT / 64;   // consumer warpgroups
  constexpr int NBW = (NB + NWG - 1) / NWG;   // column blocks each owns
  constexpr int TILE = Smem<QT>::TILE;
  constexpr int KQ = QT / 16;    // k16 steps over the chunk
  extern __shared__ unsigned char smem_raw[];
  Smem<QT>& sm = *reinterpret_cast<Smem<QT>*>(
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t h = blockIdx.x, b = blockIdx.y;
  const int grp = static_cast<int>(h / (H / G));
  const int q = static_cast<int>(Q), nn = static_cast<int>(N);
  const int pn = static_cast<int>(P);
  const int nc = static_cast<int>(L / Q);

  const uint32_t bytes = static_cast<uint32_t>((2 * NB + 1) * q * 128);
  // C, B and x of chunk c into stage c % NS.
  const auto load_chunk = [&](int c) {
    const int s = c % NS;
    auto& st = sm.stage[s];
    hopper::mbar_expect_tx(&sm.full[s], bytes);
    const int row = c * q;
    for (int kb = 0; kb < NB; ++kb) {
      hopper::tma_load_4d(st.c[kb], &map_c, &sm.full[s], 64 * kb, grp, row,
                          static_cast<int>(b));
      hopper::tma_load_4d(st.b[kb], &map_b, &sm.full[s], 64 * kb, grp, row,
                          static_cast<int>(b));
    }
    hopper::tma_load_4d(st.x, &map_x, &sm.full[s], 0, static_cast<int>(h),
                        row, static_cast<int>(b));
  };
  if (tid == 128 * NWG) {
    // The producer's lane 0: the barriers, then the first chunks' loads at
    // once, while the other threads set up.
    hopper::prefetch_map(&map_x);
    hopper::prefetch_map(&map_b);
    hopper::prefetch_map(&map_c);
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&sm.full[s], 32);         // the producer's lanes
      hopper::mbar_init(&sm.empty[s], 4 * NWG);   // every consumer warp
    }
    hopper::fence_barrier_init();
    for (int c = 0; c < NS && c < nc; ++c) load_chunk(c);
  }
  if (q < QT) {   // rows q.. of every tile stay zero (TMA writes rows < q)
    const int rows = QT - q;
    for (int e = tid; e < NS * 5 * rows * 8; e += blockDim.x) {
      const int u = e & 7, r = q + (e >> 3) % rows, k = (e >> 3) / rows;
      unsigned char* tile = sm.stage[k / 5].c[0] + (k % 5) * TILE;
      *reinterpret_cast<uint4*>(tile + r * 128 + u * 16) =
          make_uint4(0, 0, 0, 0);
    }
    hopper::fence_async_smem();
  }
  __syncthreads();

  if (warp == 4 * NWG) {
    // ---- producer: TMA for C, B, x; dt, cum and wdt by the lanes --------
    const float a = A[h];
    const bf16* dtb = dt + b * dt_sb + h;
    for (int c = 0; c < nc; ++c) {
      const int s = c % NS;
      auto& st = sm.stage[s];
      if (c >= NS) {
        hopper::mbar_wait(&sm.empty[s], ((c / NS) - 1) & 1);
        if (lane == 0) load_chunk(c);
      }
      // each lane scans four consecutive steps, then the lanes' sums
      float d[4], v[4], run = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = lane * 4 + e;
        d[e] = t < q ? __bfloat162float(dtb[(int64_t(c) * q + t) * dt_sl])
                     : 0.f;
        run += d[e] * a;
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
        const int t = lane * 4 + e;
        if (t < QT) {
          const float cu = excl + v[e];
          st.dt[t] = d[e];
          st.cl[t] = cu * LOG2E;
          st.wdt[t] = t < q ? round_bf16(fast_exp2((cum_end - cu) * LOG2E)) *
                                  d[e]
                            : 0.f;
        }
      }
      if (lane == 0) st.cl_end = cum_end * LOG2E;
      hopper::mbar_arrive(&sm.full[s]);
    }
    return;
  }

  // ---- consumers: warpgroup wg takes rows 64 wg.. of each chunk ---------
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int pr0 = 16 * wl + g, pr1 = pr0 + 8;   // the lane's rows of p
  const int tr0 = 64 * wg + pr0, tr1 = tr0 + 8;   // and of the chunk
  float* fin = final_state + (b * H + h) * P * N;

  // The warpgroup's column blocks nb = wg + NWG i of the state, in the
  // accumulator layout: rows p, columns nb * 64 + 8j + 2t4 + (e & 1).
  float st[NBW][32];
#pragma unroll
  for (int i = 0; i < NBW; ++i) {
    const int nb = wg + NWG * i;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int pr = (k & 2) ? pr1 : pr0;
      const int col = nb * 64 + 8 * (k >> 2) + 2 * t4 + (k & 1);
      st[i][k] = init_state != nullptr && nb < NB && pr < pn && col < nn
                     ? init_state[(b * H + h) * P * N + pr * N + col]
                     : 0.f;
    }
  }
  // S' = bf16 of the warpgroup's blocks of the state, as the K-major B of
  // C S'^T: rows p, 64 values of n a row, swizzled.
  const auto write_sp = [&](int buf) {
#pragma unroll
    for (int i = 0; i < NBW; ++i) {
      const int nb = wg + NWG * i;
      if (nb < NB) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<uint32_t*>(sm.sp[buf][nb] +
                                       hopper::swz(pr0, j) + 4 * t4) =
              hopper::pack(st[i][4 * j], st[i][4 * j + 1]);
          *reinterpret_cast<uint32_t*>(sm.sp[buf][nb] +
                                       hopper::swz(pr1, j) + 4 * t4) =
              hopper::pack(st[i][4 * j + 2], st[i][4 * j + 3]);
        }
      }
    }
    hopper::fence_async_smem();
  };
  write_sp(0);

  for (int c = 0; c < nc; ++c) {
    const int s = c % NS;
    auto& stg = sm.stage[s];
    hopper::mbar_wait(&sm.full[s], (c / NS) & 1);
    hopper::bar_sync(1, 128 * NWG);   // every block of S' is written

    // -- 1. the update's A operand, (wdt o x)^T: x^T's fragments by
    // ldmatrix.trans from the swizzled tile, each k scaled by wdt_s and
    // rounded (rows q.. of x are zero: every k16 step of the tile runs) --
    uint32_t ua[KQ][4];
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      const int sr = 16 * kk + (lane & 7) + 8 * (lane >> 4);
      hopper::ldsm_x4_trans(ua[kk], stg.x + hopper::swz(sr, 2 * wl +
                                                       ((lane >> 3) & 1)));
      const float2 w0 =
          *reinterpret_cast<const float2*>(&stg.wdt[16 * kk + 2 * t4]);
      const float2 w8 =
          *reinterpret_cast<const float2*>(&stg.wdt[16 * kk + 8 + 2 * t4]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 w = e < 2 ? w0 : w8;
        ua[kk][e] = hopper::pack(hopper::lo_of(ua[kk][e]) * w.x,
                                 hopper::hi_of(ua[kk][e]) * w.y);
      }
    }

    // -- 2. C B^T of the warpgroup's rows and C S'^T, in one batch --------
    float sc[QT / 2];
    float ya[32];
    const unsigned char* crow = stg.c[0] + wg * 64 * 128;
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk)
      Wgmma<QT>::template ss<0, 0>(sc, hopper::desc_k(crow, kk, TILE),
                                   hopper::desc_k(stg.b[0], kk, TILE),
                                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk)
      Wgmma<64>::ss<0, 0>(ya, hopper::desc_k(crow, kk, TILE),
                          hopper::desc_k(sm.sp[c & 1][0], kk, 64 * 128),
                          kk > 0);
    hopper::wg_commit();

    // -- the chunk's start state, (batch, chunk, head, p, n) ---------------
    if (states != nullptr) {
      float* dst = states + ((b * nc + c) * H + h) * P * N;
#pragma unroll
      for (int i = 0; i < NBW; ++i) {
        const int nb = wg + NWG * i;
#pragma unroll
        for (int k = 0; k < 32; k += 2) {
          const int pr = (k & 2) ? pr1 : pr0;
          const int col = nb * 64 + 8 * (k >> 2) + 2 * t4;
          if (nb < NB && pr < pn && col < nn)
            *reinterpret_cast<float2*>(dst + pr * N + col) =
                make_float2(st[i][k], st[i][k + 1]);
        }
      }
    }
    hopper::wg_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(ya);

    // -- 3. the update S <- S exp(cum_end) + x^T (wdt o B) on the
    // warpgroup's column blocks (B MN-major from shared memory) ------------
    const float keep = fast_exp2(stg.cl_end);   // exp(cum_end)
#pragma unroll
    for (int i = 0; i < NBW; ++i)
#pragma unroll
      for (int k = 0; k < 32; ++k) st[i][k] *= keep;
    hopper::wg_fence();
    if (wg < NB) {
#pragma unroll
      for (int i = 0; i < NBW; ++i)
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk)
          Wgmma<64>::rs<1>(st[i], ua[kk],
                           hopper::desc_mn(stg.b[wg + NWG * i], kk, TILE),
                           1);
    }
    hopper::wg_commit();

    // -- 4. the diagonal block on top of e_t C S'^T ------------------------
    const float ct0 = stg.cl[tr0], ct1 = stg.cl[tr1];
    const float e0 = round_bf16(fast_exp2(ct0));
    const float e1 = round_bf16(fast_exp2(ct1));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ya[4 * j] *= e0;
      ya[4 * j + 1] *= e0;
      ya[4 * j + 2] *= e1;
      ya[4 * j + 3] *= e1;
    }
    // The warp's rows t run from 16 own: steps before `own` lie wholly
    // below the diagonal (no mask), step `own` straddles it, later ones
    // are zero. The warpgroup issues the steps up to its last row.
    const int own = 4 * wg + wl;
    const auto diagonal = [&](auto steps) {
      constexpr int K = decltype(steps)::value;
      uint32_t fa[K][4];
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        if (kk <= own) {
          const int c0 = 16 * kk + 2 * t4;
          const float2 d0 = *reinterpret_cast<const float2*>(&stg.dt[c0]);
          const float2 d8 =
              *reinterpret_cast<const float2*>(&stg.dt[c0 + 8]);
          const float2 l0 = *reinterpret_cast<const float2*>(&stg.cl[c0]);
          const float2 l8 =
              *reinterpret_cast<const float2*>(&stg.cl[c0 + 8]);
          float w[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const float2 dd = u < 4 ? d0 : d8, ll = u < 4 ? l0 : l8;
            const float ct = (u & 2) ? ct1 : ct0;
            w[u] = sc[8 * kk + u] * ((u & 1) ? dd.y : dd.x) *
                   round_bf16(fast_exp2(ct - ((u & 1) ? ll.y : ll.x)));
          }
          if (kk == own) {   // s <= t within the warp's 16 x 16 block
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (8 * (u >> 2) + 2 * t4 + (u & 1) > g + 8 * ((u >> 1) & 1))
                w[u] = 0.f;
          }
          fa[kk][0] = hopper::pack(w[0], w[1]);
          fa[kk][1] = hopper::pack(w[2], w[3]);
          fa[kk][2] = hopper::pack(w[4], w[5]);
          fa[kk][3] = hopper::pack(w[6], w[7]);
        } else {
          fa[kk][0] = fa[kk][1] = fa[kk][2] = fa[kk][3] = 0u;
        }
      }
      hopper::wg_fence();
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
        Wgmma<64>::rs<1>(ya, fa[kk], hopper::desc_mn(stg.x, kk, TILE), 1);
    };
    if (wg == 0)
      diagonal(std::integral_constant<int, 4>());
    else
      diagonal(std::integral_constant<int, KQ>());
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::fence_regs(ya);
#pragma unroll
    for (int i = 0; i < NBW; ++i) hopper::fence_regs(st[i]);

    // -- 5. the stage is free; S' of the next chunk; y ---------------------
    if (lane == 0) hopper::mbar_arrive(&sm.empty[s]);
    if (c + 1 < nc) write_sp((c + 1) & 1);
    bf16* yb = y + ((b * L + int64_t(c) * q) * H + h) * P;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int pp = 8 * j + 2 * t4;   // even, and p is a multiple of 8
      if (pp < pn) {
        if (tr0 < q)
          *reinterpret_cast<uint32_t*>(yb + tr0 * H * P + pp) =
              hopper::pack(ya[4 * j], ya[4 * j + 1]);
        if (tr1 < q)
          *reinterpret_cast<uint32_t*>(yb + tr1 * H * P + pp) =
              hopper::pack(ya[4 * j + 2], ya[4 * j + 3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NBW; ++i) {
    const int nb = wg + NWG * i;
#pragma unroll
    for (int k = 0; k < 32; k += 2) {
      const int pr = (k & 2) ? pr1 : pr0;
      const int col = nb * 64 + 8 * (k >> 2) + 2 * t4;
      if (nb < NB && pr < pn && col < nn)
        *reinterpret_cast<float2*>(fin + pr * N + col) =
            make_float2(st[i][k], st[i][k + 1]);
    }
  }
}

template <int QT, int NB>
int launch(const CUtensorMap& mx, const CUtensorMap& mb,
           const CUtensorMap& mc, const bf16* dt, const float* A,
           const float* init_state, bf16* y, float* final_state,
           float* states, int64_t batch, int64_t L, int64_t H, int64_t P,
           int64_t G, int64_t N, int64_t Q, int64_t dt_sb, int64_t dt_sl,
           cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem<QT>)) + 1024;
  const int err = hopper::allow_smem<ssd_scan_bf16_kernel<QT, NB>>(smem);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>(H), static_cast<unsigned>(batch));
  ssd_scan_bf16_kernel<QT, NB><<<grid, 2 * QT + 32, smem, stream>>>(
      mx, mb, mc, dt, A, init_state, y, final_state, states, L, H, P, G, N,
      Q, dt_sb, dt_sl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_scan_bf16_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* init_state, void* y, void* final_state,
    void* states, int64_t batch, int64_t L, int64_t H, int64_t P, int64_t G,
    int64_t N, int64_t Q, int64_t x_sb, int64_t x_sl, int64_t dt_sb,
    int64_t dt_sl, int64_t b_sb, int64_t b_sl, int64_t c_sb, int64_t c_sl,
    void* stream) {
  // TMA reads x, B and C: 16-byte aligned bases and strides in multiples
  // of 8 values (the wrapper's rule), n and p multiples of 8
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (Q <= 0 || Q > MAXQ || N <= 0 || N > MAXN || P <= 0 || P > MAXP ||
      L % Q != 0 || G <= 0 || H % G != 0 || batch > 65535 ||
      H > 2147483647 || P % 8 != 0 || N % 8 != 0 || !aligned(x) ||
      !aligned(Bm) || !aligned(Cm) || x_sb % 8 != 0 || x_sl % 8 != 0 ||
      b_sb % 8 != 0 || b_sl % 8 != 0 || c_sb % 8 != 0 || c_sl % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // x (b, l, h, p) as (p, h, l, b); B and C (b, l, g, n) as (n, g, l, b);
  // each box 64 values by one head or group by the chunk's rows
  CUtensorMap mx, mb, mc;
  const int box[4] = {64, 1, static_cast<int>(Q), 1};
  const int64_t xd[4] = {P, H, L, batch}, xs[3] = {P, x_sl, x_sb};
  const int64_t bd[4] = {N, G, L, batch}, bs[3] = {N, b_sl, b_sb};
  const int64_t cs[3] = {N, c_sl, c_sb};
  int err = hopper::make_map(&mx, x, 4, xd, xs, box);
  if (err == 0) err = hopper::make_map(&mb, Bm, 4, bd, bs, box);
  if (err == 0) err = hopper::make_map(&mc, Cm, 4, bd, cs, box);
  if (err != 0) return err;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* dtb = static_cast<const bf16*>(dt);
  const auto* Af = static_cast<const float*>(A);
  const auto* init = static_cast<const float*>(init_state);
  auto* yb = static_cast<bf16*>(y);
  auto* fin = static_cast<float*>(final_state);
  auto* sts = static_cast<float*>(states);
  const auto go = [&](auto kernel_launch) {
    return kernel_launch(mx, mb, mc, dtb, Af, init, yb, fin, sts, batch, L, H,
                         P, G, N, Q, dt_sb, dt_sl, st);
  };
  if (Q <= 64) return N <= 64 ? go(launch<64, 1>) : go(launch<64, 2>);
  return N <= 64 ? go(launch<128, 1>) : go(launch<128, 2>);
}
