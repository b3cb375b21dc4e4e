// The chunked SSD scan's backward (Mamba-2) on bf16 x, dt, B, C and dy (A,
// the initial state and the final state's gradient fp32): dx, ddt, dB and
// dC in bf16, each summed in fp32 and rounded once, dA and the initial
// state's gradient in fp32. The function is ssd_scan_bwd.cu's (whose
// header derives it): per (batch, chunk, head h in group g), with cum the
// within-chunk cumulative sum of dt * A (fp32), S0 the chunk's start
// state, G the gradient reaching its end state, CB = C B^T and dP = dy x^T
// fp32 sums of exact products, the decays
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
// need 1.62 GFLOP, 1.64 us at 989 TFLOP/s (kernels/costs.py). Bytes.
//
// Design (Hopper: TMA, mbarriers, wgmma; hopper_bf16.cuh): two kernels on
// one stream, no atomic sum (two runs are bit-equal).
//   1. The state pass (only where some chunk has a G or the initial state
//      wants a gradient: more than one chunk, a final-state gradient or an
//      initial state): one block per (head, batch) walks the chunks first
//      to last for their start states (with more than one chunk or an
//      initial state), then last to first for G, as ssd_scan_bwd.cu's
//      walks G, the state in shared memory in fp32 (FMA on the CUDA
//      cores), the bf16 inputs read as their values.
//   2. The chunk kernel: a block holds a head block of HB = ceil(rep / 8)
//      of a group's rep heads for one (batch, chunk), and the ceil(rep /
//      HB) head blocks of a group are the ranks of a thread-block cluster
//      (the trainer's 24 heads: 8 ranks of 3, 64 blocks). One lane loads
//      the chunk's C and B once by TMA (64-value column blocks of n, zeros
//      past n and past the chunk) and each head's x and dy into a ring of
//      two stages, the next head's as soon as a head starts, so that they
//      land while it computes; warp 0 reads the next head's dt (whose row
//      stride, h values, TMA cannot take) at the start of a head and forms
//      its cum, decays and their bf16 values after its t pass (the shorter
//      one). Two consumer warpgroups own the chunk's 64-row halves. Per
//      head:
//      a. as t (rows of dy, C), over 32-column quarters of s <= t: C B^T
//         and dy x^T as wgmma (all four operands K-major), then on the
//         fp32 accumulators K, M, W's row sums (quad shuffles) and column
//         sums (a fixed-order sum over the eight warps in shared memory)
//         and sum_t K dP; bf16(K o dt) and bf16(M) go to shared memory as
//         causal 64 x 64 tiles (rows t, swizzled), and bf16(M o dt) is the
//         register A operand of dC += (M o dt) B (B MN-major); then the S0
//         term e_t dy_t S0 (S0's two bf16 terms MN-major) and its dot
//         with C_t;
//      b. as s (rows of x, B), after a barrier: dx = (K o dt)^T dy and
//         dB += dt o (M^T C), the tiles read back as a transposed
//         (MN-major) A from shared memory, which bf16 wgmma takes, dy and C
//         MN-major; then the G terms (G B_s, x_s G; G's two terms);
//      c. one warp takes dcum, its suffix sum (a fixed shuffle order), ddt
//         and the head's share of dA.
//      No product is formed twice. dC and dB of the group accumulate over
//      the block's heads in order in the warpgroups' registers; with more
//      than one rank the fp32 partials meet in shared memory and rank r
//      sums its slice over ranks 0, 1, ..., C - 1 in that order
//      (distributed shared memory), rounds and writes it: no per-head
//      scratch and no third kernel (each head's dB and dC in fp32 would be
//      2 x 12.6 MB at the trainer's shape, written and read again by a
//      kernel of their own). dA: the last block to finish (a counter)
//      adds the blocks' shares over batch and chunks in order and resets
//      the counter.
//      C B^T is formed per head, as t, not once per block: kept across the
//      heads it would take 48 KB of fp32 beside the 224 KB the block holds
//      (C, B, two stages of x and dy, the K and M tiles, the two terms of
//      S0 or G and the tables), or 32 to 64 more registers a thread beside
//      the 128 of the group sums; it is 8 of a warpgroup's 28 to 56 k16
//      steps a head.
//      No warp only loads: beside the two warpgroups a producer warp made
//      ptxas hold every thread to 168 registers (as for 384 threads; also
//      with setmaxnreg giving a producer warpgroup's to the consumers),
//      under the 128 of the group sums and a quarter's products: 1.4 to 7
//      KB spilled and wgmma serialized (C7519). At 256 threads each has
//      255.
//      S0 and G are read in fp32 (the state pass's buffers) and staged as
//      two bf16 terms by the consumers, S0 before the t pass and G in its
//      room after it; only where the state pass runs.
// A chunk shorter than the 128-row tiles leaves their last rows zero
// (zeroed once; TMA writes only the chunk's rows), so every product runs
// on whole tiles. Head dim at most 64, n at most 128, chunk at most 128, p
// and n multiples of 8.
//
// C interface: launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

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
using hopper::round_bf16;
using tf32x3::fast_exp2;

constexpr int MAXQ = 128;   // largest chunk
constexpr int MAXN = 128;   // largest state size n
constexpr int MAXP = 64;    // largest head dim p
constexpr int NS = 2;       // stages of the ring
constexpr int THREADS = 256;   // two warpgroups
constexpr int TILE = MAXQ * 128;   // bytes of a [128][64] bf16 tile
constexpr int BLK = 64 * 128;      // bytes of a [64][64] bf16 tile
constexpr int LDF = MAXN + 4;      // fp32 partial rows
constexpr int MAX_CLUSTER = 8;
constexpr float LOG2E = 1.4426950408889634f;

struct ChunkSmem {
  unsigned char c[2][TILE];   // C of the chunk, rows t, column blocks of n
  unsigned char b[2][TILE];   // B, rows s
  struct Stage {
    unsigned char x[TILE];    // x of a head, rows s
    unsigned char dy[TILE];   // dy, rows t
  } stage[NS];
  unsigned char kt[3][BLK];   // bf16(K o dt): causal blocks (t, s) = (0, 0),
  unsigned char mt[3][BLK];   // (1, 0), (1, 1); bf16(M) the same
  unsigned char gs[2][2][BLK];   // S0 or G: [term][column block][p rows]
  // a stage's tables: dt, log2(e) cum, v, u and the bf16 values e, w
  float dt[NS][MAXQ], cl[NS][MAXQ], ecu[NS][MAXQ], wu[NS][MAXQ];
  float ecr[NS][MAXQ], wr[NS][MAXQ];
  float cum_end[NS];
  float colp[8][2][MAXQ];   // each consumer warp's column sums: W, K o dP
  float roww[MAXQ];         // sum_s W_ts
  float t5[MAXQ];           // v_t dy_t . S0 C_t
  float t2[MAXQ];           // u_s x_s . G B_s
  float red[8];             // <S0, G>: each consumer warp's part
  int last;
  uint64_t cbbar, full[NS];
};

static_assert(sizeof(ChunkSmem) + 1024 <= 232448, "one block's shared memory");
static_assert(sizeof(float) * 2 * MAXQ * LDF <= offsetof(ChunkSmem, dt),
              "the partials fit in the tiles' room");

struct Args {
  const bf16* dt;
  const float *A, *sbuf, *gbuf;
  bf16 *dx, *ddt, *dB, *dC;
  float *dapart, *dA;
  unsigned int* counter;
  int64_t L, H, P, G, N, Q, NC;
  int64_t dt_sb, dt_sl;
  int rep, hb, cluster, has_init, g_last_zero;
};

__device__ __forceinline__ float bf(const bf16 v) {
  return __bfloat162float(v);
}

// The bf16 value at (row r, column c) of a swizzled 64-column tile.
__device__ __forceinline__ float tile_at(const unsigned char* tile, int r,
                                         int c) {
  return bf(*reinterpret_cast<const bf16*>(tile + hopper::swz(r, c >> 3) +
                                           (c & 7) * 2));
}

// Two bf16 values (rounded from lo, hi) at (row r, columns c, c + 1; c
// even) of a swizzled 64-column tile.
__device__ __forceinline__ void tile_put(unsigned char* tile, int r, int c,
                                         float lo, float hi) {
  *reinterpret_cast<uint32_t*>(tile + hopper::swz(r, c >> 3) + (c & 7) * 2) =
      hopper::pack(lo, hi);
}

// Sum over the four lanes of a quad (the lanes of one accumulator row),
// in a fixed order.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// Sum over the eight lanes of a column (g = 0..7 at one t), in a fixed
// order; lanes 0..3 hold the sums.
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// A dense (p, n) fp32 state as two bf16 terms, hi = bf16(v) and lo =
// bf16(v - hi), into gs (rows p, swizzled, zero past p and n), by the
// consumer threads. With `other`, also returns this thread's part of
// <src, other> in fp32.
__device__ __forceinline__ float stage_state(unsigned char (*gs)[2][BLK],
                                             const float* src,
                                             const float* other, int pp,
                                             int nn) {
  float dot = 0.f;
  for (int e = threadIdx.x; e < MAXP * MAXN / 2; e += THREADS) {
    const int r = e / (MAXN / 2), c = 2 * (e % (MAXN / 2));
    float v[2] = {0.f, 0.f};
    if (r < pp && c < nn) {
      const float2 w = *reinterpret_cast<const float2*>(src + r * nn + c);
      v[0] = w.x;
      v[1] = w.y;
      if (other != nullptr) {
        const float2 o = *reinterpret_cast<const float2*>(other + r * nn + c);
        dot += w.x * o.x + w.y * o.y;
      }
    }
    const float h0 = round_bf16(v[0]), h1 = round_bf16(v[1]);
    tile_put(gs[0][c >> 6], r, c & 63, h0, h1);
    tile_put(gs[1][c >> 6], r, c & 63, v[0] - h0, v[1] - h1);
  }
  return dot;
}

// cum (inclusive scan of dt * a over the chunk) by one warp, each lane four
// steps, then the lanes' sums by shuffles in a fixed order; dts holds dt,
// zero past q. Returns cum_end to every lane of the warp.
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

// A head's dt at this lane's four steps 4 lane.. of the chunk (zero past
// q), for `head_tables`; loaded early, so that the loads' latency hides
// behind other work.
__device__ __forceinline__ void head_dt(float (&d)[4], const bf16* dt,
                                        int64_t stride, int q) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int st = 4 * lane + e;
    d[e] = st < q ? bf(dt[st * stride]) : 0.f;
  }
}

// A head's tables in stage s, by one warp: dt, log2(e) cum, v, u and their
// bf16 values e, w, and cum_end.
__device__ __forceinline__ void head_tables(ChunkSmem& sm, int s,
                                            const float (&d)[4], float av,
                                            int q) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < 4; ++e) sm.dt[s][4 * lane + e] = d[e];
  __syncwarp();
  const float cum_end = chunk_cum(sm.dt[s], sm.cl[s], av, q);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int st = 4 * lane + e;
    const float cum = sm.cl[s][st];
    const float v = st < q ? expf(cum) : 0.f;
    const float u = st < q ? expf(cum_end - cum) : 0.f;
    sm.cl[s][st] = cum * LOG2E;
    sm.ecu[s][st] = v;
    sm.wu[s][st] = u;
    sm.ecr[s][st] = round_bf16(v);
    sm.wr[s][st] = round_bf16(u);
  }
  if (lane == 0) sm.cum_end[s] = cum_end;
}

__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_bf16_chunk_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_dy,
    const __grid_constant__ CUtensorMap map_b,
    const __grid_constant__ CUtensorMap map_c, const Args a) {
  namespace cg = cooperative_groups;
  extern __shared__ unsigned char smem_raw[];
  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023));
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = static_cast<int>(cluster.block_rank());
  const int grp = static_cast<int>(blockIdx.x / a.cluster);
  const int64_t bc = blockIdx.y, bi = bc / a.NC, ci = bc % a.NC;
  const int c0 = static_cast<int>(ci * a.Q);
  const int q = static_cast<int>(a.Q), nn = static_cast<int>(a.N);
  const int pp = static_cast<int>(a.P);
  constexpr int NK = MAXN / 16, PK = MAXP / 16;   // k16 steps (zeros past)
  const int h_first = grp * a.rep + rank * a.hb;
  const int nh = a.rep - rank * a.hb < a.hb ? a.rep - rank * a.hb : a.hb;
  const bool has_s = a.sbuf != nullptr && !(ci == 0 && !a.has_init);
  const bool has_g = a.gbuf != nullptr && !(a.g_last_zero && ci == a.NC - 1);
  const int bint = static_cast<int>(bi);

  // x and dy of the block's head i into stage i % NS
  const auto load_head = [&](int i) {
    const int s = i % NS, h = h_first + i;
    hopper::mbar_arrive_expect_tx(&sm.full[s], 2 * q * 128);
    hopper::tma_load_4d(sm.stage[s].x, &map_x, &sm.full[s], 0, h, c0, bint);
    hopper::tma_load_4d(sm.stage[s].dy, &map_dy, &sm.full[s], 0, h, c0,
                        bint);
  };
  const auto dt_of = [&](int i) {   // head i's dt column of the chunk
    return a.dt + bi * a.dt_sb + c0 * a.dt_sl + h_first + i;
  };
  if (tid == 32) {
    // The loading lane: the barriers, then C, B and the first two heads'
    // x and dy at once, while warp 0 forms the first head's tables.
    hopper::prefetch_map(&map_x);
    hopper::prefetch_map(&map_dy);
    hopper::prefetch_map(&map_b);
    hopper::prefetch_map(&map_c);
    hopper::mbar_init(&sm.cbbar, 1);
    for (int s = 0; s < NS; ++s) hopper::mbar_init(&sm.full[s], 1);
    hopper::fence_barrier_init();
    hopper::mbar_arrive_expect_tx(&sm.cbbar, 4 * q * 128);
    for (int nb = 0; nb < 2; ++nb) {
      hopper::tma_load_4d(sm.c[nb], &map_c, &sm.cbbar, 64 * nb, grp, c0,
                          bint);
      hopper::tma_load_4d(sm.b[nb], &map_b, &sm.cbbar, 64 * nb, grp, c0,
                          bint);
    }
    for (int i = 0; i < NS && i < nh; ++i) load_head(i);
  }
  if (q < MAXQ) {   // rows past the chunk stay zero
    unsigned char* tiles[4 + 2 * NS] = {sm.c[0], sm.c[1], sm.b[0], sm.b[1]};
    for (int s = 0; s < NS; ++s) {
      tiles[4 + 2 * s] = sm.stage[s].x;
      tiles[5 + 2 * s] = sm.stage[s].dy;
    }
    const int per = (MAXQ - q) * 8;   // 16-byte units a tile
    for (int e = tid; e < (4 + 2 * NS) * per; e += THREADS)
      *reinterpret_cast<uint4*>(tiles[e / per] + q * 128 + (e % per) * 16) =
          make_uint4(0, 0, 0, 0);
    // a chunk of at most 64 rows writes only the K and M tiles' block
    // (0, 0); the s pass runs over blocks (1, 0) too, as zeros, so that
    // its products are one straight run (a branch between them made
    // ptxas serialize them, C7519)
    if (q <= 64)
      for (int e = tid; e < 2 * BLK / 16; e += THREADS)
        *reinterpret_cast<uint4*>((e < BLK / 16 ? sm.kt[1] : sm.mt[1]) +
                                  (e % (BLK / 16)) * 16) =
            make_uint4(0, 0, 0, 0);
    hopper::fence_async_smem();
  }
  if (warp == 0 && nh > 0) {
    float d[4];
    head_dt(d, dt_of(0), a.dt_sl, q);
    head_tables(sm, 0, d, a.A[h_first], q);
  }
  __syncthreads();

  const int g = lane >> 2, tq = lane & 3;
  const int64_t orow = bi * a.L + c0;   // the chunk's first position
  float* part = reinterpret_cast<float*>(&sm);   // [2][MAXQ][LDF]: dB, dC

  {
    // ---- consumers: warpgroup wg owns rows 64 wg.. as t and as s, wg a
    // constant in each instance (wgmma's loops and branches then depend
    // on no thread index: ptxas serializes wgmma on a divergent path)
    const auto consume = [&](auto wg_const) {
      constexpr int wg = decltype(wg_const)::value;
      const int ra = 64 * wg + 16 * (warp & 3) + g, rb = ra + 8;   // its rows
      float dcg[64], dbg[64];   // the group's dC (rows t) and dB (rows s)
#pragma unroll
      for (int e = 0; e < 64; ++e) dcg[e] = dbg[e] = 0.f;
      const bool live = wg == 0 || q > 64;
      hopper::mbar_wait(&sm.cbbar, 0);
      for (int i = 0; i < nh; ++i) {
        const int s = i % NS, h = h_first + i;
        const auto& stg = sm.stage[s];
        const float* dts = sm.dt[s];
        const float* cl = sm.cl[s];
        const int64_t slot = ((bi * a.NC + ci) * a.H + h) * a.P * a.N;
        hopper::mbar_wait(&sm.full[s], (i / NS) & 1);
        // every thread is done with the last head: its stage, the tables
        // of the stage before and gs are free
        hopper::bar_sync(1, THREADS);
        // head i + 1's x and dy in flight while this head computes, and
        // its dt loading (warp 0 forms its tables after its t pass)
        if (tid == 32 && i >= 1 && i + 1 < nh) load_head(i + 1);
        float dnext[4];
        if (warp == 0 && i + 1 < nh) head_dt(dnext, dt_of(i + 1), a.dt_sl, q);
        if (has_s) {
          stage_state(sm.gs, a.sbuf + slot, nullptr, pp, nn);
          hopper::fence_async_smem();
          hopper::bar_sync(1, THREADS);
        }

        // -- a. as t: K, M, their tiles, dC, W's sums, the S0 term --------
        float rw[2] = {0.f, 0.f};
        if (live) {
          const float clt[2] = {cl[ra], cl[rb]};
          for (int qr = 0; qr < 2 * (wg + 1); ++qr) {
            const int s0 = 32 * qr;   // the quarter's first s
            float cb[16], dp[16];
            hopper::wg_fence();
            for (int kk = 0; kk < NK; ++kk)
              Wgmma<32>::ss<0, 0>(cb, hopper::desc_k(sm.c[0] + 64 * wg * 128,
                                                     kk, TILE),
                                  hopper::desc_k(sm.b[0] + s0 * 128, kk, TILE),
                                  kk > 0);
            for (int kk = 0; kk < PK; ++kk)
              Wgmma<32>::ss<0, 0>(dp, hopper::desc_k(stg.dy + 64 * wg * 128,
                                                     kk, TILE),
                                  hopper::desc_k(stg.x + s0 * 128, kk, TILE),
                                  kk > 0);
            hopper::wg_commit();
            hopper::wg_wait<0>();
            hopper::fence_regs(cb);
            hopper::fence_regs(dp);
            // d[4j + e]: row t = ra (e < 2) or rb, column s = s0 + 8j + 2tq
            // + (e & 1); a column tile at a time: its tiles' values, then
            // its two columns' sums over the warp's rows
            const int blk = wg + (s0 >> 6);   // block (wg, s0 / 64)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float cw[2] = {0.f, 0.f}, ck[2] = {0.f, 0.f}, kd[4], mr[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = e >> 1, u = e & 1, t = r ? rb : ra;
                const int sc = s0 + 8 * j + 2 * tq + u;
                // (no branch: exp2(-inf) = 0 past the diagonal)
                const float lu = fast_exp2(sc <= t && t < q ? clt[r] - cl[sc]
                                                            : -INFINITY);
                const float l = round_bf16(lu), d = dts[sc];
                const float cv = cb[4 * j + e], pv = dp[4 * j + e];
                const float k = cv * l, m = pv * l, w = cv * lu * d * pv;
                rw[r] += w;
                cw[u] += w;
                ck[u] += k * pv;
                kd[e] = k * d;
                mr[e] = m;
                dp[4 * j + e] = m * d;   // M o dt, dC's operand
              }
              const int scl = (s0 & 63) + 8 * j + 2 * tq;
              tile_put(sm.kt[blk], ra - 64 * wg, scl, kd[0], kd[1]);
              tile_put(sm.kt[blk], rb - 64 * wg, scl, kd[2], kd[3]);
              tile_put(sm.mt[blk], ra - 64 * wg, scl, mr[0], mr[1]);
              tile_put(sm.mt[blk], rb - 64 * wg, scl, mr[2], mr[3]);
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                cw[u] = column_sum(cw[u]);
                ck[u] = column_sum(ck[u]);
              }
              // (every lane of the column holds the sum: no branch)
              sm.colp[warp][0][s0 + 8 * j + 2 * tq] = cw[0];
              sm.colp[warp][0][s0 + 8 * j + 2 * tq + 1] = cw[1];
              sm.colp[warp][1][s0 + 8 * j + 2 * tq] = ck[0];
              sm.colp[warp][1][s0 + 8 * j + 2 * tq + 1] = ck[1];
            }
            uint32_t fa[2][4];
            hopper::acc_pair_as_a(fa[0], dp, 0);
            hopper::acc_pair_as_a(fa[1], dp, 1);
            hopper::wg_fence();
#pragma unroll
            for (int kk = 0; kk < 2; ++kk)
              Wgmma<128>::rs<1>(dcg, fa[kk],
                                hopper::desc_mn(sm.b[0] + s0 * 128, kk, TILE),
                                1);
            hopper::wg_commit();
            hopper::wg_wait<0>();
            hopper::fence_regs(dcg);
          }
          // the S0 term: dC += e_t S0^T dy_t, t5 = v_t C_t . S0^T dy_t
          float t5[2] = {0.f, 0.f};
          if (has_s) {
            const float er[2] = {sm.ecr[s][ra], sm.ecr[s][rb]};
#pragma unroll
            for (int nb = 0; nb < 2; ++nb) {
              float ds[32];
              hopper::wg_fence();
              for (int term = 0; term < 2; ++term)
                for (int kk = 0; kk < PK; ++kk)
                  Wgmma<64>::ss<0, 1>(
                      ds, hopper::desc_k(stg.dy + 64 * wg * 128, kk, TILE),
                      hopper::desc_mn(sm.gs[term][nb], kk, BLK), term | kk);
              hopper::wg_commit();
              hopper::wg_wait<0>();
              hopper::fence_regs(ds);
#pragma unroll
              for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int r = e >> 1;
                  const int col = 8 * j + 2 * tq + (e & 1);
                  dcg[32 * nb + 4 * j + e] += er[r] * ds[4 * j + e];
                  t5[r] += tile_at(sm.c[nb], r ? rb : ra, col) * ds[4 * j + e];
                }
            }
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            rw[r] = quad_sum(rw[r]);
            t5[r] = quad_sum(t5[r]);
          }
          if (tq == 0) {
            sm.roww[ra] = rw[0];
            sm.roww[rb] = rw[1];
            sm.t5[ra] = sm.ecu[s][ra] * t5[0];
            sm.t5[rb] = sm.ecu[s][rb] * t5[1];
          }
        }
        // the next head's tables (its stage's were last read by the head
        // before this one)
        if (warp == 0 && i + 1 < nh)
          head_tables(sm, (i + 1) % NS, dnext, a.A[h + 1], q);
        hopper::fence_async_smem();   // the K and M tiles, for wgmma
        hopper::bar_sync(1, THREADS);
        if (has_g) {
          const float dot = stage_state(sm.gs, a.gbuf + slot,
                                        has_s ? a.sbuf + slot : nullptr, pp,
                                        nn);
          if (has_s) {
            float v = dot;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              v += __shfl_xor_sync(0xffffffffu, v, off);
            if (lane == 0) sm.red[warp] = v;
          }
          hopper::fence_async_smem();
          hopper::bar_sync(1, THREADS);
        }

        // -- b. as s: dx, dB, the G terms ----------------------------------
        if (live) {
          const float dtr[2] = {dts[ra], dts[rb]};
          const float wsr[2] = {sm.wr[s][ra] * dtr[0], sm.wr[s][rb] * dtr[1]};
          float dx[32];
          hopper::wg_fence();
#pragma unroll
          for (int tb = wg; tb < 2; ++tb) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              Wgmma<64>::ss<1, 1>(
                  dx, hopper::desc_mn(sm.kt[tb + wg], kk, BLK),
                  hopper::desc_mn(stg.dy + 64 * tb * 128, kk, TILE),
                  tb > wg || kk > 0);
          }
          hopper::wg_commit();
          hopper::wg_wait<0>();
          hopper::fence_regs(dx);
          float xgb[2] = {0.f, 0.f};
          if (has_g) {
            float gb[32];
            hopper::wg_fence();
            for (int term = 0; term < 2; ++term)
              for (int kk = 0; kk < NK; ++kk)
                Wgmma<64>::ss<0, 0>(
                    gb, hopper::desc_k(sm.b[0] + 64 * wg * 128, kk, TILE),
                    hopper::desc_k(sm.gs[term][0], kk, BLK), term | kk);
            hopper::wg_commit();
            hopper::wg_wait<0>();
            hopper::fence_regs(gb);
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                dx[4 * j + e] += wsr[r] * gb[4 * j + e];
                xgb[r] += tile_at(stg.x, r ? rb : ra,
                                  8 * j + 2 * tq + (e & 1)) *
                          gb[4 * j + e];
              }
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) xgb[r] = quad_sum(xgb[r]);
          if (tq == 0) {
            sm.t2[ra] = sm.wu[s][ra] * xgb[0];
            sm.t2[rb] = sm.wu[s][rb] * xgb[1];
          }
          // dx in bf16 (p a multiple of 8: a pair is in range or out)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 8 * j + 2 * tq;
            if (col >= pp) continue;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int sr = r ? rb : ra;
              if (sr < q)
                *reinterpret_cast<uint32_t*>(
                    a.dx + ((bi * a.L + c0 + sr) * a.H + h) * a.P + col) =
                    hopper::pack(dx[4 * j + 2 * r], dx[4 * j + 2 * r + 1]);
            }
          }
          // dB += dt_s (M^T C)_s + w_s dt_s (x_s G), a column block at a time
#pragma unroll
          for (int nb = 0; nb < 2; ++nb) {
            float db[32];
            hopper::wg_fence();
#pragma unroll
            for (int tb = wg; tb < 2; ++tb) {
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                Wgmma<64>::ss<1, 1>(
                    db, hopper::desc_mn(sm.mt[tb + wg], kk, BLK),
                    hopper::desc_mn(sm.c[nb] + 64 * tb * 128, kk, TILE),
                    tb > wg || kk > 0);
            }
            hopper::wg_commit();
            hopper::wg_wait<0>();
            hopper::fence_regs(db);
#pragma unroll
            for (int e = 0; e < 32; ++e)
              dbg[32 * nb + e] += dtr[(e & 3) >> 1] * db[e];
            if (has_g) {
              hopper::wg_fence();
              for (int term = 0; term < 2; ++term)
                for (int kk = 0; kk < PK; ++kk)
                  Wgmma<64>::ss<0, 1>(
                      db, hopper::desc_k(stg.x + 64 * wg * 128, kk, TILE),
                      hopper::desc_mn(sm.gs[term][nb], kk, BLK), term | kk);
              hopper::wg_commit();
              hopper::wg_wait<0>();
              hopper::fence_regs(db);
#pragma unroll
              for (int e = 0; e < 32; ++e)
                dbg[32 * nb + e] += wsr[(e & 3) >> 1] * db[e];
            }
          }
        }
        hopper::bar_sync(1, THREADS);   // t2 and the column sums are in

        // -- c. dcum, its suffix sum, ddt and the head's share of dA -------
        if (warp == 0) {
          const int nw = q > 64 ? 8 : 4;   // the warps with rows as t
          float vs = 0.f;   // sum_t V_t = sum_t dt_t t2_t
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = lane * 4 + e;
            if (t < q) vs += dts[t] * sm.t2[t];
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            vs += __shfl_xor_sync(0xffffffffu, vs, off);
          float sg = 0.f;   // <S0, G>
          if (has_s && has_g)
            for (int w = 0; w < 8; ++w) sg += sm.red[w];
          float suf[4];   // sums over this lane's steps e.. 3
          float kdp[4];
#pragma unroll
          for (int e = 3; e >= 0; --e) {
            const int t = lane * 4 + e;
            float d = 0.f, cw = 0.f, ck = 0.f;
            if (t < q) {
              // warps whose t rows reach column t: every warp for t < 64,
              // the second warpgroup's beyond
              for (int w = t < 64 ? 0 : 4; w < nw; ++w) {
                cw += sm.colp[w][0][t];
                ck += sm.colp[w][1][t];
              }
              d = sm.roww[t] - cw + (has_s ? sm.t5[t] : 0.f) -
                  dts[t] * sm.t2[t];
              if (t == q - 1) d += vs + expf(sm.cum_end[s]) * sg;
            }
            kdp[e] = ck;
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
          const float av = a.A[h];
          float da = 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = lane * 4 + e;
            const float dda = suf[e] + after;   // d(dt A)_t
            if (t < q) {
              a.ddt[(bi * a.L + c0 + t) * a.H + h] =
                  __float2bfloat16_rn(kdp[e] + sm.t2[t] + av * dda);
              da += dts[t] * dda;
            }
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            da += __shfl_xor_sync(0xffffffffu, da, off);
          if (lane == 0) a.dapart[bc * a.H + h] = da;
        }
      }

      // ---- the group's dB and dC: this block's heads, then the ranks ------
      hopper::bar_sync(1, THREADS);   // every tile is consumed
      if (a.cluster == 1) {
        if (live) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int col = 8 * j + 2 * tq;
            if (col >= nn) continue;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = r ? rb : ra;
              if (row >= q) continue;
              const int64_t at = ((orow + row) * a.G + grp) * a.N + col;
              *reinterpret_cast<uint32_t*>(a.dB + at) =
                  hopper::pack(dbg[4 * j + 2 * r], dbg[4 * j + 2 * r + 1]);
              *reinterpret_cast<uint32_t*>(a.dC + at) =
                  hopper::pack(dcg[4 * j + 2 * r], dcg[4 * j + 2 * r + 1]);
            }
          }
        }
      } else {
        // fp32 partials over this rank's shared memory (C, B, the stages
        // and the tiles are free)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = 8 * j + 2 * tq;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = r ? rb : ra;
            *reinterpret_cast<float2*>(part + row * LDF + col) =
                make_float2(dbg[4 * j + 2 * r], dbg[4 * j + 2 * r + 1]);
            *reinterpret_cast<float2*>(part + (MAXQ + row) * LDF + col) =
                make_float2(dcg[4 * j + 2 * r], dcg[4 * j + 2 * r + 1]);
          }
        }
      }
    };
    if (warp < 4)
      consume(std::integral_constant<int, 0>{});
    else
      consume(std::integral_constant<int, 1>{});
  }

  if (a.cluster > 1) {
    // rank r sums its slice over the ranks' partials, loaded in rank order
    // (pushing each partial to its rank by stores instead took a block's
    // end, from its last head to dA, from 17k to 27k cycles on an H100)
    cluster.sync();   // every rank's partials are written
    const int n4 = nn / 4, total = 2 * q * n4;
    const int lo = total * rank / a.cluster;
    const int hi = total * (rank + 1) / a.cluster;
#pragma unroll 2   // two elements' loads in flight at once
    for (int e = lo + tid; e < hi; e += THREADS) {
      const int which = e / (q * n4), row = e / n4 % q, c = e % n4;
      const int off = (which * MAXQ + row) * LDF + 4 * c;
      float4 x[MAX_CLUSTER];   // every rank's loads in flight, then summed
#pragma unroll
      for (int rr = 0; rr < MAX_CLUSTER; ++rr)
        if (rr < a.cluster)
          x[rr] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(part + off, rr));
      float4 sum = x[0];
#pragma unroll
      for (int rr = 1; rr < MAX_CLUSTER; ++rr) {
        if (rr >= a.cluster) break;
        sum.x += x[rr].x;
        sum.y += x[rr].y;
        sum.z += x[rr].z;
        sum.w += x[rr].w;
      }
      uint2 out;
      out.x = hopper::pack(sum.x, sum.y);
      out.y = hopper::pack(sum.z, sum.w);
      *reinterpret_cast<uint2*>((which ? a.dC : a.dB) +
                                ((orow + row) * a.G + grp) * a.N + 4 * c) =
          out;
    }
    cluster.sync();   // no rank leaves while another reads its partials
  }

  // ---- dA: the last block adds the heads' shares in order ---------------
  if (tid == 0) {
    __threadfence();   // this block's shares, before the count
    const unsigned int done = atomicAdd(a.counter, 1u);
    sm.last = done == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  if (sm.last) {
    __threadfence();
    const int64_t parts = gridDim.y;   // batch x chunks
    for (int64_t hh = tid; hh < a.H; hh += THREADS) {
      float s = 0.f;
      for (int64_t u = 0; u < parts; ++u) s += __ldcg(a.dapart + u * a.H + hh);
      a.dA[hh] = s;
    }
    if (tid == 0) *a.counter = 0u;   // for the next launch
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

}  // namespace

// dfinal, init, dinit may be null (no final-state gradient, no initial
// state); init and dinit are null together. sbuf: (batch, L / Q, H, P, N)
// fp32 scratch for the chunks' start states, which the state pass
// recomputes (with more than one chunk or an initial state; else null).
// gbuf: the same shape, G of each chunk, used when the state pass runs
// (more than one chunk, a dfinal or a dinit); dapart: (batch * L / Q, H)
// fp32; counter: one unsigned int, zero (the chunk kernel leaves it zero).
// x, dt, B, C, dy, dx, ddt, dB, dC are bf16; A, dfinal, init, dA, dinit
// fp32; dy, dx, ddt, dB, dC dense. TMA reads x, dy, B and C: 16-byte
// aligned bases, strides in multiples of 8 values, p and n multiples of 8.
extern "C" int ssd_scan_bwd_bf16_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* dy, const void* dfinal, const void* init,
    void* sbuf, void* gbuf, void* dapart, void* counter, void* dx, void* ddt,
    void* dA, void* dB, void* dC, void* dinit, int64_t batch, int64_t L,
    int64_t H, int64_t P, int64_t G, int64_t N, int64_t Q, int64_t has_init,
    int64_t x_sb, int64_t x_sl, int64_t dt_sb, int64_t dt_sl, int64_t b_sb,
    int64_t b_sl, int64_t c_sb, int64_t c_sl, void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (Q <= 0 || Q > MAXQ || N <= 0 || N > MAXN || P <= 0 || P > MAXP ||
      L <= 0 || L % Q != 0 || G <= 0 || H % G != 0 || H > 65535 ||
      batch * (L / Q) > 65535 || P % 8 != 0 || N % 8 != 0 || !aligned(x) ||
      !aligned(dy) || !aligned(Bm) || !aligned(Cm) || x_sb % 8 != 0 ||
      x_sl % 8 != 0 || b_sb % 8 != 0 || b_sl % 8 != 0 || c_sb % 8 != 0 ||
      c_sl % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t NC = L / Q;
  const bool state_pass = NC > 1 || dfinal != nullptr || dinit != nullptr;
  int err;
  if (state_pass) {
    err = hopper::allow_smem<ssd_bwd_bf16_state_kernel>(
        static_cast<int>(sizeof(StateSmem)));
    if (err != 0) return err;
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
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  // x and dy (b, l, h, p) as (p, h, l, b); B and C (b, l, g, n) as (n, g,
  // l, b); each box 64 values by one head or group by the chunk's rows
  CUtensorMap mx, mdy, mb, mc;
  const int box[4] = {64, 1, static_cast<int>(Q), 1};
  const int64_t xd[4] = {P, H, L, batch}, xs[3] = {P, x_sl, x_sb};
  const int64_t ys[3] = {P, H * P, L * H * P};
  const int64_t bd[4] = {N, G, L, batch}, bs[3] = {N, b_sl, b_sb};
  const int64_t cs[3] = {N, c_sl, c_sb};
  err = hopper::make_map(&mx, x, 4, xd, xs, box);
  if (err == 0) err = hopper::make_map(&mdy, dy, 4, xd, ys, box);
  if (err == 0) err = hopper::make_map(&mb, Bm, 4, bd, bs, box);
  if (err == 0) err = hopper::make_map(&mc, Cm, 4, bd, cs, box);
  if (err != 0) return err;
  const int smem = static_cast<int>(sizeof(ChunkSmem)) + 1024;
  err = hopper::allow_smem<ssd_bwd_bf16_chunk_kernel>(smem);
  if (err != 0) return err;
  Args a;
  a.dt = static_cast<const bf16*>(dt);
  a.A = static_cast<const float*>(A);
  a.sbuf = static_cast<const float*>(sbuf);
  a.gbuf = state_pass ? static_cast<const float*>(gbuf) : nullptr;
  a.dx = static_cast<bf16*>(dx);
  a.ddt = static_cast<bf16*>(ddt);
  a.dB = static_cast<bf16*>(dB);
  a.dC = static_cast<bf16*>(dC);
  a.dapart = static_cast<float*>(dapart);
  a.dA = static_cast<float*>(dA);
  a.counter = static_cast<unsigned int*>(counter);
  a.L = L; a.H = H; a.P = P; a.G = G; a.N = N; a.Q = Q; a.NC = NC;
  a.dt_sb = dt_sb; a.dt_sl = dt_sl;
  // head blocks of ceil(rep / 8) heads, one a rank of the group's cluster
  // (the trainer's 24 heads: 8 ranks of 3, 64 blocks; 12 ranks of 2, a
  // cluster beyond the portable 8, took 0.083 against 0.061 ms on an H100)
  a.rep = static_cast<int>(H / G);
  a.hb = (a.rep + MAX_CLUSTER - 1) / MAX_CLUSTER;
  a.cluster = (a.rep + a.hb - 1) / a.hb;
  a.has_init = static_cast<int>(has_init);
  a.g_last_zero = dfinal == nullptr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(G * a.cluster),
                     static_cast<unsigned>(batch * NC));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, ssd_bwd_bf16_chunk_kernel, mx, mdy,
                                     mb, mc, a);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}
