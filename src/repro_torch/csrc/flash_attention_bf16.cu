// Blockwise (flash) attention with grouped KV heads, bf16 in and out:
//   o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / G] * D^-0.5) v[b, j, h / G]
// with column j masked (score -1e30) when causal and j > i, or when a
// window is set and i - j >= window, the scores and the softmax in fp32,
// P rounded to bf16 before P V (as the reference's kernel casts P to V's
// dtype), the output rounded to bf16 once. Given an `lse` pointer it also
// writes each row's log-sum-exp of the scaled, masked scores (natural
// log, (B, H, Sq) fp32); without one its output is unchanged.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention.py:flash_attention_kernel in bf16
// (its `p.astype(v.dtype)` before P V, `:55`, and its output in q's
// dtype, `:86`); csrc/flash_attention.cu is its fp32 form.
//
// Bound on the H100: at the path's shapes (Qwen2-0.5B prefill: 14 query
// heads over 2 KV heads, D = 64, S of 32 to 96, bf16) bytes and
// operations are both tiny: S = 96, B = 4 moves about 1.57 MB (0.47 us at
// 3.35 TB/s) and does about 67 MFLOP over the causal pairs (0.07 us at
// the 989 TFLOP/s of bf16 on the tensor cores). The launch and the
// dependent steps of one block's K/V loop are the time. At the vision
// model's cross shape (q (2, 64, 32, 128), k/v (2, 1024, 8, 128)) the
// 10.5 MB take 3.13 us at 3.35 TB/s and the 2.15 GFLOP 2.17 us at
// 989 TFLOP/s: bytes (kernels/costs.py:flash_attention).
//
// Design (Hopper: TMA, mbarriers, wgmma; hopper_bf16.cuh). The G query
// heads of a KV head are folded into the rows: one block per (64-row tile,
// KV head, batch), its rows the pairs (query, head in group), row
// r = (i - i_first) G + (h - kvh G) for QB = 64 / G queries i_first.. of
// the tile, so that one K/V tile feeds all G heads (a block per query
// head would load it G times). One TMA box (64 values of D by the G heads by
// the QB queries) brings the tile's Q in exactly that row order, zeros
// past Sq; 63 of 64 rows are used at G = 7. Each row's query index gives
// its causal limit and window.
//
// A producer warp issues the Q load once and the K/V tiles (64 keys, one
// box per 64 values of D, zeros past Skv) through a ring of two stages,
// one `full` and one `empty` mbarrier a stage, the first two before the
// block's barrier. One consumer warpgroup runs S = Q K^T as wgmma with Q
// (A) and K (B) K-major from shared memory, the online softmax on the
// fp32 accumulators as in the fp32 kernel (a lane holds two rows; max and
// sum over the four lanes of a quad; ex2.approx with log2(e) in the
// scale; the running sum takes the unrounded P), then O += P V with P
// rounded to bf16 as the register A operand (two neighbouring score
// column tiles make one k16 step as they stand) and V an MN-major B. The
// causal stop after the tile's last query and the window's first tile
// are the fp32 kernel's, over the tile's query range. Issuing the next
// tile's S under this tile's softmax (with P V under the next one's) made
// ptxas serialize the products (C7515: registers a product accumulates
// into are written while another is in flight) and took the cross shape
// from 0.022 to 0.031 ms on an H100, so each tile's products are waited
// before its softmax. No split over the keys: at the cross shape 64
// blocks each walk 16 K/V tiles and the kernel is at SDPA's time. D is 16,
// 32, 64 or 128: a head dim under 64 fills the 64-wide tiles with TMA's
// zeros and only its own k16 steps and columns run. At most 64 query heads
// a KV head.
//
// C interface: launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "hopper_bf16.cuh"
#include "mma_tf32x3.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hopper::Wgmma;
using tf32x3::fast_exp2;

constexpr int THREADS = 160;   // one consumer warpgroup, one producer warp
constexpr int BM = 64;         // rows per block
constexpr int BK = 64;         // K/V rows per tile
constexpr int NS = 2;          // stages of the ring
constexpr int BLK = 64 * 128;  // bytes of a [64][64] bf16 tile
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Smem {
  static constexpr int DB = D <= 64 ? 1 : 2;   // column blocks of D
  unsigned char q[DB][BLK];
  struct __align__(1024) Stage {
    unsigned char k[DB][BLK];
    unsigned char v[DB][BLK];
  };
  Stage stage[NS];
  uint64_t qbar, full[NS], empty[NS];
};

template <int D>
__global__ void __launch_bounds__(THREADS, 2) flash_attention_bf16_kernel(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
    float* __restrict__ lse, int64_t Sq, int64_t Skv, int64_t H, int G,
    int QB, int causal, int64_t window, float scale_log2) {
  constexpr int DB = Smem<D>::DB;
  constexpr int DK = D / 16;   // k16 steps of Q K^T
  constexpr int NT = BK / 8;   // column tiles of S
  constexpr int KT = D / 8;    // column tiles of O
  extern __shared__ unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int rows = G * QB;   // rows of the tile in use
  const int64_t i_first = static_cast<int64_t>(blockIdx.x) * QB;
  const int64_t i_last = (i_first + QB < Sq ? i_first + QB : Sq) - 1;

  int64_t lo = 0, hi = Skv;
  if (causal) {
    hi = i_last + 1 < Skv ? i_last + 1 : Skv;
    // Start at the window's first tile, unless a row sees no key at all.
    if (window > 0 && i_last < Skv - 1 + window) {
      const int64_t first = i_first - window + 1;
      lo = first > 0 ? first / BK * BK : 0;
    }
  }
  const int ntiles = lo < hi ? static_cast<int>((hi - lo + BK - 1) / BK) : 0;

  // K/V tile it (64 keys from lo + 64 it) into stage it % NS.
  const auto load_tile = [&](int it) {
    const int s = it % NS;
    hopper::mbar_arrive_expect_tx(&sm.full[s], 2 * DB * BLK);
    const int j0 = static_cast<int>(lo) + it * BK;
    for (int db = 0; db < DB; ++db) {
      hopper::tma_load_4d(sm.stage[s].k[db], &map_k, &sm.full[s], 64 * db,
                          kvh, j0, b);
      hopper::tma_load_4d(sm.stage[s].v[db], &map_v, &sm.full[s], 64 * db,
                          kvh, j0, b);
    }
  };
  if (tid == 4 * 32) {
    // The producer's lane: the barriers, then Q and the first tiles at
    // once, while the other threads set up.
    hopper::prefetch_map(&map_q);
    hopper::prefetch_map(&map_k);
    hopper::prefetch_map(&map_v);
    hopper::mbar_init(&sm.qbar, 1);
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&sm.full[s], 1);
      hopper::mbar_init(&sm.empty[s], 4);   // the consumer's warps
    }
    hopper::fence_barrier_init();
    hopper::mbar_arrive_expect_tx(&sm.qbar,
                                  static_cast<uint32_t>(DB * rows * 128));
    for (int db = 0; db < DB; ++db)
      hopper::tma_load_4d(sm.q[db], &map_q, &sm.qbar, 64 * db, kvh * G,
                          static_cast<int>(i_first), b);
    for (int it = 0; it < NS && it < ntiles; ++it) load_tile(it);
  }
  if (rows < BM) {   // rows past the box stay zero
    for (int e = tid; e < DB * (BM - rows) * 8; e += THREADS) {
      const int u = e & 7, r = rows + (e >> 3) % (BM - rows);
      *reinterpret_cast<uint4*>(sm.q[(e >> 3) / (BM - rows)] + r * 128 +
                                u * 16) = make_uint4(0, 0, 0, 0);
    }
    hopper::fence_async_smem();
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: the rest of the K/V ring ---------------------------
    if (lane == 0) {
      for (int it = NS; it < ntiles; ++it) {
        hopper::mbar_wait(&sm.empty[it % NS], ((it / NS) - 1) & 1);
        load_tile(it);
      }
    }
    return;
  }

  // ---- consumer warpgroup ----------------------------------------------
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g, r1 = r0 + 8;    // the lane's two rows
  const int64_t i0 = i_first + r0 / G, i1 = i_first + r1 / G;   // queries
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f;

  hopper::mbar_wait(&sm.qbar, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % NS;
    const int64_t j0 = lo + static_cast<int64_t>(it) * BK;
    hopper::mbar_wait(&sm.full[s], (it / NS) & 1);
    const auto& stg = sm.stage[s];

    float sf[BK / 2];   // S: column tile j at sf[4j..4j+3]
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < DK; ++kk)
      Wgmma<BK>::ss<0, 0>(sf, hopper::desc_k(sm.q[0], kk, BLK),
                          hopper::desc_k(stg.k[0], kk, BLK), kk > 0);
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::fence_regs(sf);

    const bool need_mask =
        j0 + BK > Skv ||
        (causal && (j0 + BK - 1 > i_first ||
                    (window > 0 && i_last - j0 >= window)));
    // In tile columns c: keys end at `left`; row i sees lo_i <= c <= hi_i
    // (causal: c <= i - j0, and with a window c > i - j0 - window).
    const int left = static_cast<int>(Skv - j0 < BK ? Skv - j0 : BK);
    int hi0 = BK, hi1 = BK, lo0 = -1, lo1 = -1;
    if (causal) {
      const int64_t d0 = i0 - j0, d1 = i1 - j0;
      hi0 = static_cast<int>(d0 < BK ? d0 : BK);
      hi1 = static_cast<int>(d1 < BK ? d1 : BK);
      if (window > 0) {
        const int64_t f0 = d0 - window + 1, f1 = d1 - window + 1;
        lo0 = static_cast<int>(f0 > -1 ? (f0 < BK ? f0 : BK) : -1);
        lo1 = static_cast<int>(f1 > -1 ? (f1 < BK ? f1 : BK) : -1);
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = sf[4 * j + e] * scale_log2;
        if (need_mask) {
          const int c = j * 8 + 2 * t + (e & 1);
          const int hi_c = e < 2 ? hi0 : hi1, lo_c = e < 2 ? lo0 : lo1;
          if (c >= left)
            val = -INFINITY;            // past the keys: takes no part
          else if (c > hi_c || c < lo_c)
            val = MASKED;
        }
        sf[4 * j + e] = val;
      }
      mx0 = fmaxf(mx0, fmaxf(sf[4 * j], sf[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sf[4 * j + 2], sf[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float al0 = fast_exp2(m0 - mx0), al1 = fast_exp2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int nt = 0; nt < KT; ++nt) {
      acc[4 * nt] *= al0;
      acc[4 * nt + 1] *= al0;
      acc[4 * nt + 2] *= al1;
      acc[4 * nt + 3] *= al1;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      sf[4 * j] = fast_exp2(sf[4 * j] - mx0);
      sf[4 * j + 1] = fast_exp2(sf[4 * j + 1] - mx0);
      sf[4 * j + 2] = fast_exp2(sf[4 * j + 2] - mx1);
      sf[4 * j + 3] = fast_exp2(sf[4 * j + 3] - mx1);
      l0 += sf[4 * j] + sf[4 * j + 1];
      l1 += sf[4 * j + 2] + sf[4 * j + 3];
    }
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) hopper::acc_pair_as_a(pa[kk], sf, kk);
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<D>::template rs<1>(acc, pa[kk],
                               hopper::desc_mn(stg.v[0], kk, BLK), 1);
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(&sm.empty[s]);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const bool ok0 = r0 < rows && i0 < Sq, ok1 = r1 < rows && i1 < Sq;
  const int64_t h0 = static_cast<int64_t>(kvh) * G + r0 % G;
  const int64_t h1 = static_cast<int64_t>(kvh) * G + r1 % G;
  bf16* ob0 = o + ((b * Sq + i0) * H + h0) * D;
  bf16* ob1 = o + ((b * Sq + i1) * H + h1) * D;
#pragma unroll
  for (int nt = 0; nt < KT; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (ok0)
      *reinterpret_cast<uint32_t*>(ob0 + c) =
          hopper::pack(acc[4 * nt] * inv0, acc[4 * nt + 1] * inv0);
    if (ok1)
      *reinterpret_cast<uint32_t*>(ob1 + c) =
          hopper::pack(acc[4 * nt + 2] * inv1, acc[4 * nt + 3] * inv1);
  }
  // As in the fp32 kernel: lse = (m + log2 l) ln 2, -1e30 for a row that
  // sees no key.
  if (lse != nullptr && t == 0) {
    if (ok0)
      lse[(b * H + h0) * Sq + i0] =
          m0 <= MASKED ? MASKED : (m0 + log2f(l0)) * LN2;
    if (ok1)
      lse[(b * H + h1) * Sq + i1] =
          m1 <= MASKED ? MASKED : (m1 + log2f(l1)) * LN2;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, bf16* o, float* lse,
           int64_t B, int64_t Sq, int64_t Skv, int64_t H, int64_t KV,
           const int64_t* qst, const int64_t* kst, const int64_t* vst,
           int causal, int64_t window, cudaStream_t stream) {
  const int G = static_cast<int>(H / KV), QB = BM / G;
  // q (B, Sq, H, D) as (D, H, Sq, B), its box the G heads of a KV head by
  // QB queries; k and v (B, Skv, KV, D) as (D, KV, Skv, B), 64 keys a box
  CUtensorMap mq, mk, mv;
  const int64_t qd[4] = {D, H, Sq, B}, kd[4] = {D, KV, Skv, B};
  const int qbox[4] = {64, G, QB, 1}, kbox[4] = {64, 1, BK, 1};
  int err = hopper::make_map(&mq, q, 4, qd, qst, qbox);
  if (err == 0) err = hopper::make_map(&mk, k, 4, kd, kst, kbox);
  if (err == 0) err = hopper::make_map(&mv, v, 4, kd, vst, kbox);
  if (err != 0) return err;
  const int smem = static_cast<int>(sizeof(Smem<D>)) + 1024;
  err = hopper::allow_smem<flash_attention_bf16_kernel<D>>(smem);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>((Sq + QB - 1) / QB),
                  static_cast<unsigned>(KV), static_cast<unsigned>(B));
  flash_attention_bf16_kernel<D><<<grid, THREADS, smem, stream>>>(
      mq, mk, mv, o, lse, Sq, Skv, H, G, QB, causal, window,
      LOG2E / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_bf16_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int64_t B, int64_t Sq, int64_t Skv, int64_t H, int64_t KV, int64_t D,
    int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
    int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, int64_t causal,
    int64_t window, void* stream) {
  // TMA reads q, k and v: 16-byte aligned bases, strides in multiples of 8
  // values (the wrapper's rule)
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (KV <= 0 || H % KV != 0 || H / KV > BM || KV > 65535 || B > 65535 ||
      !aligned(q) || !aligned(k) || !aligned(v) || qsb % 8 || qss % 8 ||
      qsh % 8 || ksb % 8 || kss % 8 || ksh % 8 || vsb % 8 || vss % 8 ||
      vsh % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* ob = static_cast<bf16*>(o);
  auto* lf = static_cast<float*>(lse);   // may be null: no lse written
  const int64_t qst[3] = {qsh, qss, qsb}, kst[3] = {ksh, kss, ksb};
  const int64_t vst[3] = {vsh, vss, vsb};
  const auto st = static_cast<cudaStream_t>(stream);
  const int cz = causal ? 1 : 0;
  switch (D) {
    case 16:
      return launch<16>(q, k, v, ob, lf, B, Sq, Skv, H, KV, qst, kst, vst, cz,
                        window, st);
    case 32:
      return launch<32>(q, k, v, ob, lf, B, Sq, Skv, H, KV, qst, kst, vst, cz,
                        window, st);
    case 64:
      return launch<64>(q, k, v, ob, lf, B, Sq, Skv, H, KV, qst, kst, vst, cz,
                        window, st);
    case 128:
      return launch<128>(q, k, v, ob, lf, B, Sq, Skv, H, KV, qst, kst, vst,
                         cz, window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
