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
// dependent steps of one block's K/V loop are the time.
//
// Design: the fp32 kernel's (csrc/flash_attention.cu), with bf16 tensor-
// core steps in place of 3xTF32. One block per (batch * head, 64 query
// rows), four warps of 16 rows each. S = Q K^T is m16n8k16 bf16 steps with
// fp32 accumulators (mma_bf16.cuh): a warp keeps its Q rows in registers
// as A fragments, read from device memory as bf16 pairs, and reads K's
// B fragments as 32-bit pairs along its rows. The online softmax runs in
// fp32 on the accumulators as in the fp32 kernel (a lane holds two rows;
// max and sum over the four lanes of a quad; ex2.approx with log2(e) in
// the scale; the running sum takes the unrounded P). Then O += P V: each
// two neighbouring 8-column score tiles, rounded to bf16, are the A
// fragment of one 16-key step as they stand (no shuffle, no shared-memory
// stage), and V's B fragments come from ldmatrix.trans. K/V tiles of 64
// rows go through two shared-memory stages filled by cp.async (16 bytes,
// 8 values, a thread; zero-filled past Skv): tile j + 1 is in flight while
// tile j computes. Rows are padded to D + 8 values (an odd number of 16-
// byte units), so the K pair reads and V's ldmatrix rows hit distinct
// banks; two stages of K and V take 68 KB at D = 128. The causal stop at
// the diagonal, the warp's skip of tiles wholly above its rows, the
// window's first tile and the masks are the fp32 kernel's. The kv head is
// read as h / G in place. wgmma and TMA are left for later work.
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
using tf32x3::cp_async16;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;
using tf32x3::fast_exp2;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;   // query rows per block
constexpr int BK = 64;           // K/V rows per tile
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Tile {
  static constexpr int LD = D + 8;                // padded row, in values
  static constexpr int STAGE = BK * LD;           // values per K or V stage
  static constexpr int SMEM = 2 * 2 * STAGE * 2;  // two stages of K and V
};

template <int D>
__global__ void __launch_bounds__(THREADS) flash_attention_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o,
    float* __restrict__ lse, int64_t Sq, int64_t Skv, int64_t H, int64_t G,
    int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
    int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, int causal,
    int64_t window, float scale_log2) {
  constexpr int LD = Tile<D>::LD, STAGE = Tile<D>::STAGE;
  constexpr int KQ = D / 16;   // k-steps of Q K^T
  constexpr int KT = D / 8;    // n-tiles of O
  constexpr int NT = BK / 8;   // n-tiles of S
  constexpr int C8 = D / 8;    // 16-byte chunks per K/V row
  static_assert(KT % 2 == 0 && NT % 2 == 0, "tiles go in pairs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [2][BK][LD]
  bf16* vs = ks + 2 * STAGE;                      // [2][BK][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / H, h = bh % H, kvh = h / G;
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * BQ;
  const int64_t r0 = q0 + 16 * warp;      // the warp's first row
  const int64_t i0 = r0 + g, i1 = i0 + 8; // the lane's two rows

  // The warp's Q rows as A fragments: bf16 pairs, zero past Sq.
  uint32_t qf[KQ][4];
  {
    const bf16* qb = q + b * qsb + h * qsh;
    const bool ok0 = i0 < Sq, ok1 = i1 < Sq;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      const int c = kk * 16 + 2 * t;
      const auto at = [&](int64_t i, int col) {
        return *reinterpret_cast<const uint32_t*>(qb + i * qss + col);
      };
      qf[kk][0] = ok0 ? at(i0, c) : 0u;
      qf[kk][1] = ok1 ? at(i1, c) : 0u;
      qf[kk][2] = ok0 ? at(i0, c + 8) : 0u;
      qf[kk][3] = ok1 ? at(i1, c + 8) : 0u;
    }
  }
  float acc[KT][4];
#pragma unroll
  for (int nt = 0; nt < KT; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f;

  int64_t lo = 0, hi = Skv;
  if (causal) {
    const int64_t last = (q0 + BQ < Sq ? q0 + BQ : Sq) - 1;
    hi = last + 1 < Skv ? last + 1 : Skv;
    // Start at the window's first tile, unless a row sees no key at all.
    if (window > 0 && last < Skv - 1 + window) {
      const int64_t first = q0 - window + 1;
      lo = first > 0 ? first / BK * BK : 0;
    }
  }
  const bf16* kbase = k + b * ksb + kvh * ksh;
  const bf16* vbase = v + b * vsb + kvh * vsh;

  auto load_tile = [&](int64_t j0, int stage) {
    bf16* kd = ks + stage * STAGE;
    bf16* vd = vs + stage * STAGE;
    for (int e = tid; e < BK * C8; e += THREADS) {
      const int jr = e / C8, cc = e % C8;
      const int64_t j = j0 + jr;
      const bool valid = j < Skv;
      const int64_t js = valid ? j : 0;   // a mapped address either way
      cp_async16(kd + jr * LD + 8 * cc, kbase + js * kss + 8 * cc, valid);
      cp_async16(vd + jr * LD + 8 * cc, vbase + js * vss + 8 * cc, valid);
    }
    cp_async_commit();
  };

  const int64_t ntiles = lo < hi ? (hi - lo + BK - 1) / BK : 0;
  if (ntiles > 0) load_tile(lo, 0);
  for (int64_t it = 0; it < ntiles; ++it) {
    const int64_t j0 = lo + it * BK;
    if (it + 1 < ntiles)
      load_tile(j0 + BK, static_cast<int>((it + 1) & 1));
    else
      cp_async_commit();   // an empty group keeps the wait count uniform
    cp_async_wait<1>();    // tile it has landed
    __syncthreads();

    const bool live = r0 < Sq && !(causal && j0 > r0 + 15);
    if (live) {
      const bf16* kt = ks + (it & 1) * STAGE;
      const bf16* vt = vs + (it & 1) * STAGE;
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t kb[2];
          bf16mma::load_b_nk(kb, kt, LD, j * 8, kk * 16, lane);
          bf16mma::mma(s[j], qf[kk], kb);
        }
      }

      const bool need_mask =
          j0 + BK > Skv ||
          (causal && (j0 + BK - 1 > r0 ||
                      (window > 0 && r0 + 15 - j0 >= window)));
      // In tile columns c: keys end at `left`; row i sees lo_i <= c <=
      // hi_i (causal: c <= i - j0, and with a window c > i - j0 - window).
      const int left = static_cast<int>(Skv - j0 < BK ? Skv - j0 : BK);
      int hi0 = BK, hi1 = BK, lo0 = -1, lo1 = -1;
      if (causal) {
        const int64_t d0 = i0 - j0;
        hi0 = static_cast<int>(d0 < BK ? d0 : BK);
        hi1 = static_cast<int>(d0 + 8 < BK ? d0 + 8 : BK);
        if (window > 0) {
          const int64_t f0 = d0 - window + 1;
          lo0 = static_cast<int>(f0 > -1 ? (f0 < BK ? f0 : BK) : -1);
          lo1 = static_cast<int>(f0 + 8 > -1 ? (f0 + 8 < BK ? f0 + 8 : BK)
                                             : -1);
        }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float val = s[j][e] * scale_log2;
          if (need_mask) {
            const int c = j * 8 + 2 * t + (e & 1);
            const int hi = e < 2 ? hi0 : hi1, lo = e < 2 ? lo0 : lo1;
            if (c >= left)
              val = -INFINITY;            // past the keys: takes no part
            else if (c > hi || c < lo)
              val = MASKED;
          }
          s[j][e] = val;
        }
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
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
        acc[nt][0] *= al0;
        acc[nt][1] *= al0;
        acc[nt][2] *= al1;
        acc[nt][3] *= al1;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][0] = fast_exp2(s[j][0] - mx0);
        s[j][1] = fast_exp2(s[j][1] - mx0);
        s[j][2] = fast_exp2(s[j][2] - mx1);
        s[j][3] = fast_exp2(s[j][3] - mx1);
        l0 += s[j][0] + s[j][1];
        l1 += s[j][2] + s[j][3];
      }
#pragma unroll
      for (int js = 0; js < NT / 2; ++js) {
        uint32_t pa[4];
        bf16mma::acc_pair_as_a(pa, s[2 * js], s[2 * js + 1]);
#pragma unroll
        for (int nb = 0; nb < KT; nb += 2) {
          uint32_t vb0[2], vb1[2];
          bf16mma::load_b_kn_pair(vb0, vb1, vt, LD, js * 16, nb * 8, lane);
          bf16mma::mma(acc[nb], pa, vb0);
          bf16mma::mma(acc[nb + 1], pa, vb1);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* ob = o + (b * Sq * H + h) * D;
#pragma unroll
  for (int nt = 0; nt < KT; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (i0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + i0 * H * D + c) =
          bf16mma::pack(acc[nt][0] * inv0, acc[nt][1] * inv0);
    if (i1 < Sq)
      *reinterpret_cast<uint32_t*>(ob + i1 * H * D + c) =
          bf16mma::pack(acc[nt][2] * inv1, acc[nt][3] * inv1);
  }
  // As in the fp32 kernel: lse = (m + log2 l) ln 2, -1e30 for a row that
  // sees no key.
  if (lse != nullptr && t == 0) {
    float* lb = lse + (b * H + h) * Sq;
    if (i0 < Sq) lb[i0] = m0 <= MASKED ? MASKED : (m0 + log2f(l0)) * LN2;
    if (i1 < Sq) lb[i1] = m1 <= MASKED ? MASKED : (m1 + log2f(l1)) * LN2;
  }
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
           int64_t B, int64_t Sq, int64_t Skv, int64_t H, int64_t G,
           int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
           int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, int causal,
           int64_t window, cudaStream_t stream) {
  constexpr int smem = Tile<D>::SMEM;
  // The shared-memory limit is a per-device attribute: set it once on each
  // device a launch reaches.
  constexpr int MAX_DEVICES = 64;
  static bool configured[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= MAX_DEVICES || !configured[device]) {
    err = cudaFuncSetAttribute(flash_attention_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < MAX_DEVICES) configured[device] = true;
  }
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((Sq + BQ - 1) / BQ));
  flash_attention_bf16_kernel<D><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, lse, Sq, Skv, H, G, qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
      vsh, causal, window, LOG2E / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_bf16_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int64_t B, int64_t Sq, int64_t Skv, int64_t H, int64_t KV, int64_t D,
    int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
    int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, int64_t causal,
    int64_t window, void* stream) {
  if (KV <= 0 || H % KV != 0 || (Sq + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  auto* ob = static_cast<bf16*>(o);
  auto* lf = static_cast<float*>(lse);   // may be null: no lse written
  const int64_t G = H / KV;
  const auto st = static_cast<cudaStream_t>(stream);
  const int cz = causal ? 1 : 0;
  switch (D) {
    case 16:
      return launch<16>(qb, kb, vb, ob, lf, B, Sq, Skv, H, G, qsb, qss, qsh,
                        ksb, kss, ksh, vsb, vss, vsh, cz, window, st);
    case 32:
      return launch<32>(qb, kb, vb, ob, lf, B, Sq, Skv, H, G, qsb, qss, qsh,
                        ksb, kss, ksh, vsb, vss, vsh, cz, window, st);
    case 64:
      return launch<64>(qb, kb, vb, ob, lf, B, Sq, Skv, H, G, qsb, qss, qsh,
                        ksb, kss, ksh, vsb, vss, vsh, cz, window, st);
    case 128:
      return launch<128>(qb, kb, vb, ob, lf, B, Sq, Skv, H, G, qsb, qss, qsh,
                         ksb, kss, ksh, vsb, vss, vsh, cz, window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
