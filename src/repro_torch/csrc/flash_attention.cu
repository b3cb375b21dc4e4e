// Blockwise (flash) attention with grouped KV heads, fp32:
//   o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / G] * D^-0.5) v[b, j, h / G]
// with column j masked (score -1e30) when causal and j > i, or when a
// window is set and i - j >= window. Given an `lse` pointer it also writes
// each row's log-sum-exp of the scaled, masked scores (natural log,
// (B, H, Sq) fp32), which the backward kernel (flash_attention_bwd.cu)
// recomputes the softmax from; without one it writes nothing else and
// its output is unchanged.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention.py:flash_attention_kernel (grid
// (batch * heads, q blocks, kv blocks) with the kv axis sequential and the
// running max, sum and accumulator in VMEM scratch; blocks above the
// diagonal masked, not skipped; S a multiple of the block).
//
// Bound on the H100: at the path's shapes (Qwen2-0.5B prefill: 14 query
// heads over 2 KV heads, D = 64, S of 32 to 96, fp32) bytes and
// operations are both tiny: S = 96, B = 4 moves about 3.1 MB (0.94 us at
// 3.35 TB/s) and does about 67 MFLOP over the causal pairs (0.41 us at
// the 165 TFLOP/s of 3xTF32 on the tensor cores). The launch and the
// dependent steps of one block's K/V loop are the time.
//
// Design: one block per (batch * head, 64 query rows), four warps of 16
// rows each. Both products run on the tensor cores as 3xTF32 m16n8k8
// steps (mma_tf32x3.cuh), which keep the fp32 plain version's accuracy:
// S = Q K^T over D (a warp keeps its Q rows in registers and splits them
// per step), then O += P V with the score accumulator fed back as the A
// operand (the paired k order of the header: no shuffle, no shared-memory
// stage). Tiles that share an operand are issued term by term, so
// consecutive tensor-core steps do not wait on each other (a warp issues
// in order). The online softmax runs on the accumulator fragments: a lane
// holds two rows, whose max and sum are reduced over the four lanes of a
// quad (xor shuffles 1 and 2; the sum only once, at the end), with
// ex2.approx and log2(e) folded into the scale. K/V tiles of 64 rows (32
// at D = 128) go through two shared-memory stages filled by cp.async (16
// bytes a thread, zero-filled past Skv): tile j + 1 is in flight while
// tile j computes. Rows are padded to D + 4 floats, so the fragment reads of both
// products hit 32 banks. When causal the loop stops at the block's
// diagonal, a warp skips the tiles wholly above its own, and with a
// window the loop starts at the first tile the window reaches (unless a
// row of the block sees no key at all, as when Sq > Skv: then, as in the
// plain version, it averages every key). The mask is applied only on
// tiles that need it (the diagonal, the window's edge, the ragged end).
// The kv head is read as h / G, so K and V are never copied per query
// head; the layout is (B, S, H, D), addressed by the strides passed in.
// Masked in-range columns score -1e30 and columns past Skv -inf, and the
// running max starts at -1e30, so a fully masked row gives what the plain
// version gives. TMA, wgmma and bf16 are left for later work.
//
// C interface: launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "mma_tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;   // query rows per block
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Tile {
  static constexpr int BK = D <= 64 ? 64 : 32;   // K/V rows per tile
  static constexpr int LD = D + 4;               // padded row, in floats
  static constexpr int STAGE = BK * LD;          // floats per K or V stage
  static constexpr int SMEM = 2 * 2 * STAGE * 4; // two stages of K and V
};

template <int D>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int64_t Sq,
    int64_t Skv, int64_t H, int64_t G, int64_t qsb, int64_t qss, int64_t qsh,
    int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
    int64_t vsh, int causal, int64_t window, float scale_log2) {
  constexpr int BK = Tile<D>::BK, LD = Tile<D>::LD, STAGE = Tile<D>::STAGE;
  constexpr int KT = D / 8;    // k-steps of Q K^T, and n-tiles of O
  constexpr int NT = BK / 8;   // n-tiles of S, and k-steps of P V
  constexpr int C4 = D / 4;    // 16-byte chunks per K/V row
  constexpr int GR = KT < 4 ? KT : 4;   // O tiles issued together
  static_assert(NT % 4 == 0 && KT % GR == 0, "tiles issued in groups");
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                // [2][BK][LD]
  float* vs = smem + 2 * STAGE;    // [2][BK][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / H, h = bh % H, kvh = h / G;
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * BQ;
  const int64_t r0 = q0 + 16 * warp;      // the warp's first row
  const int64_t i0 = r0 + g, i1 = i0 + 8; // the lane's two rows

  // The warp's Q rows as A fragments, raw fp32 (split at each use).
  float qf[KT][4];
  {
    const float* qb = q + b * qsb + h * qsh;
    const bool ok0 = i0 < Sq, ok1 = i1 < Sq;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const int c = kk * 8 + t;
      qf[kk][0] = ok0 ? qb[i0 * qss + c] : 0.f;
      qf[kk][1] = ok1 ? qb[i1 * qss + c] : 0.f;
      qf[kk][2] = ok0 ? qb[i0 * qss + c + 4] : 0.f;
      qf[kk][3] = ok1 ? qb[i1 * qss + c + 4] : 0.f;
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
  const float* kbase = k + b * ksb + kvh * ksh;
  const float* vbase = v + b * vsb + kvh * vsh;

  auto load_tile = [&](int64_t j0, int stage) {
    float* kd = ks + stage * STAGE;
    float* vd = vs + stage * STAGE;
    for (int e = tid; e < BK * C4; e += THREADS) {
      const int jr = e / C4, cc = e % C4;
      const int64_t j = j0 + jr;
      const bool valid = j < Skv;
      const int64_t js = valid ? j : 0;   // a mapped address either way
      cp_async16(kd + jr * LD + 4 * cc, kbase + js * kss + 4 * cc, valid);
      cp_async16(vd + jr * LD + 4 * cc, vbase + js * vss + 4 * cc, valid);
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
      const float* kt = ks + (it & 1) * STAGE;
      const float* vt = vs + (it & 1) * STAGE;
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const FragA a = split_a(qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
#pragma unroll
        for (int jb = 0; jb < NT; jb += 4) {
          FragB kb[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            kb[u] = load_b_nk(kt, LD, (jb + u) * 8, kk * 8, lane);
          mma3_row<4>(&s[jb], a, kb);
        }
      }

      const bool need_mask =
          j0 + BK > Skv ||
          (causal && (j0 + BK - 1 > r0 ||
                      (window > 0 && r0 + 15 - j0 >= window)));
      // In tile columns c (32-bit): keys end at `left`; row i sees
      // lo_i <= c <= hi_i (causal: c <= i - j0, and with a window
      // c > i - j0 - window).
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
      for (int j = 0; j < NT; ++j) {
        const FragA pa = acc_as_a(s[j]);
#pragma unroll
        for (int nb = 0; nb < KT; nb += GR) {
          FragB vb[GR];
#pragma unroll
          for (int u = 0; u < GR; ++u)
            vb[u] = load_b_paired(vt, LD, j * 8, (nb + u) * 8, lane);
          mma3_row<GR>(&acc[nb], pa, vb);
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
  float* ob = o + (b * Sq * H + h) * D;
#pragma unroll
  for (int nt = 0; nt < KT; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (i0 < Sq)
      *reinterpret_cast<float2*>(ob + i0 * H * D + c) =
          make_float2(acc[nt][0] * inv0, acc[nt][1] * inv0);
    if (i1 < Sq)
      *reinterpret_cast<float2*>(ob + i1 * H * D + c) =
          make_float2(acc[nt][2] * inv1, acc[nt][3] * inv1);
  }
  // The running max and sum are in base 2 (log2(e) is in the scale):
  // lse = (m + log2 l) ln 2. A row that sees no key has m = -1e30 and
  // averages every key; its scores are all -1e30, and so is its lse.
  if (lse != nullptr && t == 0) {
    float* lb = lse + (b * H + h) * Sq;
    if (i0 < Sq) lb[i0] = m0 <= MASKED ? MASKED : (m0 + log2f(l0)) * LN2;
    if (i1 < Sq) lb[i1] = m1 <= MASKED ? MASKED : (m1 + log2f(l1)) * LN2;
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int64_t B, int64_t Sq, int64_t Skv, int64_t H,
           int64_t G, int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
           int64_t kss, int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
           int causal, int64_t window, cudaStream_t stream) {
  constexpr int smem = Tile<D>::SMEM;
  // The shared-memory limit is a per-device attribute: set it once on each
  // device a launch reaches.
  constexpr int MAX_DEVICES = 64;
  static bool configured[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= MAX_DEVICES || !configured[device]) {
    err = cudaFuncSetAttribute(flash_attention_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < MAX_DEVICES) configured[device] = true;
  }
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((Sq + BQ - 1) / BQ));
  flash_attention_kernel<D><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, lse, Sq, Skv, H, G, qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
      vsh, causal, window, LOG2E / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int64_t B, int64_t Sq, int64_t Skv, int64_t H, int64_t KV, int64_t D,
    int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
    int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, int64_t causal,
    int64_t window, void* stream) {
  if (KV <= 0 || H % KV != 0 || (Sq + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  auto* lf = static_cast<float*>(lse);   // may be null: no lse written
  const int64_t G = H / KV;
  const auto st = static_cast<cudaStream_t>(stream);
  const int cz = causal ? 1 : 0;
  switch (D) {
    case 16:
      return launch<16>(qf, kf, vf, of, lf, B, Sq, Skv, H, G, qsb, qss, qsh,
                        ksb, kss, ksh, vsb, vss, vsh, cz, window, st);
    case 32:
      return launch<32>(qf, kf, vf, of, lf, B, Sq, Skv, H, G, qsb, qss, qsh,
                        ksb, kss, ksh, vsb, vss, vsh, cz, window, st);
    case 64:
      return launch<64>(qf, kf, vf, of, lf, B, Sq, Skv, H, G, qsb, qss, qsh,
                        ksb, kss, ksh, vsb, vss, vsh, cz, window, st);
    case 128:
      return launch<128>(qf, kf, vf, of, lf, B, Sq, Skv, H, G, qsb, qss, qsh,
                         ksb, kss, ksh, vsb, vss, vsh, cz, window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
