// Blockwise (flash) attention with grouped KV heads, fp32:
//   o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / G] * D^-0.5) v[b, j, h / G]
// with column j masked (score -1e30) when causal and j > i, or when a
// window is set and i - j >= window.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention.py:flash_attention_kernel (grid
// (batch * heads, q blocks, kv blocks) with the kv axis sequential and the
// running max, sum and accumulator in VMEM scratch; blocks above the
// diagonal masked, not skipped; S a multiple of the block).
//
// Bound on the H100: at the path's shapes (Qwen2-0.5B prefill: 14 query
// heads over 2 KV heads, D = 64, S of 32 to 256, fp32) bytes and
// operations are both tiny: S = 96, B = 4 moves about 3.1 MB (0.9 us at
// 3.35 TB/s) and does about 67 MFLOP over the causal pairs (1.0 us at
// 67 TFLOP/s fp32). The launch and the dependent steps of one block's K/V
// loop are the time.
//
// Design: one block per (batch * head, 32 query rows), four threads per
// query row, each owning a quarter of the head dim as float4 chunks
// interleaved so the four lanes of a row read 64 contiguous bytes of a
// K/V row in shared memory (no bank conflicts; the 8 rows of a warp
// broadcast). The block loops over 64-row K/V tiles (32 rows at D = 128)
// staged in shared memory: the loop takes the place of the TPU grid's
// sequential kv axis. A row's score is its four partial dot products
// summed by two xor shuffles; the running max and sum are per thread
// (the four lanes of a row hold the same values), the output accumulator
// is the thread's quarter in registers. When causal the loop stops at the
// block's diagonal, and with a window it starts at the first tile the
// window reaches: skipped tiles contribute nothing, as masking them does.
// The kv head is read as h / G in the kernel, so K and V are never copied
// out per query head. The layout is the port's (B, S, H, D), addressed by
// the strides the wrapper passes. A ragged last tile is masked in the
// kernel (columns past Skv take no part; rows past Sq are not written),
// so S need not be a multiple of the tile. Masked in-range columns score
// -1e30 and the running max starts at -1e30, as in the TPU kernel, so a
// row gives the same result the TPU kernel does. Tensor cores (wgmma),
// TMA and bf16 are left for later work.
//
// C interface: launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

namespace {

constexpr int TPR = 4;              // threads per query row
constexpr int BQ = 32;              // query rows per block
constexpr int THREADS = BQ * TPR;   // 128
constexpr float MASKED = -1e30f;

template <int D>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int64_t Sq,
    int64_t Skv, int64_t H, int64_t G, int64_t qsb, int64_t qss, int64_t qsh,
    int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
    int64_t vsh, int causal, int64_t window, float scale) {
  constexpr int BK = D <= 64 ? 64 : 32;   // K/V rows per tile
  constexpr int C4 = D / 4;               // float4 chunks per row
  constexpr int V4 = C4 / TPR;            // float4 chunks per thread
  static_assert(V4 >= 1 && C4 % TPR == 0, "D must be a multiple of 16");
  __shared__ __align__(16) float4 ks[BK][C4];
  __shared__ __align__(16) float4 vs[BK][C4];

  const int tid = threadIdx.x;
  const int r = tid / TPR, c = tid % TPR;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / H, h = bh % H, kvh = h / G;
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * BQ;
  const int64_t i = q0 + r;
  const bool row_ok = i < Sq;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // Thread c of a row owns the float4 chunks c, c + TPR, c + 2 TPR, ...
  float4 qv[V4], acc[V4];
  const float* qrow = q + b * qsb + i * qss + h * qsh;
#pragma unroll
  for (int t = 0; t < V4; ++t) {
    qv[t] = row_ok ? *reinterpret_cast<const float4*>(qrow + 4 * (c + TPR * t))
                   : zero;
    acc[t] = zero;
  }
  float m = MASKED, l = 0.f;

  int64_t lo = 0, hi = Skv;
  if (causal) {
    hi = q0 + BQ < Skv ? q0 + BQ : Skv;
    if (window > 0) {
      const int64_t first = q0 - window + 1;
      lo = first > 0 ? first / BK * BK : 0;
    }
  }
  const float* kbase = k + b * ksb + kvh * ksh;
  const float* vbase = v + b * vsb + kvh * vsh;

  for (int64_t j0 = lo; j0 < hi; j0 += BK) {
    __syncthreads();   // every thread is done with the previous tile
    for (int e = tid; e < BK * C4; e += THREADS) {
      const int jr = e / C4, cc = e % C4;
      const int64_t j = j0 + jr;
      float4 kk = zero, vv = zero;
      if (j < Skv) {
        kk = *reinterpret_cast<const float4*>(kbase + j * kss + 4 * cc);
        vv = *reinterpret_cast<const float4*>(vbase + j * vss + 4 * cc);
      }
      ks[jr][cc] = kk;
      vs[jr][cc] = vv;
    }
    __syncthreads();

    float s[BK];
    float tmax = MASKED;
#pragma unroll
    for (int jj = 0; jj < BK; ++jj) {
      float part = 0.f;
#pragma unroll
      for (int t = 0; t < V4; ++t) {
        const float4 kk = ks[jj][c + TPR * t];
        part = fmaf(qv[t].x, kk.x, part);
        part = fmaf(qv[t].y, kk.y, part);
        part = fmaf(qv[t].z, kk.z, part);
        part = fmaf(qv[t].w, kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int64_t j = j0 + jj;
      float sj;
      if (j >= Skv) {
        sj = -INFINITY;                  // past the keys: takes no part
      } else if (causal && (j > i || (window > 0 && i - j >= window))) {
        sj = MASKED;
      } else {
        sj = part * scale;
      }
      s[jj] = sj;
      tmax = fmaxf(tmax, sj);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int t = 0; t < V4; ++t) {
      acc[t].x *= alpha;
      acc[t].y *= alpha;
      acc[t].z *= alpha;
      acc[t].w *= alpha;
    }
#pragma unroll
    for (int jj = 0; jj < BK; ++jj) {
      const float p = expf(s[jj] - m_new);
      l += p;
#pragma unroll
      for (int t = 0; t < V4; ++t) {
        const float4 vv = vs[jj][c + TPR * t];
        acc[t].x = fmaf(p, vv.x, acc[t].x);
        acc[t].y = fmaf(p, vv.y, acc[t].y);
        acc[t].z = fmaf(p, vv.z, acc[t].z);
        acc[t].w = fmaf(p, vv.w, acc[t].w);
      }
    }
    m = m_new;
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
    float* orow = o + ((b * Sq + i) * H + h) * D;
#pragma unroll
    for (int t = 0; t < V4; ++t) {
      const float4 a = acc[t];
      *reinterpret_cast<float4*>(orow + 4 * (c + TPR * t)) =
          make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom);
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o,
           int64_t B, int64_t Sq, int64_t Skv, int64_t H, int64_t G,
           int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
           int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, int causal,
           int64_t window, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((Sq + BQ - 1) / BQ));
  flash_attention_kernel<D><<<grid, THREADS, 0, stream>>>(
      q, k, v, o, Sq, Skv, H, G, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
      causal, window, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int64_t B,
    int64_t Sq, int64_t Skv, int64_t H, int64_t KV, int64_t D, int64_t qsb,
    int64_t qss, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
    int64_t vsb, int64_t vss, int64_t vsh, int64_t causal, int64_t window,
    void* stream) {
  if (KV <= 0 || H % KV != 0 || (Sq + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  const int64_t G = H / KV;
  const auto st = static_cast<cudaStream_t>(stream);
  const int cz = causal ? 1 : 0;
  switch (D) {
    case 16:
      return launch<16>(qf, kf, vf, of, B, Sq, Skv, H, G, qsb, qss, qsh, ksb,
                        kss, ksh, vsb, vss, vsh, cz, window, st);
    case 32:
      return launch<32>(qf, kf, vf, of, B, Sq, Skv, H, G, qsb, qss, qsh, ksb,
                        kss, ksh, vsb, vss, vsh, cz, window, st);
    case 64:
      return launch<64>(qf, kf, vf, of, B, Sq, Skv, H, G, qsb, qss, qsh, ksb,
                        kss, ksh, vsb, vss, vsh, cz, window, st);
    case 128:
      return launch<128>(qf, kf, vf, of, B, Sq, Skv, H, G, qsb, qss, qsh, ksb,
                         kss, ksh, vsb, vss, vsh, cz, window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
