// One tile of the LSTM cell, shared by the dense kernel
// (fused_lstm_cell.cu) and the gathered one (fused_gather_lstm_cell.cu):
//   y = a @ w + b      (a: the tile's BM rows of K values; w: (K, 4H), [i|f|g|o])
//   c' = sigmoid(y_f) * c + sigmoid(y_i) * tanh(y_g)
//   h' = sigmoid(y_o) * tanh(c')
//
// Bound on the H100: bytes. At the path's widths (K = 1024, H = 512,
// B <= 32) the weight matrix is K * 4H * 4 B = 8 MB per launch, about
// 2.5 us at 3.35 TB/s, while the 2 * B * K * 4H fp32 FMAs take about 1 us
// at B = 16 on the 67 TFLOP/s fp32 pipes. Rows and outputs are a few tens
// of KB.
//
// Design: each block owns BM output rows x BN hidden units, i.e. the 4 * BN
// gate columns that hold the same hidden units of all four gates, so the
// LSTM epilogue needs nothing from another block and no second pass. One
// lane of a warp owns one gate column. The K reduction is split across the
// block's warps in KC-deep chunks: per chunk a warp stages its BM x KC
// slice of the rows in shared memory, each lane loads its KC weights into
// registers (coalesced 32-byte runs), and fp32 FMAs accumulate BM sums per
// lane in registers. The loads of a warp's next chunk start before the
// FMAs of the current one, so memory latency overlaps compute. The warps'
// partial sums meet in shared memory and one thread per (row, unit) adds
// the bias and applies the gate math. Everything stays fp32 (no TF32), so
// the kernels hold against their plain versions at 1e-4. Any B, K and H:
// the ragged tile is masked. Tensor cores (wgmma), TMA and bf16 weights are
// left for later work.
//
// A kernel supplies the rows through a `Rows` type with two members:
//   float a(int m, int64_t k)           element k of the tile's row m, or 0
//                                       past K or for a row past B;
//   float c_prev(int64_t row, int64_t col)  the previous cell state.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace lstm_tile {

constexpr int BN = 8;      // hidden units per block: 4 * BN = 32 gate columns
constexpr int BM = 16;     // output rows per block
constexpr int KC = 32;     // reduction depth a warp takes per step
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
static_assert(4 * BN == 32, "one lane per gate column");

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// One lane's share of a KC-deep chunk starting at k0: column k0 + lane of
// the BM rows, and its gate column's KC weights. All loads are
// independent, so they go out back to back.
template <class Rows>
__device__ __forceinline__ void load_chunk(
    const Rows& rows, int64_t k0, int lane, const float* __restrict__ w,
    int64_t K, int64_t H, bool col_ok, int64_t w_col, float (&av)[BM],
    float (&wv)[KC]) {
#pragma unroll
  for (int m = 0; m < BM; ++m) av[m] = rows.a(m, k0 + lane);
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    const int64_t kk = k0 + j;
    wv[j] = (col_ok && kk < K) ? __ldg(w + kk * 4 * H + w_col) : 0.0f;
  }
}

// The block's tile: rows blockIdx.y * BM.., hidden units blockIdx.x * BN..
template <class Rows>
__device__ __forceinline__ void cell_tile(
    const Rows& rows, const float* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ h_out,
    float* __restrict__ c_out, int64_t B, int64_t K, int64_t H) {
  __shared__ __align__(16) float a_tile[WARPS][BM][KC];
  __shared__ float partial[WARPS][BM][4 * BN];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;

  // Lane -> gate column: gate = lane / BN, hidden unit n0 + lane % BN.
  const int64_t n = n0 + lane % BN;
  const bool col_ok = n < H;
  const int64_t w_col = (lane / BN) * H + n;

  float acc[BM];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m] = 0.0f;

  // Software pipeline: the loads of a warp's next chunk are in flight while
  // it runs the FMAs of the current one.
  float av[BM], wv[KC];
  const int64_t n_chunks = (K + KC - 1) / KC;
  int64_t chunk = warp;
  if (chunk < n_chunks)
    load_chunk(rows, chunk * KC, lane, w, K, H, col_ok, w_col, av, wv);
  for (; chunk < n_chunks; chunk += WARPS) {
#pragma unroll
    for (int m = 0; m < BM; ++m) a_tile[warp][m][lane] = av[m];
    float wc[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) wc[j] = wv[j];
    __syncwarp();
    if (chunk + WARPS < n_chunks)
      load_chunk(rows, (chunk + WARPS) * KC, lane, w, K, H, col_ok, w_col,
                 av, wv);
#pragma unroll
    for (int j = 0; j < KC; j += 4) {
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const float4 a = *reinterpret_cast<const float4*>(&a_tile[warp][m][j]);
        acc[m] = fmaf(a.x, wc[j], acc[m]);
        acc[m] = fmaf(a.y, wc[j + 1], acc[m]);
        acc[m] = fmaf(a.z, wc[j + 2], acc[m]);
        acc[m] = fmaf(a.w, wc[j + 3], acc[m]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int m = 0; m < BM; ++m) partial[warp][m][lane] = acc[m];
  __syncthreads();

  for (int t = threadIdx.x; t < BM * BN; t += THREADS) {
    const int m = t / BN, u = t % BN;
    const int64_t row = m0 + m, col = n0 + u;
    if (row >= B || col >= H) continue;
    float y[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float s = 0.0f;
#pragma unroll
      for (int p = 0; p < WARPS; ++p) s += partial[p][m][g * BN + u];
      y[g] = s + b[g * H + col];
    }
    const float i_g = sigmoid_f(y[0]);
    const float f_g = sigmoid_f(y[1]);
    const float g_g = tanhf(y[2]);
    const float o_g = sigmoid_f(y[3]);
    const float c_new = f_g * rows.c_prev(row, col) + i_g * g_g;
    c_out[row * H + col] = c_new;
    h_out[row * H + col] = o_g * tanhf(c_new);
  }
}

}  // namespace lstm_tile
