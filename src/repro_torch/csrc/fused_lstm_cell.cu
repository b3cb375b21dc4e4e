// Dense fused LSTM cell:
//   y = xh @ w + b      (xh: (B, K) = concat[x, h]; w: (K, 4H), [i|f|g|o])
//   c' = sigmoid(y_f) * c + sigmoid(y_i) * tanh(y_g)
//   h' = sigmoid(y_o) * tanh(c')
//
// Replaces the TPU kernel src/repro/kernels/fused_cell.py:
// fused_lstm_cell_kernel (a (B/bm, H/bn, K/bk) grid with K innermost, an
// fp32 (bm, 4 bn) VMEM accumulator carried across the K steps, w viewed as
// (K, 4, H) so one tile holds all four gates of an H range, the epilogue
// on the last K step; B, H and K must be multiples of the tiles).
//
// Bound and design: lstm_cell_tile.cuh, shared with the gathered cell. A
// GPU block cannot carry an accumulator across a sequential grid axis, so
// the K loop runs inside the block, split over its warps, and the block
// holds all four gates of its 8 hidden units: the epilogue needs no second
// pass and no global scratch. Neighbouring lanes read neighbouring k of a
// row of xh (coalesced). Ragged B, H and K are masked, so no shape is
// refused.
//
// C interface: launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include "lstm_cell_tile.cuh"

namespace {

using lstm_tile::BM;
using lstm_tile::BN;
using lstm_tile::THREADS;

// Tile row m is row m0 + m of xh.
struct DenseRows {
  const float* __restrict__ xh;
  const float* __restrict__ c;
  int64_t m0, B, K, H;

  __device__ __forceinline__ float a(int m, int64_t k) const {
    const int64_t row = m0 + m;
    return (row < B && k < K) ? __ldg(xh + row * K + k) : 0.0f;
  }

  __device__ __forceinline__ float c_prev(int64_t row, int64_t col) const {
    return c[row * H + col];
  }
};

__global__ void __launch_bounds__(THREADS) fused_lstm_cell_kernel(
    const float* __restrict__ xh, const float* __restrict__ w,
    const float* __restrict__ b, const float* __restrict__ c,
    float* __restrict__ h_out, float* __restrict__ c_out, int64_t B,
    int64_t K, int64_t H) {
  const DenseRows rows{xh, c, static_cast<int64_t>(blockIdx.y) * BM, B, K, H};
  lstm_tile::cell_tile(rows, w, b, h_out, c_out, B, K, H);
}

}  // namespace

extern "C" int fused_lstm_cell_launch(const void* xh, const void* w,
                                      const void* b, const void* c,
                                      void* h_out, void* c_out, int64_t B,
                                      int64_t K, int64_t H, void* stream) {
  const dim3 grid(static_cast<unsigned>((H + BN - 1) / BN),
                  static_cast<unsigned>((B + BM - 1) / BM));
  fused_lstm_cell_kernel<<<grid, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xh), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<float*>(h_out), static_cast<float*>(c_out), B, K, H);
  return static_cast<int>(cudaGetLastError());
}
