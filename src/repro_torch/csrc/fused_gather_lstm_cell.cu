// Fused gather -> LSTM cell:
//   y = concat(x_src[ix], h_src[ih]) @ w + b      (w: (E+H, 4H), [i|f|g|o])
//   c' = sigmoid(y_f) * c_src[ic] + sigmoid(y_i) * tanh(y_g)
//   h' = sigmoid(y_o) * tanh(c')
//
// Replaces the TPU kernel
// src/repro/kernels/fused_gather_cell.py:fused_gather_lstm_cell_kernel
// (scalar-prefetched row indices route x/h/c rows into VMEM, one
// (1, E+H) x (E+H, 4H) matmul per grid step).
//
// Bound and design: lstm_cell_tile.cuh, shared with the dense cell. Here
// a tile's rows come straight out of x_src / h_src (no gathered buffer in
// device memory): the block resolves its BM row indices once into shared
// memory. Indices mean what they mean to src[idx]: a negative index counts
// from the end, and one outside [-n, n) of its source fails a device-side
// assert, as PyTorch's own indexing does.
//
// C interface: launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cassert>

#include "lstm_cell_tile.cuh"

namespace {

using lstm_tile::BM;
using lstm_tile::BN;
using lstm_tile::THREADS;

// Row i of a source of n rows, as src[i] reads it.
__device__ __forceinline__ int64_t source_row(int64_t i, int64_t n) {
  if (i < 0) i += n;
  assert(i >= 0 && i < n);
  return i;
}

// Tile row m is concat(x_src[x_row[m]], h_src[h_row[m]]); a row index of
// -1 marks a row past B.
struct GatheredRows {
  const float* __restrict__ x_src;
  const float* __restrict__ h_src;
  const float* __restrict__ c_src;
  const int32_t* __restrict__ ic;
  const int64_t* x_row;   // shared memory, BM entries
  const int64_t* h_row;
  int64_t E, H, nc;

  __device__ __forceinline__ float a(int m, int64_t k) const {
    const float* p = nullptr;
    if (k < E) {
      if (x_row[m] >= 0) p = x_src + x_row[m] * E + k;
    } else if (k < E + H) {
      if (h_row[m] >= 0) p = h_src + h_row[m] * H + (k - E);
    }
    return p ? __ldg(p) : 0.0f;
  }

  __device__ __forceinline__ float c_prev(int64_t row, int64_t col) const {
    return c_src[source_row(ic[row], nc) * H + col];
  }
};

__global__ void __launch_bounds__(THREADS) fused_gather_lstm_cell_kernel(
    const float* __restrict__ x_src, const float* __restrict__ h_src,
    const float* __restrict__ c_src, const int32_t* __restrict__ ix,
    const int32_t* __restrict__ ih, const int32_t* __restrict__ ic,
    const float* __restrict__ w, const float* __restrict__ b,
    float* __restrict__ h_out, float* __restrict__ c_out, int64_t B,
    int64_t E, int64_t H, int64_t nx, int64_t nh, int64_t nc) {
  __shared__ int64_t x_row[BM], h_row[BM];

  if (threadIdx.x < BM) {
    const int64_t m = static_cast<int64_t>(blockIdx.y) * BM + threadIdx.x;
    int64_t xr = -1, hr = -1;
    if (m < B) {
      xr = source_row(ix[m], nx);
      hr = source_row(ih[m], nh);
    }
    x_row[threadIdx.x] = xr;
    h_row[threadIdx.x] = hr;
  }
  __syncthreads();

  const GatheredRows rows{x_src, h_src, c_src, ic, x_row, h_row, E, H, nc};
  lstm_tile::cell_tile(rows, w, b, h_out, c_out, B, E + H, H);
}

}  // namespace

extern "C" int fused_gather_lstm_cell_launch(
    const void* x_src, const void* h_src, const void* c_src, const void* ix,
    const void* ih, const void* ic, const void* w, const void* b, void* h_out,
    void* c_out, int64_t B, int64_t E, int64_t H, int64_t nx, int64_t nh,
    int64_t nc, void* stream) {
  const dim3 grid(static_cast<unsigned>((H + BN - 1) / BN),
                  static_cast<unsigned>((B + BM - 1) / BM));
  fused_gather_lstm_cell_kernel<<<grid, THREADS, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_src), static_cast<const float*>(h_src),
      static_cast<const float*>(c_src), static_cast<const int32_t*>(ix),
      static_cast<const int32_t*>(ih), static_cast<const int32_t*>(ic),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(h_out), static_cast<float*>(c_out), B, E, H, nx, nh,
      nc);
  return static_cast<int>(cudaGetLastError());
}
