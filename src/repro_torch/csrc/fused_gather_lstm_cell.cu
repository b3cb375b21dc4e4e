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
// Bound and design: lstm_cell_tile.cuh, shared with the dense cell (a
// cluster of CTAs splits K; packed weights stream by bulk copy into a ring
// of mbarrier-tracked stages; 3xTF32 mma.sync products; the partial sums
// meet in the leader CTA through distributed shared memory). Here a
// tile's rows come straight out of x_src / h_src, with no gathered buffer
// in device memory: warp 0 of each CTA resolves the row indices once into
// row pointers in shared memory, while the first weights already stream.
// Indices mean what they mean to src[idx]: a negative index counts from
// the end, and one outside [-n, n) of its source fails a device-side
// assert, as PyTorch's own indexing does.
//
// C interface: launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() (a refused cluster
// launch included).

#include <cassert>

#include "lstm_cell_tile.cuh"

namespace {

// Row i of a source of n rows, as src[i] reads it.
__device__ __forceinline__ int64_t source_row(int64_t i, int64_t n) {
  if (i < 0) i += n;
  assert(i >= 0 && i < n);
  return i;
}

// Row m is concat(x_src[ix[m]], h_src[ih[m]]), its cell state c_src[ic[m]].
struct GatheredRows {
  const float* __restrict__ x_src;
  const float* __restrict__ h_src;
  const float* __restrict__ c_src;
  const int32_t* __restrict__ ix;
  const int32_t* __restrict__ ih;
  const int32_t* __restrict__ ic;
  int64_t nx, nh, nc, E, H;

  __device__ __forceinline__ void resolve(int64_t m, const float*& x,
                                          const float*& h,
                                          const float*& c) const {
    x = x_src + source_row(ix[m], nx) * E;
    h = h_src + source_row(ih[m], nh) * H;
    c = c_src + source_row(ic[m], nc) * H;
  }
};

template <int NT>
__global__ void __launch_bounds__(lstm_tile::THREADS)
    fused_gather_lstm_cell_kernel(GatheredRows rows,
                                  const float* __restrict__ wp,
                                  const float* __restrict__ b,
                                  float* __restrict__ h_out,
                                  float* __restrict__ c_out, int64_t B,
                                  int64_t H, int cluster,
                                  int64_t chunks_per_rank, bool vec16) {
  lstm_tile::cell_tile<NT>(rows, wp, b, h_out, c_out, B, rows.E + H, H,
                           cluster, chunks_per_rank, vec16);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// wp: the weights packed by kernels/fused_cell.py's packed_weights; nt,
// cluster, chunks_per_rank and the grid: its cell_geometry(B, E + H, H).
extern "C" int fused_gather_lstm_cell_launch(
    const void* x_src, const void* h_src, const void* c_src, const void* ix,
    const void* ih, const void* ic, const void* wp, const void* b, void* h_out,
    void* c_out, int64_t B, int64_t E, int64_t H, int64_t nx, int64_t nh,
    int64_t nc, int64_t nt, int64_t cluster, int64_t chunks_per_rank,
    int64_t grid_x, int64_t grid_y, void* stream) {
  const GatheredRows rows{
      static_cast<const float*>(x_src), static_cast<const float*>(h_src),
      static_cast<const float*>(c_src), static_cast<const int32_t*>(ix),
      static_cast<const int32_t*>(ih), static_cast<const int32_t*>(ic),
      nx, nh, nc, E, H};
  const bool vec16 = E % 4 == 0 && H % 4 == 0 && aligned16(x_src) &&
                     aligned16(h_src);
  const auto* wf = static_cast<const float*>(wp);
  const auto* bf = static_cast<const float*>(b);
  auto* ho = static_cast<float*>(h_out);
  auto* co = static_cast<float*>(c_out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int cl = static_cast<int>(cluster);
  cudaError_t err;
  switch (nt) {
#define CASE(N)                                                               \
  case N:                                                                     \
    err = lstm_tile::launch<N>(fused_gather_lstm_cell_kernel<N>, cl, grid_x,  \
                               grid_y, s, rows, wf, bf, ho, co, B, H, cl,     \
                               chunks_per_rank, vec16);                       \
    break;
    CASE(1) CASE(2) CASE(4) CASE(8)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
