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
// the K steps are split over a thread-block cluster instead and their
// partial sums meet in the leader CTA's shared memory, in a fixed order,
// through distributed shared memory; the cluster holds all four gates of
// its 8 hidden units, so the epilogue needs no second pass and no global
// scratch. The rows are xh's, one pointer per row (E = K: a single
// segment). Ragged B, H and K are masked, so no shape is refused.
//
// C interface: launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() (a refused cluster
// launch included).

#include "lstm_cell_tile.cuh"

namespace {

// Row m is xh[m], its cell state c[m].
struct DenseRows {
  const float* __restrict__ xh;
  const float* __restrict__ c;
  int64_t E, H;   // E = K

  __device__ __forceinline__ void resolve(int64_t m, const float*& x,
                                          const float*& h,
                                          const float*& cp) const {
    x = xh + m * E;
    h = nullptr;
    cp = c + m * H;
  }
};

template <int NT>
__global__ void __launch_bounds__(lstm_tile::THREADS)
    fused_lstm_cell_kernel(DenseRows rows, const float* __restrict__ wp,
                           const float* __restrict__ b,
                           float* __restrict__ h_out,
                           float* __restrict__ c_out, int64_t B, int64_t H,
                           int cluster, int64_t chunks_per_rank, bool vec16) {
  lstm_tile::cell_tile<NT>(rows, wp, b, h_out, c_out, B, rows.E, H, cluster,
                           chunks_per_rank, vec16);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// wp: the weights packed by kernels/fused_cell.py's packed_weights; nt,
// cluster, chunks_per_rank and the grid: its cell_geometry(B, K, H).
extern "C" int fused_lstm_cell_launch(const void* xh, const void* wp,
                                      const void* b, const void* c,
                                      void* h_out, void* c_out, int64_t B,
                                      int64_t K, int64_t H, int64_t nt,
                                      int64_t cluster,
                                      int64_t chunks_per_rank, int64_t grid_x,
                                      int64_t grid_y, void* stream) {
  const DenseRows rows{static_cast<const float*>(xh),
                       static_cast<const float*>(c), K, H};
  const bool vec16 = K % 4 == 0 && aligned16(xh);
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
    err = lstm_tile::launch<N>(fused_lstm_cell_kernel<N>, cl, grid_x, grid_y, \
                               s, rows, wf, bf, ho, co, B, H, cl,             \
                               chunks_per_rank, vec16);                       \
    break;
    CASE(1) CASE(2) CASE(4) CASE(8)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
