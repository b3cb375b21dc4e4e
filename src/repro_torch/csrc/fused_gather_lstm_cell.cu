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
// Bound on the H100: bytes. At the path's widths (E = H = 512, B <= 32) the
// weight matrix is (E+H) * 4H * 4 B = 8 MB per launch, about 2.5 us at
// 3.35 TB/s, while the 2 * B * (E+H) * 4H fp32 FMAs take about 1 us at
// B = 16 on the 67 TFLOP/s fp32 pipes. The rows, indices and outputs are
// a few tens of KB.
//
// Design: each block owns BM output rows x BN hidden units, i.e. the 4 * BN
// gate columns that hold the same hidden units of all four gates, so the
// LSTM epilogue needs nothing from another block. One lane of a warp owns
// one gate column. The K = E + H reduction is split across the block's
// warps in KC-deep chunks: per chunk a warp stages its BM x KC slice of the
// gathered rows in shared memory straight from x_src / h_src (no gathered
// buffer in device memory), each lane loads its KC weights into registers
// (coalesced 32-byte runs), and fp32 FMAs accumulate BM sums per lane in
// registers. The loads of a warp's next chunk start before the FMAs of
// the current one, so memory latency overlaps compute. The warps'
// partial sums meet in shared memory and one thread per (row, unit) adds
// the bias and applies the gate math. Everything stays fp32 (no TF32), so
// the kernel holds against the plain version at 1e-4. Indices mean what
// they mean to src[idx]: a negative index counts from the end, and one
// outside [-n, n) of its source fails a device-side assert, as PyTorch's
// own indexing does. Tensor cores (wgmma), TMA and bf16 weights are left
// for later work.
//
// C interface: launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cassert>
#include <cstdint>

namespace {

constexpr int BN = 8;      // hidden units per block: 4 * BN = 32 gate columns
constexpr int BM = 16;     // output rows per block
constexpr int KC = 32;     // reduction depth a warp takes per step
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
static_assert(4 * BN == 32, "one lane per gate column");

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Row i of a source of n rows, as src[i] reads it.
__device__ __forceinline__ int64_t source_row(int64_t i, int64_t n) {
  if (i < 0) i += n;
  assert(i >= 0 && i < n);
  return i;
}

// One lane's share of a KC-deep chunk starting at k0: column k0 + lane of
// the BM gathered rows (x for k < E, h after), and its gate column's KC
// weights. All loads are independent, so they go out back to back.
__device__ __forceinline__ void load_chunk(
    int64_t k0, int lane, const float* __restrict__ x_src,
    const float* __restrict__ h_src, const int64_t* x_row,
    const int64_t* h_row, const float* __restrict__ w, int64_t E, int64_t H,
    bool col_ok, int64_t w_col, float (&av)[BM], float (&wv)[KC]) {
  const int64_t K = E + H;
  const int64_t k = k0 + lane;
#pragma unroll
  for (int m = 0; m < BM; ++m) {
    const float* p = nullptr;
    if (k < E) {
      if (x_row[m] >= 0) p = x_src + x_row[m] * E + k;
    } else if (k < K) {
      if (h_row[m] >= 0) p = h_src + h_row[m] * H + (k - E);
    }
    av[m] = p ? __ldg(p) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    const int64_t kk = k0 + j;
    wv[j] = (col_ok && kk < K) ? __ldg(w + kk * 4 * H + w_col) : 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS) fused_gather_lstm_cell_kernel(
    const float* __restrict__ x_src, const float* __restrict__ h_src,
    const float* __restrict__ c_src, const int32_t* __restrict__ ix,
    const int32_t* __restrict__ ih, const int32_t* __restrict__ ic,
    const float* __restrict__ w, const float* __restrict__ b,
    float* __restrict__ h_out, float* __restrict__ c_out, int64_t B,
    int64_t E, int64_t H, int64_t nx, int64_t nh, int64_t nc) {
  __shared__ __align__(16) float a_tile[WARPS][BM][KC];
  __shared__ float partial[WARPS][BM][4 * BN];
  __shared__ int64_t x_row[BM], h_row[BM];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t K = E + H;

  if (threadIdx.x < BM) {
    const int64_t m = m0 + threadIdx.x;
    int64_t xr = -1, hr = -1;
    if (m < B) {
      xr = source_row(ix[m], nx);
      hr = source_row(ih[m], nh);
    }
    x_row[threadIdx.x] = xr;
    h_row[threadIdx.x] = hr;
  }
  __syncthreads();

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
    load_chunk(chunk * KC, lane, x_src, h_src, x_row, h_row, w, E, H,
               col_ok, w_col, av, wv);
  for (; chunk < n_chunks; chunk += WARPS) {
#pragma unroll
    for (int m = 0; m < BM; ++m) a_tile[warp][m][lane] = av[m];
    float wc[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) wc[j] = wv[j];
    __syncwarp();
    if (chunk + WARPS < n_chunks)
      load_chunk((chunk + WARPS) * KC, lane, x_src, h_src, x_row, h_row, w,
                 E, H, col_ok, w_col, av, wv);
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
    const float c_prev = c_src[source_row(ic[row], nc) * H + col];
    const float c_new = f_g * c_prev + i_g * g_g;
    c_out[row * H + col] = c_new;
    h_out[row * H + col] = o_g * tanhf(c_new);
  }
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
