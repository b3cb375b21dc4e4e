// Row gather: out[r] = src[idx[r]] for r in [0, k).
//
// Replaces the TPU kernel src/repro/kernels/gather_batch.py:gather_rows_kernel
// (a scalar-prefetch BlockSpec gather, one (1, block_d) block per grid step).
//
// Bound on the H100: bytes. It is a pure copy: k rows read and k rows
// written, 2 * k * row_bytes over 3.35 TB/s, with no arithmetic at all. At
// the path's sizes (k of 1 to 512 rows of 2 KB) that is well under a
// microsecond, and what the card spends is a fixed cost: the launch (an
// empty kernel takes about 4.9 us in the timer the kernels are measured
// with) and two dependent trips to memory, the index and then the row.
//
// Design: a block of (tc, r) threads owns r rows and a tile of tc * v
// units of each (a unit is 16 bytes where the rows and both base pointers
// allow it, else one element): thread (x, y) copies units x, x + tc, ...,
// x + (v - 1) tc of row y (v = 1, 2, 4 or 8, a template parameter), all its
// loads before its first store, so a warp reads and writes contiguous
// bytes. A row takes up to 256 threads before a thread takes more than one
// unit: at the path's 2 KB rows, 128 threads of one unit beat 32 of four
// at K <= 16 and tied at K = 256 and 512 (PERF.md section 6). The grid is sized to the bytes: about 4 KB read a block, so a
// large copy spreads over every SM and a small one takes as few blocks as
// its rows need. Each warp reads the indices of its rows (at most 32) once,
// coalesced, one per lane, and hands each thread its row's by shuffle: no
// shared memory, no barrier, no per-element index load, and no thread
// divides. Grid-stride loops over the row and unit tiles let a capped grid
// cover any k. The geometry of every launch comes from the wrapper
// (kernels/gather_batch.py:gather_geometry).
//
// Tried and dropped: Hopper's bulk copy for 16-byte-aligned rows of 1 KB
// or more (a block a row, cp.async.bulk into shared memory on an mbarrier,
// then cp.async.bulk back out). At the path's 2 KB rows it was within the
// spread between calls of this kernel, cold and warm (PERF.md section 6),
// so it did not earn a second kernel.
//
// Indices mean what they mean to src[idx]: a negative index counts from the
// end, and one outside [-n_src, n_src) fails a device-side assert, which
// surfaces as a CUDA error at the next synchronisation, as PyTorch's own
// indexing does. The kernel is dtype agnostic: any element of 1-8 bytes,
// any row width, rows of more than two dims arriving flattened.
//
// C interface: launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cassert>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads) gather_rows_kernel(
    const T* __restrict__ src, const int32_t* __restrict__ idx,
    T* __restrict__ out, int64_t n_src, int64_t k, int64_t units_per_row,
    int64_t row_tiles, int64_t unit_tiles) {
  const int tc = blockDim.x, r = blockDim.y;
  const int tid = threadIdx.y * tc + threadIdx.x;
  const int lane = tid & 31;
  // The rows of this warp's threads are rows y0 .. y0 + 31 of the tile at
  // most: lane j reads index y0 + j once, and each thread takes its own
  // row's by shuffle. A partial last warp shuffles among its own lanes.
  const int y0 = (tid - lane) / tc;
  const int in_warp = min(32, tc * r - (tid - lane));
  const unsigned mask = in_warp == 32 ? 0xffffffffu : (1u << in_warp) - 1;
  for (int64_t rt = blockIdx.x; rt < row_tiles; rt += gridDim.x) {
    const int64_t r0 = rt * r;
    int64_t s = 0;
    if (y0 + lane < r && r0 + y0 + lane < k) {
      s = idx[r0 + y0 + lane];
      if (s < 0) s += n_src;
      assert(s >= 0 && s < n_src);
    }
    s = __shfl_sync(mask, s, threadIdx.y - y0);
    const int64_t row = r0 + threadIdx.y;
    if (row >= k) continue;
    const T* from = src + s * units_per_row;
    T* to = out + row * units_per_row;
    for (int64_t ut = blockIdx.y; ut < unit_tiles; ut += gridDim.y) {
      const int64_t u0 = ut * tc * V + threadIdx.x;
      T val[V];
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (u0 + j * tc < units_per_row) val[j] = from[u0 + j * tc];
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (u0 + j * tc < units_per_row) to[u0 + j * tc] = val[j];
    }
  }
}

template <typename T>
cudaError_t launch(const void* src, const int32_t* idx, void* out,
                   int64_t n_src, int64_t k, int64_t upr, int tc, int r,
                   int v, int64_t row_tiles, int64_t unit_tiles, dim3 grid,
                   cudaStream_t stream) {
  const auto* from = static_cast<const T*>(src);
  auto* to = static_cast<T*>(out);
  const dim3 block(tc, r);
  switch (v) {
    case 1: gather_rows_kernel<T, 1><<<grid, block, 0, stream>>>(from, idx, to, n_src, k, upr, row_tiles, unit_tiles); break;
    case 2: gather_rows_kernel<T, 2><<<grid, block, 0, stream>>>(from, idx, to, n_src, k, upr, row_tiles, unit_tiles); break;
    case 4: gather_rows_kernel<T, 4><<<grid, block, 0, stream>>>(from, idx, to, n_src, k, upr, row_tiles, unit_tiles); break;
    case 8: gather_rows_kernel<T, 8><<<grid, block, 0, stream>>>(from, idx, to, n_src, k, upr, row_tiles, unit_tiles); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

__global__ void empty_kernel() {}

}  // namespace

// unit: bytes per copy unit (1, 2, 4, 8 or 16); row_bytes % unit == 0.
// tc, r, v (1, 2, 4 or 8), row_tiles, unit_tiles and the grid:
// gather_geometry's.
extern "C" int gather_rows_launch(const void* src, const void* idx, void* out,
                                  int64_t n_src, int64_t k, int64_t row_bytes,
                                  int64_t unit, int64_t tc, int64_t r,
                                  int64_t v, int64_t row_tiles,
                                  int64_t unit_tiles, int64_t grid_x,
                                  int64_t grid_y, void* stream) {
  if (tc < 1 || r < 1 || tc * r > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* ix = static_cast<const int32_t*>(idx);
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t upr = row_bytes / unit;
  const dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(grid_y));
  const int t = static_cast<int>(tc), rr = static_cast<int>(r),
            vv = static_cast<int>(v);
  cudaError_t err;
  switch (unit) {
    case 16: err = launch<uint4>(src, ix, out, n_src, k, upr, t, rr, vv, row_tiles, unit_tiles, grid, s); break;
    case 8: err = launch<uint2>(src, ix, out, n_src, k, upr, t, rr, vv, row_tiles, unit_tiles, grid, s); break;
    case 4: err = launch<uint32_t>(src, ix, out, n_src, k, upr, t, rr, vv, row_tiles, unit_tiles, grid, s); break;
    case 2: err = launch<uint16_t>(src, ix, out, n_src, k, upr, t, rr, vv, row_tiles, unit_tiles, grid, s); break;
    case 1: err = launch<uint8_t>(src, ix, out, n_src, k, upr, t, rr, vv, row_tiles, unit_tiles, grid, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel of one warp: the fixed cost of a launch through this
// library, timed beside the kernels as their floor.
extern "C" int empty_kernel_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
