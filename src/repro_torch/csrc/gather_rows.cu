// Row gather: out[r] = src[idx[r]] for r in [0, k).
//
// Replaces the TPU kernel src/repro/kernels/gather_batch.py:gather_rows_kernel
// (a scalar-prefetch BlockSpec gather, one (1, block_d) block per grid step).
//
// Bound on the H100: bytes. It is a pure copy: k rows read and k rows
// written, 2 * k * row_bytes over 3.35 TB/s, with no arithmetic at all.
//
// Design: the output is viewed as k * units_per_row copy units, where a
// unit is 16 bytes when the row length and both base pointers allow it and
// one element otherwise (the wrapper decides). Consecutive threads copy
// consecutive units, so every warp reads and writes contiguous bytes within
// a row and a block covers one or a few whole rows at the path's widths
// (a 2 KB float32 row of width 512 is 128 units). The kernel is dtype
// agnostic: any D works, including ragged widths the TPU dispatcher sent to
// jnp.take, and rows of more than two dims arrive flattened. Indices mean
// what they mean to src[idx]: a negative index counts from the end, and one
// outside [-n_src, n_src) fails a device-side assert, which surfaces as a
// CUDA error at the next synchronisation, as PyTorch's own indexing does.
//
// C interface: launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cassert>
#include <cstdint>

namespace {

template <typename T>
__global__ void gather_rows_kernel(const T* __restrict__ src,
                                   const int32_t* __restrict__ idx,
                                   T* __restrict__ out, int64_t n_src,
                                   int64_t k, int64_t units_per_row) {
  const int64_t total = k * units_per_row;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int64_t r = i / units_per_row;
    const int64_t u = i - r * units_per_row;
    int64_t s = idx[r];
    if (s < 0) s += n_src;
    assert(s >= 0 && s < n_src);
    out[i] = src[s * units_per_row + u];
  }
}

template <typename T>
void launch(const void* src, const int32_t* idx, void* out, int64_t n_src,
            int64_t k, int64_t units_per_row, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int64_t total = k * units_per_row;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 65536) blocks = 65536;  // grid-stride loop covers the rest
  gather_rows_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(src), idx, static_cast<T*>(out), n_src, k,
      units_per_row);
}

}  // namespace

// unit: bytes per copy unit (1, 2, 4, 8 or 16); row_bytes % unit == 0.
extern "C" int gather_rows_launch(const void* src, const void* idx, void* out,
                                  int64_t n_src, int64_t k, int64_t row_bytes,
                                  int64_t unit, void* stream) {
  const auto* ix = static_cast<const int32_t*>(idx);
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t upr = row_bytes / unit;
  switch (unit) {
    case 16: launch<uint4>(src, ix, out, n_src, k, upr, s); break;
    case 8: launch<uint2>(src, ix, out, n_src, k, upr, s); break;
    case 4: launch<uint32_t>(src, ix, out, n_src, k, upr, s); break;
    case 2: launch<uint16_t>(src, ix, out, n_src, k, upr, s); break;
    case 1: launch<uint8_t>(src, ix, out, n_src, k, upr, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
