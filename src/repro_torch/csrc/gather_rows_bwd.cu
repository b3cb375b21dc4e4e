// The row gather's backward: dsrc[r] = sum of dout[k] over the k whose
// idx[k] means row r (a negative index counts from the end, as in
// src[idx]), in ascending k; zero for a row no index means. fp32 and bf16.
//
// bf16 (gather_rows_bwd_bf16_launch): dout and dsrc are bf16 and each
// row's run is summed as the reference's scatter-add of the gather's
// gradient sums it, from zero in ascending k with the sum rounded to bf16
// after every add (acc = float(bf16_rn(acc + float(v))); a sum of two bf16
// values is exact enough in fp32 that rounding it once more to bf16 gives
// the correctly rounded bf16 sum). A 16-byte unit is 8 bf16 summed in 8
// fp32 registers; rows or pointers off 16 bytes take 2-byte units. The
// sort and the (row, k) lists do not depend on the dtype and are shared.
//
// Replaces: the TPU kernel src/repro/kernels/gather_batch.py:
// gather_rows_kernel has no backward; the JAX package differentiates the
// gather (jnp.take) wherever it trains through the executors
// (examples/tree_classifier.py). The plain version is
// kernels/ref.py:gather_rows_bwd_ref.
//
// Bound on the H100: bytes. dout is read once (k rows) and dsrc written
// once (n_src rows), no arithmetic to speak of beyond the sums of
// duplicate rows: (k + n_src) * row_bytes over 3.35 TB/s. At the path's
// sizes (2 KB rows, a few thousand at most) that is about a microsecond;
// what the card spends is the launch and the dependent trips to memory.
//
// Two paths; the wrapper picks one (kernels/gather_batch.py:
// backward_geometry) and passes rows_per_block, 0 for the second.
//
// 1. One launch, no sort, for k <= ONE_MAX_K where the index reads stay
//    small. Each block owns rows_per_block consecutive rows of dsrc and
//    reads the whole index vector, coalesced (k * 4 bytes; from L2 after
//    the first blocks). It compacts the (local row, k) pairs that land in
//    its rows, in ascending k, by warp ballots and one prefix over the
//    (chunk, warp) groups in k order: no atomics decide an order. A stable
//    counting sort by local row (counts, their prefix, then one warp
//    placing the pairs 32 at a time in list order with __match_any_sync)
//    gives each row its run of k, ascending. Then the block's threads write
//    every unit of its rows, the sum of the run's dout rows in order (zero
//    for an empty run), in 16-byte units where rows and pointers allow,
//    one element otherwise. The zero fill, the duplicate sums and the sort are
//    one pass; no scratch, no second launch. A block reads k indices where
//    the kernel must move (k + n_src) * row_bytes: the wrapper takes this
//    path while blocks * k * 4 is at most half of that, doubling the rows a
//    block owns (up to 8 units a thread) before it gives up, so at the
//    path's 2 KB rows every k up to ONE_MAX_K (the pairs a block can hold
//    in shared memory) takes it, and a large k over narrow rows does not.
// 2. Past that, the sort: the indices are turned into keys (row << 32 |
//    k), unique, so any sort of them gives the same order: row by row,
//    ascending k within a row. A block sorts each tile of up to 2048 keys
//    in shared memory (bitonic, the tile the next power of two of k where
//    k is smaller, half as many threads); tiles are then merged pairwise,
//    one thread a key placing it by a binary search in the partner run,
//    until one run holds them all (no pass at k <= 2048). Then every row
//    of dsrc is written by the threads that own it, with the gather's own
//    launch geometry (kernels/gather_batch.py:gather_geometry, over n_src
//    rows): each block copies the sorted keys into shared memory where they
//    fit (k <= 4096), each thread finds its row's run of keys by two binary
//    searches there and sums those rows of dout, in order, in 16-byte
//    units where rows and pointers allow, else one element. The row kernel
//    is the sort's programmatic dependent: it is launched while the sort
//    runs and waits for it only before reading the keys.
// Both sum a row's duplicates (an embedding's repeated tokens, the
// bucketed pad lanes' trash row) in ascending k with no floating-point
// atomics, so the two paths give the same bits and two runs are bit-equal.
//
// C interface: launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cassert>
#include <cstdint>

namespace {

constexpr int SORT_THREADS = 1024;
constexpr int SORT_TILE = 2 * SORT_THREADS;
constexpr int SMEM_KEYS = 4096;   // keys the row kernel stages (32 KB)
constexpr unsigned long long PAD = ~0ull;

// Sorts tiles of `tile` keys (a power of two, at most SORT_TILE) with
// blockDim.x >= tile / 2 threads.
__global__ void __launch_bounds__(SORT_THREADS) gather_bwd_sort_kernel(
    const int32_t* __restrict__ idx, unsigned long long* __restrict__ keys,
    int64_t n_src, int64_t k, int tile) {
  __shared__ unsigned long long s[SORT_TILE];
  // the row kernel may launch now; it waits for this grid's keys
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int tid = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  for (int i = tid; i < tile; i += blockDim.x) {
    const int64_t j = base + i;
    unsigned long long key = PAD;
    if (j < k) {
      int64_t row = idx[j];
      if (row < 0) row += n_src;
      assert(row >= 0 && row < n_src);
      key = (static_cast<unsigned long long>(row) << 32) |
            static_cast<unsigned long long>(j);
    }
    s[i] = key;
  }
  __syncthreads();
  for (int size = 2; size <= tile; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (tid < tile / 2) {
        const int lo = 2 * tid - (tid & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const unsigned long long a = s[lo], b = s[hi];
        if ((a > b) == up) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < tile; i += blockDim.x)
    if (base + i < k) keys[base + i] = s[i];
}

// Merge runs of `width` sorted keys pairwise into runs of 2 width.
__global__ void gather_bwd_merge_kernel(
    const unsigned long long* __restrict__ in,
    unsigned long long* __restrict__ out, int64_t k, int64_t width) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= k) return;
  const unsigned long long key = in[i];
  const int64_t run = i / width, j = i - run * width;
  const int64_t other = run ^ 1, os = other * width;
  int64_t lo = 0, hi = os < k ? (k - os < width ? k - os : width) : 0;
  while (lo < hi) {   // keys of the other run below this one
    const int64_t mid = (lo + hi) >> 1;
    if (in[os + mid] < key) lo = mid + 1;
    else hi = mid;
  }
  out[(run < other ? run : other) * width + j + lo] = key;
}

__device__ __forceinline__ int64_t lower_bound(
    const unsigned long long* keys, int64_t k, unsigned long long key) {
  int64_t lo = 0, hi = k;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (keys[mid] < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The sum of one unit (T, as dout and dsrc hold it) over a run of rows.
template <typename T> struct Sum;
template <> struct Sum<float> {
  float a = 0.f;
  __device__ __forceinline__ void add(float v) { a += v; }
  __device__ __forceinline__ float get() const { return a; }
};
template <> struct Sum<float4> {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  __device__ __forceinline__ void add(float4 v) {
    a.x += v.x;
    a.y += v.y;
    a.z += v.z;
    a.w += v.w;
  }
  __device__ __forceinline__ float4 get() const { return a; }
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <> struct Sum<__nv_bfloat16> {
  float a = 0.f;
  __device__ __forceinline__ void add(__nv_bfloat16 v) {
    a = bf16_round(a + __bfloat162float(v));
  }
  __device__ __forceinline__ __nv_bfloat16 get() const {
    return __float2bfloat16_rn(a);
  }
};
// 8 bf16 in a 16-byte unit: element 2i in the low half of word i
template <> struct Sum<uint4> {
  float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  __device__ __forceinline__ void add2(int i, uint32_t w) {
    a[2 * i] = bf16_round(a[2 * i] + __uint_as_float(w << 16));
    a[2 * i + 1] = bf16_round(a[2 * i + 1] + __uint_as_float(w & 0xffff0000u));
  }
  __device__ __forceinline__ void add(uint4 v) {
    add2(0, v.x);
    add2(1, v.y);
    add2(2, v.z);
    add2(3, v.w);
  }
  // every a[i] is a bf16 value: its upper 16 bits are exact
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
  }
  __device__ __forceinline__ uint4 get() const {
    return make_uint4(pack(a[0], a[1]), pack(a[2], a[3]), pack(a[4], a[5]),
                      pack(a[6], a[7]));
  }
};

// Thread (x, y) of a (tc, r) block owns row r0 + y of dsrc and its units
// x, x + tc, ..., x + (V - 1) tc of each tile it visits.
template <typename T, int V>
__global__ void __launch_bounds__(256) gather_bwd_sum_kernel(
    const T* __restrict__ dout, const unsigned long long* __restrict__ gkeys,
    T* __restrict__ dsrc, int64_t n_src, int64_t k, int64_t units_per_row,
    int64_t row_tiles, int64_t unit_tiles) {
  extern __shared__ unsigned long long skeys[];
  const int tc = blockDim.x, r = blockDim.y;
  asm volatile("griddepcontrol.wait;" ::: "memory");   // the sorted keys
  const unsigned long long* keys = gkeys;
  if (k <= SMEM_KEYS) {
    for (int64_t i = threadIdx.y * tc + threadIdx.x; i < k; i += tc * r)
      skeys[i] = gkeys[i];
    __syncthreads();
    keys = skeys;
  }
  for (int64_t rt = blockIdx.x; rt < row_tiles; rt += gridDim.x) {
    const int64_t row = rt * r + threadIdx.y;
    if (row >= n_src) continue;
    const unsigned long long first = static_cast<unsigned long long>(row)
                                     << 32;
    const int64_t lo = lower_bound(keys, k, first);
    const int64_t hi = lower_bound(keys, k, first + (1ull << 32));
    T* to = dsrc + row * units_per_row;
    for (int64_t ut = blockIdx.y; ut < unit_tiles; ut += gridDim.y) {
      const int64_t u0 = ut * tc * V + threadIdx.x;
      Sum<T> acc[V];
      for (int64_t e = lo; e < hi; ++e) {
        const T* from = dout + static_cast<int64_t>(keys[e] & 0xffffffffull) *
                                   units_per_row;
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (u0 + j * tc < units_per_row) acc[j].add(from[u0 + j * tc]);
      }
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (u0 + j * tc < units_per_row) to[u0 + j * tc] = acc[j].get();
    }
  }
}

// -- path 1: one launch --------------------------------------------------

constexpr int ONE_THREADS = 256;
constexpr int ONE_MAX_K = 2048;                 // pairs a block holds
constexpr int ONE_KPT = ONE_MAX_K / ONE_THREADS;  // indices a thread reads
constexpr int ONE_GROUPS = ONE_MAX_K / 32;      // (chunk, warp) groups
constexpr int ONE_MAX_ROWS = 2048;              // rows a block owns
static_assert(ONE_GROUPS == 64, "a warp scans the groups two a lane");

// Block b owns rows [b * rows, b * rows + rows) of dsrc.
template <typename T>
__global__ void __launch_bounds__(ONE_THREADS) gather_bwd_one_kernel(
    const T* __restrict__ dout, const int32_t* __restrict__ idx,
    T* __restrict__ dsrc, int64_t n_src, int k, int64_t upr, int rows) {
  __shared__ uint32_t list[ONE_MAX_K];   // (local row << 16 | k), k order
  __shared__ uint16_t runk[ONE_MAX_K];   // the k of each run, row by row
  __shared__ int start[ONE_MAX_ROWS + 1];  // each row's run; its count first
  __shared__ int group_at[ONE_GROUPS];   // first list slot of each group
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int nrows = static_cast<int>(n_src - r0 < rows ? n_src - r0 : rows);
  const unsigned below = (1u << lane) - 1u;

  // The pairs landing here: index k = i * ONE_THREADS + tid, so groups
  // (i, warp) in ascending order hold ascending k.
  int local[ONE_KPT];
  unsigned hit[ONE_KPT];
#pragma unroll
  for (int i = 0; i < ONE_KPT; ++i) {
    const int kk = i * ONE_THREADS + tid;
    int lr = -1;
    if (kk < k) {
      int64_t row = idx[kk];
      if (row < 0) row += n_src;
      assert(row >= 0 && row < n_src);
      if (row >= r0 && row < r0 + nrows) lr = static_cast<int>(row - r0);
    }
    local[i] = lr;
    hit[i] = __ballot_sync(0xffffffffu, lr >= 0);
    if (lane == 0) group_at[i * (ONE_THREADS / 32) + warp] = __popc(hit[i]);
  }
  for (int r = tid; r <= nrows; r += ONE_THREADS) start[r] = 0;
  __syncthreads();
  // every warp scans the 64 group counts in order (two a lane) for the
  // first list slot of its own groups: no second barrier
  const int ca = group_at[2 * lane], cb = group_at[2 * lane + 1];
  int incl = ca + cb;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  const int m = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
  for (int i = 0; i < ONE_KPT; ++i) {
    const int grp = i * (ONE_THREADS / 32) + warp;   // lane grp / 2 holds it
    const int before = __shfl_sync(0xffffffffu, incl - ca - cb, grp >> 1);
    const int first = __shfl_sync(0xffffffffu, ca, grp >> 1);
    const int at0 = before + (grp & 1 ? first : 0);
    if (local[i] >= 0) {
      const int at = at0 + __popc(hit[i] & below);
      list[at] = (static_cast<uint32_t>(local[i]) << 16) |
                 static_cast<uint32_t>(i * ONE_THREADS + tid);
      atomicAdd(&start[local[i] + 1], 1);   // an integer count
    }
  }
  __syncthreads();
  if (m > 0 && warp == 0) {
    // the counts' inclusive prefix gives each row's first slot
    int carry = 0;
    for (int r0w = 0; r0w <= nrows; r0w += 32) {
      const int r = r0w + lane;
      int v = r <= nrows ? start[r] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += up;
      }
      if (r <= nrows) start[r] = v + carry;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
    __syncwarp();
    // stable placement: 32 pairs at a time, in list order; equal rows
    // within the 32 take consecutive slots by lane, the first of them
    // moving the row's cursor (start[lr], restored below) past them all
    for (int base = 0; base < m; base += 32) {
      const int i = base + lane;
      const uint32_t e = i < m ? list[i] : 0xffffffffu;
      const int lr = static_cast<int>(e >> 16);
      const unsigned same = __match_any_sync(0xffffffffu, lr);
      if (i < m) runk[start[lr] + __popc(same & below)] =
          static_cast<uint16_t>(e & 0xffffu);
      __syncwarp();
      if (i < m && (same & below) == 0) start[lr] += __popc(same);
      __syncwarp();
    }
    // every cursor now sits at its row's end, start[lr + 1]'s old value:
    // shift back by one row
    for (int top = nrows; top > 0; top -= 32) {
      const int r = top - lane;
      const int v = r > 0 ? start[r - 1] : 0;
      __syncwarp();
      if (r > 0) start[r] = v;
      __syncwarp();
    }
    if (lane == 0) start[0] = 0;
  }
  __syncthreads();
  // units fit in an int: the launch keeps rows * upr below 2^31
  const int units = nrows * static_cast<int>(upr), up = static_cast<int>(upr);
  T* to = dsrc + r0 * upr;
  for (int e = tid; e < units; e += ONE_THREADS) {
    const int lr = e / up, u = e - lr * up;
    Sum<T> acc;
    for (int j = start[lr], end = start[lr + 1]; j < end; ++j)
      acc.add(dout[static_cast<int64_t>(runk[j]) * upr + u]);
    to[e] = acc.get();
  }
}

// The row kernel, as the programmatic dependent of the kernel before it.
template <typename T>
cudaError_t launch_sum(const void* dout, const unsigned long long* keys,
                       void* dsrc, int64_t n_src, int64_t k, int64_t upr,
                       int tc, int r, int v, int64_t row_tiles,
                       int64_t unit_tiles, dim3 grid, cudaStream_t stream) {
  const auto* from = static_cast<const T*>(dout);
  auto* to = static_cast<T*>(dsrc);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(tc, r);
  cfg.dynamicSmemBytes = k <= SMEM_KEYS ? k * sizeof(unsigned long long) : 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  switch (v) {
    case 1: err = cudaLaunchKernelEx(&cfg, gather_bwd_sum_kernel<T, 1>, from, keys, to, n_src, k, upr, row_tiles, unit_tiles); break;
    case 2: err = cudaLaunchKernelEx(&cfg, gather_bwd_sum_kernel<T, 2>, from, keys, to, n_src, k, upr, row_tiles, unit_tiles); break;
    case 4: err = cudaLaunchKernelEx(&cfg, gather_bwd_sum_kernel<T, 4>, from, keys, to, n_src, k, upr, row_tiles, unit_tiles); break;
    case 8: err = cudaLaunchKernelEx(&cfg, gather_bwd_sum_kernel<T, 8>, from, keys, to, n_src, k, upr, row_tiles, unit_tiles); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The launches of both paths; Wide is the 16-byte unit's type, Narrow the
// element's.
template <typename Wide, typename Narrow>
int launch_bwd(const void* dout, const void* idx, void* dsrc, void* keys_a,
               void* keys_b, int64_t n_src, int64_t k, int64_t row_bytes,
               int64_t unit, int64_t rows_per_block, int64_t tc, int64_t r,
               int64_t v, int64_t row_tiles, int64_t unit_tiles,
               int64_t grid_x, int64_t grid_y, void* stream) {
  if (n_src >= (1ll << 31) || k >= (1ll << 32) ||
      (unit != 16 && unit != static_cast<int64_t>(sizeof(Narrow))))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t upr = row_bytes / unit;
  if (rows_per_block > 0) {
    if (k > ONE_MAX_K || rows_per_block > ONE_MAX_ROWS ||
        rows_per_block * upr >= (1ll << 31))
      return static_cast<int>(cudaErrorInvalidValue);
    const int64_t blocks = (n_src + rows_per_block - 1) / rows_per_block;
    if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
    const int ki = static_cast<int>(k), rb = static_cast<int>(rows_per_block);
    const auto* ix = static_cast<const int32_t*>(idx);
    if (unit == 16)
      gather_bwd_one_kernel<Wide>
          <<<static_cast<unsigned>(blocks), ONE_THREADS, 0, s>>>(
              static_cast<const Wide*>(dout), ix, static_cast<Wide*>(dsrc),
              n_src, ki, upr, rb);
    else
      gather_bwd_one_kernel<Narrow>
          <<<static_cast<unsigned>(blocks), ONE_THREADS, 0, s>>>(
              static_cast<const Narrow*>(dout), ix,
              static_cast<Narrow*>(dsrc), n_src, ki, upr, rb);
    return static_cast<int>(cudaGetLastError());
  }
  if (tc < 1 || r < 1 || tc * r > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* a = static_cast<unsigned long long*>(keys_a);
  auto* b = static_cast<unsigned long long*>(keys_b);
  if (k > 0) {
    int tile = 2;   // the next power of two of k, at most SORT_TILE
    while (tile < k && tile < SORT_TILE) tile *= 2;
    const int64_t tiles = (k + tile - 1) / tile;
    const int threads = tile / 2 < 32 ? 32 : tile / 2;
    gather_bwd_sort_kernel<<<static_cast<unsigned>(tiles), threads, 0, s>>>(
        static_cast<const int32_t*>(idx), a, n_src, k, tile);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    for (int64_t width = SORT_TILE; width < k; width *= 2) {
      gather_bwd_merge_kernel<<<static_cast<unsigned>((k + 255) / 256), 256, 0,
                                s>>>(a, b, k, width);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      unsigned long long* t = a;
      a = b;
      b = t;
    }
  }
  const dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(grid_y));
  const int t = static_cast<int>(tc), rr = static_cast<int>(r),
            vv = static_cast<int>(v);
  cudaError_t err =
      unit == 16
          ? launch_sum<Wide>(dout, a, dsrc, n_src, k, upr, t, rr, vv,
                             row_tiles, unit_tiles, grid, s)
          : launch_sum<Narrow>(dout, a, dsrc, n_src, k, upr, t, rr, vv,
                               row_tiles, unit_tiles, grid, s);
  return static_cast<int>(err);
}

}  // namespace

// dout: (k, row) fp32, dsrc: (n_src, row) fp32; unit: 16 or 4 bytes.
// rows_per_block > 0: path 1, blocks of rows_per_block rows (k at most
// ONE_MAX_K, rows_per_block at most ONE_MAX_ROWS); the key scratch and the
// row geometry are not read. 0: path 2; keys_a, keys_b: k 8-byte scratch
// words each; tc, r, v (1, 2, 4 or 8), row_tiles, unit_tiles and the grid:
// gather_geometry's over n_src rows.
extern "C" int gather_rows_bwd_launch(
    const void* dout, const void* idx, void* dsrc, void* keys_a, void* keys_b,
    int64_t n_src, int64_t k, int64_t row_bytes, int64_t unit,
    int64_t rows_per_block, int64_t tc, int64_t r, int64_t v,
    int64_t row_tiles, int64_t unit_tiles, int64_t grid_x, int64_t grid_y,
    void* stream) {
  return launch_bwd<float4, float>(dout, idx, dsrc, keys_a, keys_b, n_src, k,
                                   row_bytes, unit, rows_per_block, tc, r, v,
                                   row_tiles, unit_tiles, grid_x, grid_y,
                                   stream);
}

// The same for bf16 dout and dsrc, each add rounded to bf16; unit: 16 or 2
// bytes.
extern "C" int gather_rows_bwd_bf16_launch(
    const void* dout, const void* idx, void* dsrc, void* keys_a, void* keys_b,
    int64_t n_src, int64_t k, int64_t row_bytes, int64_t unit,
    int64_t rows_per_block, int64_t tc, int64_t r, int64_t v,
    int64_t row_tiles, int64_t unit_tiles, int64_t grid_x, int64_t grid_y,
    void* stream) {
  return launch_bwd<uint4, __nv_bfloat16>(
      dout, idx, dsrc, keys_a, keys_b, n_src, k, row_bytes, unit,
      rows_per_block, tc, r, v, row_tiles, unit_tiles, grid_x, grid_y,
      stream);
}
