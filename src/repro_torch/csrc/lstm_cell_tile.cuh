// One tile of the LSTM cell, shared by the dense kernel
// (fused_lstm_cell.cu) and the gathered one (fused_gather_lstm_cell.cu):
//   y = a @ w + b      (a: B rows of K = E + H values; w: (K, 4H), [i|f|g|o])
//   c' = sigmoid(y_f) * c + sigmoid(y_i) * tanh(y_g)
//   h' = sigmoid(y_o) * tanh(c')
//
// Bound on the H100: bytes. At the path's widths (K = 1024, H = 512,
// B <= 32) the weight matrix is K * 4H * 4 B = 8 MB per launch, 2.5 us at
// 3.35 TB/s, against 67 MFLOP at B = 16: 1.0 us in fp32 on the CUDA cores,
// 0.4 us as 3xTF32 on the tensor cores (2.0 and 0.8 us at B = 32). So the
// design streams w once, from every SM, with all of it in flight, and
// runs the products on the tensor cores so that they stay under the byte
// time at any B the path runs.
//
// Design. A thread-block cluster of `cluster` CTAs (1, 2 or 4, chosen by
// the wrapper, kernels/fused_cell.py:cell_geometry) owns BN = 8 hidden
// units: the 4 * BN = 32 gate columns that hold them in all four gates, so
// the LSTM epilogue needs nothing from another cluster. The K reduction is
// split over the cluster: CTA `rank` takes `chunks_per_rank` chunks of
// KC = 32 k rows. At E = H = 512 and B <= 16 that is 64 clusters of 4,
// 256 CTAs on the 132 SMs. A CTA holds all its B rows (up to 8 * NT = 64;
// more rows take more row groups on grid.y), so w is streamed once per
// launch whatever B is.
//   - Weights: packed once per weight tensor by the wrapper
//     (kernels/fused_cell.py:pack_weights, kept on the tensor) so that a
//     cluster's chunk of 32 k rows x 32 gate columns is 4 KB of contiguous
//     memory, each k step in the order the products read it (one 16-byte
//     load of a lane's A fragment). One bulk copy (cp.async.bulk, on the
//     copy engine, completing on an mbarrier) moves a chunk. Read in place,
//     a k row of the tile is four 32-byte gate runs 2 KB apart in w's
//     (K, 4H) layout, each its own request: issued by cp.async from the
//     CTA's threads, those requests, not the bytes, set the stream's pace
//     (packing took the gather cell from 17.8 to 16.0 us at B = 16,
//     PERF.md section 6).
//   - Loads: a ring of NS = 8 chunk stages in shared memory (4 past 32
//     rows), each holding a chunk's weights and the same 32 k columns of
//     the B rows, and each with an mbarrier that completes when the
//     chunk's bulk bytes and its rows are in. One thread issues the first
//     EARLY = 2 chunks' bulk copies at once; warp 0 meanwhile resolves the
//     rows into one pointer per row and segment (x_src[ix[m]] and
//     h_src[ih[m]] for the gathered cell, xh[m] for the dense one); then
//     every thread loads its share of all the stages' rows into registers
//     (16 bytes at a time where E, K - E and the pointers allow it, else 4;
//     zero past K and B), the other stages' bulk copies follow, and the
//     rows are stored stage by stage in the order the products read them,
//     one arrival a warp. So the whole K slice at the path's shape (32 KB
//     of weights a CTA, two CTAs an SM) is in flight early. Issuing every
//     chunk first, or none before the rows, was slower (the phase tool's
//     EARLY copies). Where K needs more than NS chunks, a stage is refilled
//     after a CTA barrier.
//   - Products: 3xTF32 m16n8k8 mma.sync (mma_tf32x3.cuh) with the operands
//     swapped, M = gate columns (two m16 tiles) and N = batch rows (NT n8
//     tiles): a B of 1-8 wastes nothing in M, where rows as M would waste
//     half an m16 tile or more, and at no B does it take more steps. Warp w
//     takes m tile w % 2 and k step w / 2 of every chunk, alternating
//     between two accumulators. wgmma is not used: it needs M = 64 (a B of
//     16 would waste 75% of it, and swapped, 32 gate columns half) and the
//     kernel is byte-bound.
//   - Reduction, in a fixed order: the warps' partial sums meet in the
//     CTA's shared memory, and each CTA's sum is written into slot `rank`
//     of the leader CTA's shared memory through distributed shared memory
//     (cooperative_groups::this_cluster().map_shared_rank); after a cluster
//     barrier the leader adds the slots in rank order, adds the bias and
//     applies the gate math (__expf, fast reciprocals: about 1e-6). One
//     launch, no global scratch, no atomics: results are the same from run
//     to run. The leader's bias and previous cell state are fetched by warp
//     0 at the start.
//   - Accuracy: 3xTF32 products accumulated in fp32 hold the kernels to
//     the fp32 plain versions at 1e-4 (tests/test_torch_tf32_split.py
//     rehearses the split and the split-K order on the CPU).
// Where the time goes (kernel_phases, PERF.md section 6): streaming w is
// at the card's rate, but the rows land only with the last weights, so the
// products and the cluster's reduction follow the stream instead of
// hiding under it.
// Out of scope: bf16 or fp8 weights would halve or quarter the bytes, but
// the reference computes the cell in fp32
// (src/repro/kernels/fused_gather_cell.py), bf16 weights give about 4e-3
// relative error against the 1e-4 bar the executors are held to, and it
// would be a feature the reference lacks.
//
// A kernel supplies its rows through a `Rows` type with two members:
//   void resolve(int64_t row, const float*& x, const float*& h,
//                const float*& c) const
//     row `row` (< B) as pointers to its first segment (E values), its
//     second (K - E values; unused where E == K) and its previous cell
//     state (H values);
//   int64_t E;   the length of the first segment.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_tf32x3.cuh"

namespace lstm_tile {

constexpr int BN = 8;            // hidden units per cluster
constexpr int COLS = 4 * BN;     // gate columns per cluster
constexpr int KC = 32;           // k rows per chunk
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_CLUSTER = 4;
constexpr int CHUNK_BYTES = KC * COLS * 4;   // a chunk of packed weights
constexpr int ISSUER = 32;       // the thread that issues the bulk copies
// Chunks of weights issued before the rows are resolved and loaded; the
// rest follow the rows' loads.
constexpr int EARLY = 2;
static_assert(COLS == 32 && WARPS == 2 * (KC / 8),
              "warp -> (m tile, k step of a chunk)");

// Ring and reduction layout (in floats) for NT n8 tiles of rows: NS chunk
// stages, each with its own mbarrier.
template <int NT>
struct Tile {
  static constexpr int RB = 8 * NT;                  // rows per CTA
  static constexpr int NS = NT <= 4 ? 8 : 4;         // ring stages
  static constexpr int W_STAGE = KC * COLS;
  static constexpr int STAGE = W_STAGE + RB * KC;
  static constexpr int RING = NS * STAGE;
  static constexpr int SLOT = COLS * RB;             // one CTA's sums
  static constexpr int PIECES = RB * (KC / 4);       // a chunk's row pieces
  // threads that store a chunk's rows, and how many pieces each stores
  static constexpr int ROW_THREADS = PIECES < THREADS ? PIECES : THREADS;
  static constexpr int PER_CHUNK = PIECES / ROW_THREADS;
  static_assert(RING >= (KC / 8) * SLOT, "the warps' partials fit the ring");
  static_assert(PIECES % ROW_THREADS == 0 && THREADS % ROW_THREADS == 0,
                "row pieces divide evenly over the threads");
  static constexpr size_t smem_bytes(int cluster) {
    return sizeof(float) * (static_cast<size_t>(RING) + cluster * SLOT);
  }
};

// Gate math, to about 1e-6 of fp32: __expf and a fast reciprocal.
__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}
__device__ __forceinline__ float tanh_f(float x) {
  return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * x));
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Cluster barrier halves: arrive (relaxed: orders nothing) and wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// mbarriers in shared memory (addresses from tf32x3::smem_addr).
__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// One arrival that also expects `bytes` from bulk copies.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// `bytes` from global to shared memory on the copy engine, completing on
// mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(tf32x3::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The cluster's tile: hidden units (blockIdx.x / cluster) * BN.., rows
// blockIdx.y * 8 NT.., k chunks [rank, rank + 1) * chunks_per_rank. `wp`:
// the weights as kernels/fused_cell.py:pack_weights packs them, a chunk of
// KC * COLS floats at a time. `vec16`: E, K - E and every row pointer
// allow 16-byte copies of the rows.
template <int NT, class Rows>
__device__ __forceinline__ void cell_tile(
    const Rows& rows, const float* __restrict__ wp,
    const float* __restrict__ b, float* __restrict__ h_out,
    float* __restrict__ c_out, int64_t B, int64_t K, int64_t H, int cluster,
    int64_t chunks_per_rank, bool vec16) {
  using T = Tile<NT>;
  constexpr int RB = T::RB, NS = T::NS;
  extern __shared__ __align__(128) float smem[];
  float* ring = smem;
  float* slots = smem + T::RING;
  __shared__ const float* seg_x[RB];
  __shared__ const float* seg_h[RB];
  __shared__ const float* seg_c[RB];
  __shared__ float bias_s[COLS];
  __shared__ float cprev_s[RB * BN];
  __shared__ __align__(8) unsigned long long full[NS];   // a stage landed

  // Every CTA of the cluster has started before any writes into another's
  // shared memory: arrive now, wait just before the first remote write.
  cluster_arrive_relaxed();

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned rank = cluster_rank();
  const int64_t tile = blockIdx.x / cluster;
  const int64_t n0 = tile * BN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * RB;
  const int64_t n_chunks = (K + KC - 1) / KC;
  const int64_t chunk0 = rank * chunks_per_rank;
  int64_t my_chunks = n_chunks - chunk0;
  if (my_chunks > chunks_per_rank) my_chunks = chunks_per_rank;
  if (my_chunks < 0) my_chunks = 0;
  const int64_t E = rows.E;
  const float* w_tile = wp + tile * n_chunks * KC * COLS;

  // Chunk c's weights into stage c % NS: one bulk copy of 4 KB, expected on
  // the stage's mbarrier by one arrival (thread ISSUER only).
  auto issue_weights = [&](int64_t c) {
    const uint32_t bar = tf32x3::smem_addr(&full[c % NS]);
    mbar_expect(bar, CHUNK_BYTES);
    bulk_copy(ring + (c % NS) * T::STAGE, w_tile + (chunk0 + c) * KC * COLS,
              CHUNK_BYTES, bar);
  };
  // Chunk c's rows move as T::PIECES pieces of 4 k values (piece p: row
  // p / 8, k values 4 (p % 8).. of the chunk), PER_CHUNK of them for each
  // of ROW_THREADS threads: pieces q * ROW_THREADS + tid % ROW_THREADS.
  // Zero past K and B.
  auto load_piece = [&](int64_t c, int p) -> float4 {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    const int m = p / 8;
    const int64_t k = (chunk0 + c) * KC + (p % 8) * 4;
    if (c >= my_chunks || seg_x[m] == nullptr) return v;
    if (vec16) {
      if (k < K)
        v = __ldg(reinterpret_cast<const float4*>(
            k < E ? seg_x[m] + k : seg_h[m] + (k - E)));
    } else {
      float* f = &v.x;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k + j < K)
          f[j] = __ldg(k + j < E ? seg_x[m] + k + j : seg_h[m] + (k + j - E));
    }
    return v;
  };
  // Stores a chunk's pieces (loaded earlier) in the B fragments' order
  // and arrives on its stage: for k step s, n tile j and lane 4 g + t, the
  // pair (rows[8 j + g][8 s + t], rows[8 j + g][8 s + t + 4]), one 8-byte
  // load a lane. Piece p (row m = p / 8, k values 4 (p % 8)..) holds k
  // step (p % 8) / 2, half (p % 8) % 2 of lanes 4 (m % 8)...
  auto store_pieces = [&](int64_t c, const float4* v) {
    float* rs = ring + (c % NS) * T::STAGE + T::W_STAGE;
#pragma unroll
    for (int q = 0; q < T::PER_CHUNK; ++q) {
      const int p = q * T::ROW_THREADS + tid % T::ROW_THREADS;
      const int m = p / 8, kq = p % 8;
      float* d = rs + (((kq >> 1) * NT + (m >> 3)) * 32 + (m & 7) * 4) * 2 +
                 (kq & 1);
      d[0] = v[q].x;
      d[2] = v[q].y;
      d[4] = v[q].z;
      d[6] = v[q].w;
    }
    __syncwarp();   // one arrival a warp, after all its lanes' stores
    if (lane == 0) mbar_arrive(tf32x3::smem_addr(&full[c % NS]));
  };

  if (tid < NS) {   // a stage lands with its bytes and one arrival a warp
    mbar_init(tf32x3::smem_addr(&full[tid]), T::ROW_THREADS / 32 + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // The weights of the first EARLY chunks go out at once; warp 0 meanwhile
  // resolves the rows into pointers and fetches the leader's epilogue
  // operands. Then every thread loads its share of all the stages' rows,
  // the other stages' weights follow, and the rows are stored stage by
  // stage.
  if (tid == ISSUER)
    for (int64_t c = 0; c < EARLY && c < my_chunks; ++c) issue_weights(c);
  if (warp == 0) {
    for (int m = lane; m < RB; m += 32) {
      const float *x = nullptr, *h = nullptr, *c = nullptr;
      if (m0 + m < B) rows.resolve(m0 + m, x, h, c);
      seg_x[m] = x;
      seg_h[m] = h;
      seg_c[m] = c;
    }
    __syncwarp();
    if (rank == 0) {
      for (int e = lane; e < COLS + RB * BN; e += 32) {
        if (e < COLS) {
          const int64_t col = n0 + (e & (BN - 1));
          const bool ok = col < H;
          tf32x3::cp_async4(&bias_s[e], ok ? b + (e / BN) * H + col : b, ok);
        } else {
          const int m = (e - COLS) / BN, u = (e - COLS) % BN;
          const bool ok = seg_c[m] != nullptr && n0 + u < H;
          tf32x3::cp_async4(&cprev_s[m * BN + u], ok ? seg_c[m] + n0 + u : b,
                            ok);
        }
      }
    }
  }
  __syncthreads();   // the row pointers are in
  {
    // chunk c of the first NS goes to threads of group c % GROUPS
    constexpr int GROUPS = THREADS / T::ROW_THREADS;
    constexpr int MINE = (NS + GROUPS - 1) / GROUPS;   // chunks per thread
    const int grp = tid / T::ROW_THREADS;
    float4 v[MINE][T::PER_CHUNK];
#pragma unroll
    for (int i = 0; i < MINE; ++i)
#pragma unroll
      for (int q = 0; q < T::PER_CHUNK; ++q)
        v[i][q] = load_piece(i * GROUPS + grp,
                             q * T::ROW_THREADS + tid % T::ROW_THREADS);
    if (tid == ISSUER)
      for (int64_t c = EARLY; c < NS && c < my_chunks; ++c) issue_weights(c);
#pragma unroll
    for (int i = 0; i < MINE; ++i) {
      const int64_t c = i * GROUPS + grp;
      if (c < NS && c < my_chunks) store_pieces(c, v[i]);
    }
  }

  // Warp -> m tile (gate columns mt * 16..) and k step (rows ks * 8.. of
  // every chunk); chunks alternate between two accumulators, so a warp has
  // 2 NT independent chains of steps. D[col][row] of n tile j accumulates
  // in acc[s][j].
  const int mt = warp & 1, ks = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
  float acc[2][NT][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[s][j][0] = acc[s][j][1] = acc[s][j][2] = acc[s][j][3] = 0.0f;
  // Chunk c (in stage c % NS, landed): its k step ks into acc[s]; then,
  // where K needs more than NS chunks, stage c % NS refilled with chunk
  // c + NS once every warp is done with it.
  auto step = [&](int64_t c, float (*a_acc)[4]) {
    mbar_wait(tf32x3::smem_addr(&full[c % NS]),
              static_cast<uint32_t>((c / NS) & 1));
    const float* st = ring + (c % NS) * T::STAGE;
    const float* rs = st + T::W_STAGE;
    // A = w^T (16 gate columns x 8 k), packed in fragment order:
    // a0 = w[k0 + t][col0 + g], a1 = .. col0 + g + 8, a2, a3 = .. k0 + t + 4
    const float4 av =
        *reinterpret_cast<const float4*>(st + ((ks * 2 + mt) * 32 + lane) * 4);
    const tf32x3::FragA a = tf32x3::split_a(av.x, av.y, av.z, av.w);
    // B = rows^T (8 k x 8 rows), staged in fragment order:
    // b0 = rows[n0 + g][k0 + t], b1 = rows[n0 + g][k0 + t + 4]
    tf32x3::FragB bf[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 bv = *reinterpret_cast<const float2*>(
          rs + ((ks * NT + j) * 32 + lane) * 2);
      bf[j] = tf32x3::split_b(bv.x, bv.y);
    }
    tf32x3::mma3_row<NT>(a_acc, a, bf);
    if (c + NS < my_chunks) {
      __syncthreads();   // every warp is done with stage c % NS
      if (tid == ISSUER) issue_weights(c + NS);
      if (tid < T::ROW_THREADS) {
        float4 v[T::PER_CHUNK];
#pragma unroll
        for (int q = 0; q < T::PER_CHUNK; ++q)
          v[q] = load_piece(c + NS, q * T::ROW_THREADS + tid);
        store_pieces(c + NS, v);
      }
    }
  };
  for (int64_t c = 0; c < my_chunks; c += 2) {
    step(c, acc[0]);
    if (c + 1 < my_chunks) step(c + 1, acc[1]);
  }

  // -- the warps' partial sums: part[ks][col][row] over the ring
  tf32x3::cp_async_wait<0>();   // the leader's epilogue operands
  __syncthreads();              // every batch consumed; the ring is free
  {
    float* part = ring + ks * T::SLOT;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = mt * 16 + g, row = j * 8 + 2 * t;
      part[col * RB + row] = acc[0][j][0] + acc[1][j][0];
      part[col * RB + row + 1] = acc[0][j][1] + acc[1][j][1];
      part[(col + 8) * RB + row] = acc[0][j][2] + acc[1][j][2];
      part[(col + 8) * RB + row + 1] = acc[0][j][3] + acc[1][j][3];
    }
  }
  __syncthreads();
  cluster_wait();   // every CTA of the cluster is running
  {
    namespace cg = cooperative_groups;
    float* dst = cg::this_cluster().map_shared_rank(slots, 0) + rank * T::SLOT;
    for (int e = tid; e < T::SLOT; e += THREADS) {
      float s = ring[e];
#pragma unroll
      for (int q = 1; q < KC / 8; ++q) s += ring[q * T::SLOT + e];
      dst[e] = s;
    }
  }
  cooperative_groups::this_cluster().sync();   // every slot is written

  if (rank != 0) return;
  for (int e = tid; e < RB * BN; e += THREADS) {
    const int m = e / BN, u = e % BN;
    const int64_t row = m0 + m, col = n0 + u;
    if (row >= B || col >= H) continue;
    float y[4];
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) {
      const int idx = (gate * BN + u) * RB + m;
      float s = slots[idx];
#pragma unroll
      for (int r = 1; r < MAX_CLUSTER; ++r)
        if (r < cluster) s += slots[r * T::SLOT + idx];
      y[gate] = s + bias_s[gate * BN + u];
    }
    const float i_g = sigmoid_f(y[0]);
    const float f_g = sigmoid_f(y[1]);
    const float g_g = tanh_f(y[2]);
    const float o_g = sigmoid_f(y[3]);
    const float c_new = f_g * cprev_s[m * BN + u] + i_g * g_g;
    c_out[row * H + col] = c_new;
    h_out[row * H + col] = o_g * tanh_f(c_new);
  }
}

// Launch `kernel` (a __global__ of NT calling cell_tile) on a grid of
// (grid_x, grid_y) CTAs in clusters of `cluster` along x, with the ring
// and the cluster's slots as dynamic shared memory.
template <int NT, typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int cluster, int64_t grid_x,
                   int64_t grid_y, cudaStream_t stream, Args... args) {
  if (cluster < 1 || cluster > MAX_CLUSTER || grid_x % cluster)
    return cudaErrorInvalidValue;
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tile<NT>::smem_bytes(MAX_CLUSTER)));
  if (attr_err != cudaSuccess) return attr_err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid_x),
                     static_cast<unsigned>(grid_y));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Tile<NT>::smem_bytes(cluster);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

}  // namespace lstm_tile
