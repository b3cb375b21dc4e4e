// Hopper (sm_90a) building blocks for the bf16 kernels: tensor maps and
// TMA tile loads, mbarriers, the shared-memory matrix descriptor of the
// 128-byte swizzle, and warpgroup matrix products (`wgmma`) on bf16
// operands with fp32 accumulators. Included by the bf16 kernels,
// flash_attention_bf16.cu, ssd_scan_bf16.cu and their backwards
// flash_attention_bwd_bf16.cu and ssd_scan_bwd_bf16.cu (which take ex2 from
// mma_tf32x3.cuh).
//
// Tiles. Every operand tile lives in shared memory as rows of 64 bf16
// values (128 bytes), 1024-byte aligned, in the 128-byte swizzle that TMA
// writes (CU_TENSOR_MAP_SWIZZLE_128B): the 16-byte unit u of row r sits at
// unit u ^ (r % 8) of that row (`swz`; a kernel that writes an operand
// tile itself writes it so). A tensor dimension wider than 64 values is
// loaded as several such tiles, one per 64 values ("column blocks"). A TMA
// box narrower than 64 values of the tensor's innermost dimension (a head
// dim of 16) still fills 64: TMA writes zeros outside the tensor, so the
// box is always 64 wide and the padding is zero. Rows past the tensor's
// end come as zeros the same way.
//
// Tensor maps are encoded on the host per launch (`make_map`) and passed
// by value as `const __grid_constant__ CUtensorMap` parameters, so a
// captured CUDA graph keeps them with the buffers' addresses.
// cuTensorMapEncodeTiled is a driver function: it is fetched once through
// the runtime's driver entry point, so the library needs no -lcuda.
//
// Descriptors. `wgmma` reads its shared-memory operands through a 64-bit
// descriptor (start address, leading and stride byte offsets, swizzle).
// For the 128-byte swizzle:
//   K-major (the reduction index contiguous: Q and K for Q K^T, C and B
//     for C B^T): rows of the operand are the tile's rows, 8-row groups
//     1024 bytes apart (SBO); a k16 step advances the start by 32 bytes
//     within the 128-byte row (`desc_k`).
//   MN-major (the row or column index contiguous: V for P V, x and the
//     scaled B of the scan's state update): the tile's rows run over k,
//     8-row groups 1024 bytes apart (SBO), the next 64 values of M or N in
//     the next column block (LBO); a k16 step advances the start by 16
//     rows, 2048 bytes (`desc_mn`). bf16 is one of the types for which
//     `wgmma` takes such a transposed operand from shared memory.
//
// Products. `Wgmma<N>::ss<TA, TB>` is m64nNk16 with A and B from shared
// memory (TA, TB: 0 K-major, 1 MN-major; N = 32, 64, 128; an MN-major A is
// a tile whose rows run over k, the M index contiguous, as a kernel that
// wrote a transposed operand tile reads it), `Wgmma<N>::rs<TB>`
// with A from registers (N = 16, 32, 64, 128): the forms the kernels use.
// A warpgroup (four warps, 128 threads) issues them together; warp w of
// the group holds rows 16w..16w+15 of the 64. Per warp the
// accumulator is mma.sync's m16n8 layout repeated over the N / 8 column
// tiles: with g = lane / 4 and t = lane % 4, d[4j + e] is row g + 8 (e / 2),
// column 8j + 2t + e % 2. The register A operand is mma.sync's m16n8k16 A
// fragment on the warp's rows, so two neighbouring column tiles of an
// accumulator, rounded to bf16 and paired, are the A operand of a product
// over those 16 columns as they stand (`acc_pair_as_a`). The products run
// asynchronously: `wg_fence` before a batch (after the registers it reads
// were written), `wg_commit` after it, `wg_wait<n>` until at most n
// batches are in flight; `fence_regs` keeps the compiler from moving reads
// or writes of an accumulator across them.
//
// Barriers. A stage of a ring has a `full` mbarrier, which the producer
// arms with the bytes its TMA loads bring (`mbar_expect_tx`,
// `mbar_arrive_expect_tx`) and the
// consumers wait on, and an `empty` one, on which each consumer warp
// arrives when it is done with the stage. `mbar_wait(bar, k & 1)` waits
// for the k-th completion (from 0) of a barrier's phase.

#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the function is fetched
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace hopper {

// ---- host ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map over a bf16 tensor of `rank` (at most 5) dimensions,
// innermost first: `dims` their sizes, `strides` the strides of dims 1..
// in elements (multiples of 8: 16 bytes), `box` the tile TMA copies
// (box[0] = 64 values, one 128-byte row), 128-byte swizzle, zeros outside
// the tensor. Returns a cudaError_t (cudaErrorInvalidValue where the
// driver refuses the map).
inline int make_map(CUtensorMap* map, const void* base, int rank,
                    const int64_t* dims, const int64_t* strides,
                    const int* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cuuint64_t gd[5], gs[4];
  cuuint32_t bd[5], es[5];
  for (int i = 0; i < rank; ++i) {
    gd[i] = static_cast<cuuint64_t>(dims[i]);
    bd[i] = static_cast<cuuint32_t>(box[i]);
    es[i] = 1;
    if (i + 1 < rank) gs[i] = static_cast<cuuint64_t>(strides[i]) * 2;
  }
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank),
      const_cast<void*>(base), gd, gs, bd, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Raise a kernel's dynamic shared-memory limit once on each device a
// launch reaches (a per-device attribute), for each kernel instance.
template <auto Kernel>
inline int allow_smem(int bytes) {
  constexpr int MAX_DEVICES = 64;
  static int configured[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < MAX_DEVICES && configured[device] >= bytes) return 0;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < MAX_DEVICES) configured[device] = bytes;
  return 0;
}

// ---- bf16 values --------------------------------------------------------

// Two floats rounded to bf16 (to nearest even) in one register, `lo` in
// the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A float rounded to bf16 and back (to nearest even), as the reference's
// `.astype(bfloat16)` rounds.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The two bf16 values of a register as floats (exact).
__device__ __forceinline__ float lo_of(uint32_t r) {
  return __uint_as_float(r << 16);
}
__device__ __forceinline__ float hi_of(uint32_t r) {
  return __uint_as_float(r & 0xffff0000u);
}

// ---- shared memory, mbarriers, TMA --------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of the 16-byte unit holding (row r, values 8u..8u+7) of a
// swizzled 64-value tile.
__device__ __forceinline__ int swz(int r, int u) {
  return r * 128 + ((u ^ (r & 7)) << 4);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Orders this thread's shared-memory writes before later reads and writes
// of the async proxy (wgmma operands, TMA).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrives and adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Adds `bytes` to the transactions the phase waits for, without arriving.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  while (!mbar_try_wait(addr, parity)) {
  }
}

// A TMA tile load of a 4-D box at (c0, c1, c2, c3) (innermost first, in
// elements; a box past the tensor's edges is zero-filled there) into
// shared memory, completing `bytes` of `bar`'s transactions.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing `bytes` of `bar`'s
// transactions (no tensor map: a contiguous run of bytes).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Starts fetching a tensor map (a kernel parameter) ahead of its first
// TMA load.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ldmatrix.x4.trans: four 8 x 8 bf16 tiles, tile i's eight stored rows at
// the addresses lanes 8i..8i+7 pass (16 bytes each); lane (g, t) receives
// of tile i the elements [2t][g] and [2t + 1][g] as stored, in r[i].
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

// Named barrier over `threads` threads (a multiple of 32), id 1..15.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma --------------------------------------------------------------

// The descriptor of a 128-byte-swizzled operand starting at `smem`
// (1024-byte aligned tile, plus the k step's offset).
__device__ __forceinline__ uint64_t desc(const void* smem, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(smem) & 0x3ffff) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// K-major: k16 step `kk` of a tile whose rows hold 64 values of k (one
// column block; step kk lies in block kk / 4 of a tile of `block` bytes
// per column block).
__device__ __forceinline__ uint64_t desc_k(const void* tile, int kk,
                                           int block) {
  return desc(static_cast<const char*>(tile) + (kk >> 2) * block +
                  (kk & 3) * 32,
              16, 1024);
}

// MN-major: k16 step `kk` of a tile whose rows run over k, the next 64
// values of M or N `block` bytes on.
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int kk,
                                            int block) {
  return desc(static_cast<const char*>(tile) + kk * 2048, block, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of `d` across an asynchronous
// product's issue or wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The accumulator's column tiles 2kk and 2kk + 1 (d[8kk..8kk+7]), rounded
// to bf16, as the register A operand of a k16 step over their 16 columns.
template <int R>
__device__ __forceinline__ void acc_pair_as_a(uint32_t (&a)[4],
                                              const float (&d)[R], int kk) {
  a[0] = pack(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack(d[8 * kk + 6], d[8 * kk + 7]);
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // d (64 x 16, fp32) += A (64 x 16, registers, in mma.sync's m16n8k16 A
  // fragment order on each warp's 16 rows) * B (16 x 16, shared memory).
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{" "%0, %1, %2, %3, %4, %5, %6, %7" "}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
          "n"(TB));
  }
};

template <>
struct Wgmma<32> {
  // d (64 x 32, fp32) += A (64 x 16, shared memory) * B (16 x 32, shared
  // memory); TA, TB: 0 K-major, 1 MN-major.
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15" "}, "
        "%16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  }
  // d (64 x 32, fp32) += A (64 x 16, registers, in mma.sync's m16n8k16 A
  // fragment order on each warp's 16 rows) * B (16 x 32, shared memory).
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15" "}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
          "n"(TB));
  }
};

template <>
struct Wgmma<64> {
  // d (64 x 64, fp32) += A (64 x 16, shared memory) * B (16 x 64, shared
  // memory); TA, TB: 0 K-major, 1 MN-major.
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31" "}, "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  }
  // The same with A (64 x 16) from registers, in mma.sync's m16n8k16 A
  // fragment order on each warp's 16 rows.
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31" "}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
          "n"(TB));
  }
};

template <>
struct Wgmma<128> {
  // d (64 x 128, fp32) += A (64 x 16, shared memory) * B (16 x 128, shared
  // memory); TA, TB: 0 K-major, 1 MN-major.
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63" "}, "
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  }
  // The same with A (64 x 16) from registers, in mma.sync's m16n8k16 A
  // fragment order on each warp's 16 rows.
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63" "}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
          "n"(TB));
  }
};

}  // namespace hopper
