// bf16 matrix products on the tensor cores: `mma.sync` m16n8k16 steps on
// bf16 operands with fp32 accumulators, and the fragment loads that feed
// them. Included by the bf16 backward kernels, flash_attention_bwd_bf16.cu
// and ssd_scan_bwd_bf16.cu (which take cp.async and ex2 from
// mma_tf32x3.cuh).
//
// One step is `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`:
// D (16 x 8) += A (16 x 16, row-major) * B (16 x 8, "col": K x N). Each
// 32-bit register holds two bf16 values, the lower k (or column) in the
// low half. With g = lane / 4 and t = lane % 4, a lane holds
//   A: a0 (g, 2t..2t+1), a1 (g + 8, 2t..2t+1), a2 (g, 2t+8..2t+9),
//      a3 (g + 8, 2t+8..2t+9)            [row, k]
//   B: b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8..2t+9, n = g)
//   D: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
// So the accumulators of two neighbouring 16 x 8 tiles, (columns 0..7 and
// 8..15), rounded to bf16 and paired, are the A fragment of the next
// product over those 16 columns as k, in the natural order: a0 = (c0, c1)
// of the first, a1 = (c2, c3) of the first, a2 and a3 the same of the
// second (`acc_pair_as_a`). No shuffle and no shared-memory stage.
//
// A B fragment whose k runs along a row of a row-major array in shared
// memory (an N x K array, as K for Q K^T) is two 32-bit reads
// (`load_b_nk`); one whose k runs down a column (a K x N array, as V for
// P V) comes from `ldmatrix.trans`, which hands each lane the transpose
// of 8 x 8 tiles (`ldsm_x4_trans`). Every 8-row slice of a tile read by
// ldmatrix must start on 16 bytes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace bf16mma {

// Two floats rounded to bf16 (to nearest even) in one register, `lo` in
// the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two bf16 values of a register as floats (exact).
__device__ __forceinline__ float lo_of(uint32_t r) {
  return __uint_as_float(r << 16);
}
__device__ __forceinline__ float hi_of(uint32_t r) {
  return __uint_as_float(r & 0xffff0000u);
}

// A float rounded to bf16 and back (to nearest even), as the reference's
// `.astype(bfloat16)` rounds.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One m16n8k16 step: d += a * b. Not volatile: the compiler may move
// independent steps past each other.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment (16 x 16) read from an M x K row-major bf16 array in shared
// memory (a0 = s[m0 + g][k0 + 2t..+1], a1 = s[m0 + 8 + g][k0 + 2t..+1],
// a2 and a3 the same at k0 + 8). Conflict-free under load_b_nk's rule.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* s, int ld,
                                       int m0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* p = s + (m0 + g) * ld + k0 + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// B fragment (K x N = 16 x 8) read from an N x K row-major bf16 array in
// shared memory (the operand transposed: b0 = s[n0 + g][k0 + 2t..+1],
// b1 = s[n0 + g][k0 + 8 + 2t..+1]). Conflict-free when the row stride in
// 32-bit words is 4 mod 8 (or any stride whose eight rows g * stride + t
// land in distinct banks).
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[2],
                                          const __nv_bfloat16* s, int ld,
                                          int n0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* p = s + (n0 + g) * ld + k0 + 2 * t;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix.x4.trans: four 8 x 8 bf16 tiles, tile i's eight rows at the
// addresses that lanes 8i..8i+7 pass (16 bytes each); lane l receives
// of each tile the elements [2t][g] and [2t + 1][g] (t = l % 4,
// g = l / 4) of the tile as stored, i.e. row g of its transpose.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* row_addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row_addr)));
}

// The B fragments of two 8-column tiles (n0 and n0 + 8) of a K x N
// row-major bf16 array in shared memory over k0..k0+15 (b0 =
// s[k0 + 2t..+1][n + g], b1 = s[k0 + 8 + 2t..+1][n + g]): one
// ldmatrix.x4.trans. Conflict-free when the row stride in bytes is an odd
// multiple of 16 (eight rows on distinct 16-byte bank groups).
__device__ __forceinline__ void load_b_kn_pair(uint32_t (&b0)[2],
                                               uint32_t (&b1)[2],
                                               const __nv_bfloat16* s,
                                               int ld, int k0, int n0,
                                               int lane) {
  // lanes 0-7: rows k0..k0+7 at n0 (b0 of tile n0); 8-15: rows k0+8..15
  // at n0 (b1 of tile n0); 16-23 and 24-31 the same at n0 + 8
  const int i = lane & 7, tile = lane >> 3;
  const __nv_bfloat16* p =
      s + (k0 + i + 8 * (tile & 1)) * ld + n0 + 8 * (tile >> 1);
  uint32_t r[4];
  ldsm_x4_trans(r, p);
  b0[0] = r[0];
  b0[1] = r[1];
  b1[0] = r[2];
  b1[1] = r[3];
}

// The accumulators of two neighbouring 16 x 8 tiles (columns c..c+7 and
// c+8..c+15), rounded to bf16, as the A fragment of a product over those
// 16 columns as k (see the header).
__device__ __forceinline__ void acc_pair_as_a(uint32_t (&a)[4],
                                              const float (&c0)[4],
                                              const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

}  // namespace bf16mma
