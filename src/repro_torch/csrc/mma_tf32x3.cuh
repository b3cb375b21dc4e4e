// fp32 matrix products on the tensor cores: 3xTF32 `mma.sync` steps, and
// the `cp.async` copies that feed them. Included by flash_attention.cu,
// flash_attention_bwd.cu, ssd_scan.cu, ssd_scan_bwd.cu and
// lstm_cell_tile.cuh.
//
// A TF32 product keeps 10 mantissa bits, about three decimal digits, which
// does not meet the kernels' bar of 1e-4 of fp32. So each fp32 operand a is
// split as big = a rounded to TF32 (to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds) and small = a - big (exact in fp32, at most
// 2^-11 |a|), and a product is accumulated in fp32 as
//   small * big' + big * small' + big * big'
// (the small terms first; small * small' is below fp32's resolution). This
// is the "fast fp32" scheme of CUTLASS's mma_tensor_op_fast_f32.h: about
// fp32 accuracy at a third of the TF32 tensor-core rate. The rounding is
// two integer operations on the bits; small goes in unrounded, since the
// tensor core reads only the top 19 bits of a TF32 operand (its dropped
// bits are below 2^-21 |a|). Splitting is most of the arithmetic around
// the products, so it is kept to three instructions a value.
//
// One step is `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`:
// D (16 x 8) += A (16 x 8, row-major) * B (8 x 8, "col": K x N).
// With g = lane / 4 and t = lane % 4, a lane holds
//   A: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B: b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   D: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
// A sum over k does not care in which order k runs, as long as A and B
// agree. Both kernels use that to feed an accumulator straight back in as
// the A operand of the next product, with no shuffle: logical k = t is
// taken to be physical column 2t and k = t + 4 column 2t + 1, so
//   a0 = c0, a1 = c2, a2 = c1, a3 = c3,
// and the B operand's rows are read at the same physical positions,
// b0 = B[2t][g], b1 = B[2t + 1][g] (see `load_b_paired`).

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace tf32x3 {

// A fragment (4 registers) or B fragment (2 registers) split in two.
struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

// x rounded to TF32: half a unit of the 13 dropped bits added to the
// magnitude, then the bits cleared (finite x).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  FragA f;
  split(a0, f.big[0], f.small[0]);
  split(a1, f.big[1], f.small[1]);
  split(a2, f.big[2], f.small[2]);
  split(a3, f.big[3], f.small[3]);
  return f;
}

__device__ __forceinline__ FragB split_b(float b0, float b1) {
  FragB f;
  split(b0, f.big[0], f.small[0]);
  split(b1, f.big[1], f.small[1]);
  return f;
}

// One TF32 m16n8k8 step: d += a * b. Not volatile: the compiler may
// move independent steps past each other.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32 steps d[i] += a * b[i], to about fp32 accuracy, for N tiles that
// share their A operand. A tile's three terms depend on each other and a
// warp issues in order, so they go term by term over the tiles:
// consecutive tensor-core steps are independent and overlap in the pipe.
template <int N>
__device__ __forceinline__ void mma3_row(float (*d)[4], const FragA& a,
                                         const FragB* b) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma(d[i], a.small, b[i].big);
#pragma unroll
  for (int i = 0; i < N; ++i) mma(d[i], a.big, b[i].small);
#pragma unroll
  for (int i = 0; i < N; ++i) mma(d[i], a.big, b[i].big);
}

// 3xTF32 steps d[i] += a[i] * b for N tiles that share their B operand,
// term by term as mma3_row.
template <int N>
__device__ __forceinline__ void mma3_col(float (*d)[4], const FragA* a,
                                         const FragB& b) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma(d[i], a[i].small, b.big);
#pragma unroll
  for (int i = 0; i < N; ++i) mma(d[i], a[i].big, b.small);
#pragma unroll
  for (int i = 0; i < N; ++i) mma(d[i], a[i].big, b.big);
}

// A fragment (16 x 8) of an M x K row-major array in shared memory, in the
// natural k order: a0 = s[m0 + g][k0 + t], a1 = s[m0 + g + 8][k0 + t],
// a2 = s[m0 + g][k0 + t + 4], a3 = s[m0 + g + 8][k0 + t + 4]. Conflict-free
// at a stride of 4 mod 32.
__device__ __forceinline__ FragA load_a(const float* s, int ld, int m0,
                                        int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = s + (m0 + g) * ld + k0 + t;
  return split_a(p[0], p[8 * ld], p[4], p[8 * ld + 4]);
}

// A fragment (16 x 8) of the transpose of a K x M row-major array in
// shared memory, over the paired k order: a0 = s[k0 + 2t][m0 + g],
// a1 = s[k0 + 2t][m0 + g + 8], a2 = s[k0 + 2t + 1][m0 + g],
// a3 = s[k0 + 2t + 1][m0 + g + 8]. Conflict-free at a stride of 4 mod 16.
__device__ __forceinline__ FragA load_at_paired(const float* s, int ld,
                                                int k0, int m0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = s + (k0 + 2 * t) * ld + m0 + g;
  return split_a(p[0], p[8], p[ld], p[ld + 8]);
}

// B fragment (K x N = 8 x 8) read from an N x K row-major array (the
// operand transposed: b0 = s[n0 + g][k0 + t]), as for Q K^T. Conflict-free
// at a stride of 4 mod 32.
__device__ __forceinline__ FragB load_b_nk(const float* s, int ld, int n0,
                                           int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = s + (n0 + g) * ld + k0 + t;
  return split_b(p[0], p[4]);
}

// B fragment (8 x 8) read from a K x N row-major array in the natural k
// order: b0 = s[k0 + t][n0 + g], b1 = s[k0 + t + 4][n0 + g]. Conflict-free
// at a stride of 8 mod 32; two lanes a bank at 4 mod 32.
__device__ __forceinline__ FragB load_b_kn(const float* s, int ld, int k0,
                                           int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = s + (k0 + t) * ld + n0 + g;
  return split_b(p[0], p[4 * ld]);
}

// B fragment read from a K x N row-major array with the paired k order of
// the accumulator-as-A trick above: b0 = s[k0 + 2t][n0 + g],
// b1 = s[k0 + 2t + 1][n0 + g], each row scaled by `w0`, `w1`.
// Conflict-free at a stride of 4 mod 16 (then 2t * ld hits 0, 8, 16, 24).
__device__ __forceinline__ FragB load_b_paired(const float* s, int ld,
                                               int k0, int n0, int lane,
                                               float w0 = 1.f,
                                               float w1 = 1.f) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = s + (k0 + 2 * t) * ld + n0 + g;
  return split_b(p[0] * w0, p[ld] * w1);
}

// An accumulator c (16 x 8) as the A operand (16 x 8 over the paired k
// order) of the next product.
__device__ __forceinline__ FragA acc_as_a(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// 2^x on the special-function unit (ex2.approx: about 2 ulp; results
// below 2^-126 flush to zero, 2^-inf is 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// -- cp.async -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1; with `valid` false
// nothing is read and the 16 bytes are zero-filled (`src` must still be a
// mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes, the same way (for rows that are not 16-byte aligned).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace tf32x3
