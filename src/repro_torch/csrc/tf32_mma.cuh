#pragma once
// 3xTF32 on `mma.sync m16n8k8 .tf32`: f32 products on the tensor cores that
// keep f32 accuracy. One TF32 product keeps about three decimal digits; the
// split x = hi + lo into two TF32 values and the three products lo.hi +
// hi.lo + hi.hi, summed in f32, keep x.y to about 2^-21 relative. The f32
// routes of K6 (flash_attention.cu) and K8 (mamba2_ssd.cu) use them.
//
// Fragments (thread g = lane / 4, t = lane % 4): A (16 x 8, row) a0 =
// A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4], a3 = A[g + 8][t + 4]; B (8 x
// 8, col) b0 = B[t][g], b1 = B[t + 4][g]; C and D (16 x 8) d0 = D[g][2t],
// d1 = D[g][2t + 1], d2 = D[g + 8][2t], d3 = D[g + 8][2t + 1].
#include <stdint.h>

// In the anonymous namespace each kernel source opens, so that these
// overloads sit beside the source's own (mamba2_ssd.cu's bf16 ldsm_x4).
namespace {

// x = hi + lo in two tf32 values. The tensor cores read a .tf32 operand's
// top 19 bits and ignore the low 13, so x's own bits serve as hi (x
// truncated to tf32) and need no instruction; lo = x - hi (exact) rounded
// to tf32 (nearest, ties away). hi + lo is x to about 2^-21 relative.
__device__ __forceinline__ uint32_t tf32_lo(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x - __uint_as_float(__float_as_uint(x) & 0xffffe000u)));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = tf32_lo(x);
}
// The same split with lo = x - hi left as it is: the tensor cores truncate
// it to tf32, so hi + lo is x to about 2^-20 relative, one instruction less.
__device__ __forceinline__ uint32_t tf32_lo_rz(float x) {
  return __float_as_uint(x - __uint_as_float(__float_as_uint(x) & 0xffffe000u));
}
__device__ __forceinline__ void split_tf32_rz(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = tf32_lo_rz(x);
}

// Four 8 x 4 f32 matrices (as 8 x 8 b16 ones) from shared memory: lanes
// 8m..8m+7 give the rows of matrix m; thread (g = lane / 4, t = lane % 4)
// receives row g, column t of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"((uint32_t)__cvta_generic_to_shared(p)));
}

// d += a (16 x 8, row) . b (8 x 8, col), tf32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// The three products that keep f32 accuracy: lo.hi + hi.lo + hi.hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

}  // namespace
