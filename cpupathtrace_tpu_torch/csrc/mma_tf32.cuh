// TF32 products on Hopper's tensor cores with mma.sync m16n8k8 (sm_80 and
// later), shared by the microbenchmarks X3 (exp_record_variants.cu) and X4
// (exp_dot_formulations.cu).
//
// Fragments of one m16n8k8 product D[16, 8] += A[16, 8] B[8, 8], with
// g = lane / 4 and t = lane % 4 (PTX ISA, "Matrix Fragments for mma.m16n8k8"):
//   a[0] = A[g][t], a[1] = A[g + 8][t], a[2] = A[g][t + 4], a[3] = A[g + 8][t + 4];
//   b0 = B[t][g], b1 = B[t + 4][g];
//   d[0] = D[g][2t], d[1] = D[g][2t + 1], d[2] = D[g + 8][2t], d[3] = D[g + 8][2t + 1].
// `tf32` rounds a float to TF32 (10 mantissa bits, to nearest, ties away
// from zero: cvt.rna); `split` gives x = hi + lo with both TF32, for the
// 3xTF32 product a_lo b_hi + a_hi b_lo + a_hi b_hi, which keeps about
// float32 accuracy (the a_lo b_lo term, ~2^-22 of the product, is dropped).
#pragma once

#include <stdint.h>

namespace ptx {

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace ptx
