// TF32 helpers shared by the kernels that run float32 products on the tensor
// cores with the 3-pass split (flash_attention.cu, flash_attention_bwd.cu).
//
// TF32 keeps 10 mantissa bits, so one TF32 product is off by up to ~2^-11 of
// each operand: ~1e-3 at the main paths' shapes, 100 times the 1e-5 the
// tests hold the f32 kernels to. Each operand is written instead as
// x = hi + lo, with hi = tf32(x) and lo = tf32(x - hi), both rounded to
// nearest with ties away from zero (the rounding of cvt.rna.tf32.f32, done
// as an add and a mask). x - hi is exact in f32 and |lo| <= 2^-11 |x|, so
// hi + lo holds x to ~2^-22. A product is summed as a_lo b_hi + a_hi b_lo +
// a_hi b_hi into f32 accumulators, the two small products first. Each
// hi * hi product (11 x 11 significant bits) is exact in f32; the one term
// left out, a_lo b_lo, is ~2^-22 of the product.
//
// Non-finite inputs: the add and mask would carry a NaN's mantissa into its
// sign (the canonical NaN 0x7fffffff becomes -0) and a ±Inf would leave NaN
// in lo. So a non-finite x goes whole into lo, with hi = 0: then a_lo b_hi or
// a_hi b_lo carries the product's ±Inf or NaN, as a * b would, and the other
// two products are 0.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Round a finite x to TF32 (10 mantissa bits), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 does.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32: hi = tf32(x), lo = tf32(x - hi); a non-finite x is
// all lo.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const bool finite = fabsf(x) < INFINITY;
  hi = finite ? to_tf32(x) : 0u;
  const float r = x - __uint_as_float(hi);
  lo = finite ? to_tf32(r) : __float_as_uint(r);
}

// c += a b for one m16n8k8 tile: a 16 x 8 (row), b 8 x 8 (col), TF32 in, f32 c.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
