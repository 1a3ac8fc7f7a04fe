// TF32 helpers shared by the kernels that run float32 products on the tensor
// cores with the 3-pass split (flash_attention.cu, flash_attention_bwd.cu):
// the split itself, and the pre-pass kernel that writes an operand's split
// planes once per call for TMA to feed to the products.
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
#include <stddef.h>
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

// The operands a kernel streams, as TF32 planes (the split above: x = hi +
// lo, a non-finite x all lo) in device memory: each source [heads, rows, D]
// into natural planes hi and lo of its own layout, where `hi` is set, and,
// where `thi` is set, transposed planes [heads, D, rows8] (rows8 = rows
// rounded up to 8, zeros past `rows`) whose positions in each group of 8
// hold the rows 0, 2, 4, 6, 1, 3, 5, 7 of the group: the order in which an
// accumulator's columns become the A fragment of the next product (lane
// (g, t) holds columns 2t and 2t + 1 of each 8, used as mma indices t and
// t + 4). A job past the last in use has first_block INT_MAX.
struct SplitJob {
  const float* src;
  float *hi, *lo, *thi, *tlo;
  int heads, rows, rows8, first_block;
};

struct SplitJobs {
  SplitJob job[4];
};

// One 32 x 32 tile of a source per block of 32 x 8 threads.
template <int D>
__global__ void __launch_bounds__(256) tf32_split_kernel(const SplitJobs jobs) {
  constexpr int CT = (D + 31) / 32;
  __shared__ float hs[32][33], ls[32][33];
  int k = 0;
  while (k + 1 < 4 && (int)blockIdx.x >= jobs.job[k + 1].first_block) ++k;
  const SplitJob& job = jobs.job[k];
  const int tiles_r = (job.rows8 + 31) / 32;
  const int local = blockIdx.x - job.first_block;
  const int head = local / (tiles_r * CT);
  const int rt = (local / CT) % tiles_r, ct = local % CT;
  const int r0 = rt * 32, c0 = ct * 32;
  const size_t src0 = (size_t)head * job.rows * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = threadIdx.y + 8 * i, row = r0 + r, col = c0 + threadIdx.x;
    uint32_t h = 0u, l = 0u;
    if (row < job.rows && col < D) {
      const size_t at = src0 + (size_t)row * D + col;
      split(job.src[at], h, l);
      if (job.hi != nullptr) {
        job.hi[at] = __uint_as_float(h);
        job.lo[at] = __uint_as_float(l);
      }
    }
    hs[r][threadIdx.x] = __uint_as_float(h);
    ls[r][threadIdx.x] = __uint_as_float(l);
  }
  if (job.thi == nullptr) return;
  __syncthreads();
  const int r = threadIdx.x, row = r0 + r;
  const int pos = (row & ~7) | ((row & 7) >> 1) | ((row & 1) << 2);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = threadIdx.y + 8 * i, col = c0 + c;
    if (col < D && row < job.rows8) {
      const size_t at = ((size_t)head * D + col) * job.rows8 + pos;
      job.thi[at] = hs[r][c];
      job.tlo[at] = ls[r][c];
    }
  }
}

// Blocks of tf32_split_kernel<D> a job takes.
inline int split_blocks(const SplitJob& job, int d) {
  return job.heads * ((job.rows8 + 31) / 32) * ((d + 31) / 32);
}

}  // namespace
