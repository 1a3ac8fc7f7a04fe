// Batched GraphSAGE neighbor mean: out[b] = (A[b] @ H[b]) / max(rowsum(A[b]), 1),
// on the tensor cores, accurate to float32.
//
// Replaces the TPU kernel `sage_aggregate` / `_sage_kernel` in
// src/repro/kernels/sage_aggregate.py (wrapper and custom VJP in
// src/repro/kernels/ops.py). The Pallas kernel walks a sequential
// (row, col, k) grid, carries the product and the row degree in VMEM scratch
// across k steps and divides on the last one. Here the k loop runs inside the
// block, and one launch covers every client: blockIdx.z indexes the batch.
//
// Accuracy: the 3-pass TF32 split ("3xTF32"). TF32 keeps 10 mantissa bits,
// so one TF32 product is off by up to ~2^-11 of each operand: ~1e-3 at the
// main path's shapes, 100 times the 1e-5 the tests hold the kernel to. Each
// operand is written instead as x = hi + lo, with hi = tf32(x) and
// lo = tf32(x - hi), both rounded to nearest with ties away from zero (the
// rounding of cvt.rna.tf32.f32, issued as an add and a mask). x - hi is exact
// in f32 and |lo| <= 2^-11 |x|, so hi + lo holds x to ~2^-22. The kernel sums
// a_lo h_hi + a_hi h_lo + a_hi h_hi into f32 accumulators, the two small
// products first. Each hi * hi product (11 x 11 significant bits) is exact in
// f32; the one term left out, a_lo h_lo, is ~2^-22 of the product. So the
// result is float32 to within summation order. Both operands need the split:
// A on the main path is a_norm, rows of 1/deg, which TF32 does not hold
// exactly. The row degree is summed in plain f32 from the unsplit A values,
// and the division happens once in the epilogue.
//
// Non-finite inputs: the add and mask would carry a NaN's mantissa into its
// sign (the canonical NaN 0x7fffffff becomes -0) and a ±Inf would leave
// NaN in lo. So a non-finite x goes whole into lo, with hi = 0: then a_lo h_hi
// or a_hi h_lo carries the product's ±Inf or NaN, as a * h would (a_hi is 0
// only where a is), and the other two products are 0. That fails only where
// both operands of one product are non-finite: a_lo h_lo, the one product
// that holds both, is left out, and the two kept pair an Inf with a 0, giving
// NaN where a * h is ±Inf (a -Inf in A against a ±Inf in H). No placement of
// a non-finite value in the split avoids some Inf x 0 among three products.
// So the rule is: wherever an accumulator is NaN, the epilogue recomputes that
// output as a plain f32 dot of A's row and H's column read from global memory,
// which gives the IEEE result (NaN, ±Inf) the plain version gives. Finite
// inputs never make a NaN, so on the main path this costs one compare per
// output. The degree clamp keeps a NaN, as torch.clamp_min does. The
// finiteness test costs ~16 % at layer 1 (8 instructions per split value
// against 5: the kernel is short of issue slots).
//
// What bounds it on the H100: operations. At the main path's layer-1 shape
// (6 clients, n = 6123, d = 6805) the product is 2*6*6123^2*6805 = 3.06 TFLOP
// over ~2.9 GB of inputs and output; three TF32 passes at the 495 TFLOP/s
// dense TF32 peak take at least 18.6 ms (f32 on the CUDA cores, 67 TFLOP/s:
// 45.7 ms). mma.sync alone reaches 308-322 TFLOP/s of TF32 on the H100
// (tools/mma_tf32_ceiling.py), so three passes through it take at least ~29 ms.
// Layer 2 (d = 32) is bound by reading A once: 0.9 GB, 0.27 ms.
//
// What the design does about it:
// - mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32. A warp owns 64 x 64
//   outputs (4 x 8 mma tiles) and splits each A fragment once per k-step for
//   its 8 n-tiles and each B fragment once for its 4 m-tiles, then issues the
//   32 products of one pass before the next pass adds to the same
//   accumulators. Blocks of 4 warps (128 x 128 outputs), two per SM, for
//   d > 64; for d <= 64 (layer 2, d = 32), 64 x 32 blocks of 8 warps, where a
//   wider tile would compute columns nobody asked for.
// - A and H tiles arrive by cp.async into a ring of 4 stages in dynamic
//   shared memory (BK = 16 deep for d > 64, 32 for the narrow instance),
//   with one __syncthreads per tile. None of the main path's widths
//   (n = 6123, 914; d = 6805, 1433) is a multiple of 4 floats, so rows and
//   the per-client bases start off 16-byte boundaries, where neither a
//   16-byte cp.async nor TMA can read them. The copies are 4-byte
//   cp.async.ca, each warp on contiguous floats of a row, so the inputs are
//   read where they lie and nothing is copied to aligned buffers; ragged
//   edges are zero-filled by the copy. Through L1, the part of a 128-byte
//   line that one tile leaves is still there for the next, so the ring is
//   kept shallow: its shared memory comes out of L1.
// - In each k-step of 8, lane t's mma index t is column 2t of the step and
//   index t + 4 the column after it, for A and H alike (any order of k is the
//   same sum). A lane then reads its two A values of a row as one 8-byte word.
//   Shared rows are padded (A: BK + 8 floats, H: BN + 4) so that every
//   fragment read of a warp hits distinct banks.
// - The row degree comes from the A values each warp already reads: per lane
//   two partial sums per m-tile, reduced across the quad by shuffles.
// - Grouped tile order: consecutive blocks walk GROUP row tiles before the
//   next column tile, so the ~264 blocks resident at once cover ~16 row
//   stripes and ~16 column stripes of a client: ~50 MB of A and ~52 MB of H
//   per wave of 264 tiles, ~59 waves at layer 1, ~6 GB from HBM in all
//   (~1.8 ms), where a column-fastest order spans all 54 column stripes
//   (167 MB of H) per wave, 10-19 GB.
//
// Why mma.sync and cp.async, not wgmma and TMA: TF32 wgmma takes B only
// K-major from shared memory, and H is d-contiguous, so every H tile would
// need a transposing pass; TMA needs 16-byte multiples for global strides,
// and these rows are 4-byte aligned. mma.sync gathers B from shared memory in
// any layout. wgmma (or a bf16 split, which wgmma takes N-major) is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "tf32.cuh"

namespace {

constexpr int GROUP = 16;      // row tiles walked before the next column tile
constexpr int STAGES = 4;      // tiles in the shared-memory ring
constexpr int MIN_BLOCKS = 2;  // blocks per SM the register allocation must allow

// A block tile of BM x BN outputs, split among warps of WM x WN, with A and H
// tiles BK deep.
template <int BM_, int BN_, int BK_, int WM_, int WN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr int LDA = BK + 8;  // A tile row pitch (8-byte fragment reads: 32 banks)
  static constexpr int THREADS = 32 * (BM / WM) * (BN / WN);
  static constexpr int MT = WM / 16;  // m16 tiles per warp
  static constexpr int NT = WN / 8;   // n8 tiles per warp
  static constexpr int WARPS_N = BN / WN;
  static constexpr int LDH = BN + 4;  // H tile row pitch (B fragment reads: 32 banks)
  static constexpr int A_FLOATS = BM * LDA;
  static constexpr int H_FLOATS = BK * LDH;
  static constexpr size_t SMEM = sizeof(float) * (size_t)STAGES * (A_FLOATS + H_FLOATS);
  static_assert(BM * BK % THREADS == 0 && BK * BN % THREADS == 0 && THREADS % BN == 0,
                "whole copy rounds");
};

using Wide = Tile<128, 128, 16, 64, 64>;
using Narrow = Tile<64, 32, 32, 16, 16>;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, or 4 zero bytes where !valid (nothing is read).
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// sum_k a[k] h[k * d] in f32, in order: the IEEE result for an output whose
// split sum is NaN (see the note on non-finite inputs). Off the main path.
__device__ __noinline__ float plain_dot(const float* a, const float* h, int n, int d) {
  float s = 0.0f;
  for (int k = 0; k < n; ++k) s = fmaf(a[k], h[(size_t)k * d], s);
  return s;
}

template <class T>
__global__ void __launch_bounds__(T::THREADS, MIN_BLOCKS)
sage_aggregate_kernel(const float* __restrict__ adj, const float* __restrict__ h,
                      float* __restrict__ out, int n, int d) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                         // [STAGES][BM][LDA]
  float* Hs = smem + STAGES * T::A_FLOATS;  // [STAGES][BK][LDH]

  const size_t b = blockIdx.z;
  const float* A = adj + b * (size_t)n * n;
  const float* H = h + b * (size_t)n * d;
  float* O = out + b * (size_t)n * d;

  // Grouped tile order: GROUP row tiles per column tile, then the next column.
  const int tiles_m = (n + T::BM - 1) / T::BM;
  const int tiles_n = (d + T::BN - 1) / T::BN;
  const int per_group = GROUP * tiles_n;
  const int first_m = (int)(blockIdx.x / per_group) * GROUP;
  const int group_rows = min(tiles_m - first_m, GROUP);
  const int in_group = (int)(blockIdx.x % per_group);
  const int row0 = (first_m + in_group % group_rows) * T::BM;
  const int col0 = (in_group / group_rows) * T::BN;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row (A, C) / column (B)
  const int t = lane & 3;   // fragment column (A) / row (B)
  const int wm = (warp / T::WARPS_N) * T::WM;
  const int wn = (warp % T::WARPS_N) * T::WN;

  // Copy roles: A column (tid % BK) of rows tid / BK + i * (THREADS / BK);
  //             H column (tid % BN) of k rows tid / BN + i * (THREADS / BN).
  // Each walks one pointer by a fixed stride, so no address is kept per copy.
  constexpr int THREADS = T::THREADS;
  constexpr int A_STEP = THREADS / T::BK, H_STEP = THREADS / T::BN;
  const int a_c = tid % T::BK, a_r = tid / T::BK;
  const int h_c = tid % T::BN, h_r = tid / T::BN;
  const int a_rows_left = n - row0 - a_r;  // copy i is in range while i * A_STEP < this
  const bool h_col_ok = col0 + h_c < d;
  const float* a_src = A + (size_t)(row0 + a_r) * n + a_c;
  const float* h_src = H + (size_t)h_r * d + col0 + h_c;

  auto load_stage = [&](int stage, int k0) {
    const uint32_t as = smem_u32(As + stage * T::A_FLOATS + a_r * T::LDA + a_c);
    const uint32_t hs = smem_u32(Hs + stage * T::H_FLOATS + h_r * T::LDH + h_c);
    const bool a_col_ok = k0 + a_c < n;
    const float* pa = a_src + k0;
#pragma unroll
    for (int i = 0; i < T::BM * T::BK / THREADS; ++i, pa += (size_t)A_STEP * n) {
      const bool ok = a_col_ok && i * A_STEP < a_rows_left;
      cp_async4(as + 4 * i * A_STEP * T::LDA, ok ? pa : A, ok);
    }
    const int h_rows_left = n - k0 - h_r;
    const float* ph = h_src + (size_t)k0 * d;
#pragma unroll
    for (int i = 0; i < T::BK * T::BN / THREADS; ++i, ph += (size_t)H_STEP * d) {
      const bool ok = h_col_ok && i * H_STEP < h_rows_left;
      cp_async4(hs + 4 * i * H_STEP * T::LDH, ok ? ph : H, ok);
    }
  };

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
  float deg[T::MT][2];  // partial row sums of A: rows g, g + 8 of each m-tile
#pragma unroll
  for (int i = 0; i < T::MT; ++i) deg[i][0] = deg[i][1] = 0.0f;

  const int k_tiles = (n + T::BK - 1) / T::BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load_stage(s, s * T::BK);
    cp_async_commit();
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed, for this thread
    __syncthreads();                 // ... for every thread; stage kt - 1 is free
    const int next = kt + STAGES - 1;
    if (next < k_tiles) load_stage(next % STAGES, next * T::BK);
    cp_async_commit();

    const float* as = As + (kt % STAGES) * T::A_FLOATS + (wm + g) * T::LDA + 2 * t;
    const float* hs = Hs + (kt % STAGES) * T::H_FLOATS + 2 * t * T::LDH + wn + g;
#pragma unroll
    for (int kk = 0; kk < T::BK; kk += 8) {
      // k-step kk: mma index t is tile column (A) / row (H) kk + 2t, index
      // t + 4 the one after it.
      uint32_t a_hi[T::MT][4], a_lo[T::MT][4];
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        const float2 r0 = *reinterpret_cast<const float2*>(as + i * 16 * T::LDA + kk);
        const float2 r1 = *reinterpret_cast<const float2*>(as + (i * 16 + 8) * T::LDA + kk);
        // (row, mma index) a0: (g, t), a1: (g + 8, t), a2: (g, t + 4), a3: (g + 8, t + 4).
        const float x[4] = {r0.x, r1.x, r0.y, r1.y};
        deg[i][0] += x[0] + x[2];
        deg[i][1] += x[1] + x[3];
#pragma unroll
        for (int q = 0; q < 4; ++q) split(x[q], a_hi[i][q], a_lo[i][q]);
      }
      // (mma index, column) b0: (t, g), b1: (t + 4, g).
      uint32_t b_hi[T::NT][2], b_lo[T::NT][2];
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const float* p = hs + kk * T::LDH + j * 8;
        split(p[0], b_hi[j][0], b_lo[j][0]);
        split(p[T::LDH], b_hi[j][1], b_lo[j][1]);
      }
      // The two small products first; MT * NT independent products per pass.
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
#pragma unroll
        for (int i = 0; i < T::MT; ++i) mma_tf32(acc[i][j], a_lo[i], b_hi[j][0], b_hi[j][1]);
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
#pragma unroll
        for (int i = 0; i < T::MT; ++i) mma_tf32(acc[i][j], a_hi[i], b_lo[j][0], b_lo[j][1]);
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
#pragma unroll
        for (int i = 0; i < T::MT; ++i) mma_tf32(acc[i][j], a_hi[i], b_hi[j][0], b_hi[j][1]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: the quad's four partial degrees, then one division per value.
  // c0, c1: row g, columns 2t, 2t + 1; c2, c3: row g + 8.
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float dg = deg[i][half];
      dg += __shfl_xor_sync(0xffffffffu, dg, 1);
      dg += __shfl_xor_sync(0xffffffffu, dg, 2);
      const float den = dg < 1.0f ? 1.0f : dg;  // max(dg, 1), NaN kept
      const int r = row0 + wm + i * 16 + half * 8 + g;
      if (r >= n) continue;
      float* o = O + (size_t)r * d;
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const int c = col0 + wn + j * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (c + e >= d) continue;
          float v = acc[i][j][2 * half + e];
          if (isnan(v)) v = plain_dot(A + (size_t)r * n, H + c + e, n, d);
          o[c + e] = v / den;
        }
      }
    }
  }
}

template <class T>
int launch(const float* adj, const float* h, float* out, int batch, int n, int d,
           cudaStream_t stream) {
  const cudaError_t set = cudaFuncSetAttribute(
      sage_aggregate_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::SMEM);
  if (set != cudaSuccess) return static_cast<int>(set);
  const unsigned tiles = (unsigned)((n + T::BM - 1) / T::BM) * ((d + T::BN - 1) / T::BN);
  const dim3 grid(tiles, 1, batch);
  sage_aggregate_kernel<T><<<grid, T::THREADS, T::SMEM, stream>>>(adj, h, out, n, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// adj [batch, n, n], h [batch, n, d], out [batch, n, d]: contiguous float32 on
// the device. Launches on `stream` and returns the cudaError_t of the launch.
extern "C" int sage_aggregate_f32(const float* adj, const float* h, float* out,
                                  int batch, int n, int d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch<Narrow>(adj, h, out, batch, n, d, s);
  return launch<Wide>(adj, h, out, batch, n, d, s);
}
