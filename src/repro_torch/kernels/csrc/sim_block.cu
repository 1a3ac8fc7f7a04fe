// Gram slab: out[i, j] = <rows[i], h[j]> for rows [b, c] and h [n, c], summed
// in float32 and written in the inputs' type (float32 or bfloat16).
//
// Replaces the TPU kernel `sim_block` / `_sim_kernel` in
// src/repro/kernels/sim_topk.py (wrapper `sim_block` in
// src/repro/kernels/ops.py, which pads b and n to the block sizes and slices
// the result). The Pallas kernel computes one (128 x 512) output block per
// grid step on the MXU. Here one block owns a 128 x 128 output tile and pads
// nothing: ragged b and n are masked in the loads and the stores.
//
// What bounds it on the H100: the bytes it writes. With c = 15 (the classes
// of Coauthor-CS, the gram `A̅ = H Hᵀ` that `sim_topk` fuses away) each output
// value costs 2c = 30 operations and 4 bytes of store: at 12246 x 12246 the
// output is 600 MB, 0.18 ms at 3.35 TB/s, against 0.07 ms of float32
// operations at 67 TFLOP/s. The inputs are a few hundred KB and stay in L2.
//
// What the design does about it: 256 threads, each with an 8 x 8 register
// micro-tile (rows 4 * ty + i and 64 + 4 * ty + i, columns 4 * tx + j and
// 64 + 4 * tx + j). Tiles of rows and h are staged in shared memory as f32,
// transposed to [k][row], in chunks of 16 along c, and each k step reads two
// float4 of each and does 64 FMAs, in a fixed order along c. The stores are
// vectors of VEC values (VEC = 4, 2 or 1, the widest that divides n, so
// every row starts aligned), and the 16 threads of a half-warp cover 64
// consecutive columns of one row: each store instruction writes whole
// contiguous runs of a row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // output rows per block
constexpr int BN = 128;      // output columns per block
constexpr int BK = 16;       // chunk of c staged at a time
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// VEC consecutive values of `v` to `p` (VEC * sizeof(T) bytes, aligned).
template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  if constexpr (VEC == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<const uint32_t*>(&lo);
    raw.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = raw;
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// Rows [r0, r0 + 128) x columns [k0, k0 + 16) of a row-major [nrows, c] array,
// as f32, transposed into dst[k][row]; outside the array reads as 0.
template <typename T>
__device__ __forceinline__ void stage(float (*dst)[BM + 4], const T* __restrict__ src,
                                      int r0, int nrows, int k0, int c) {
  for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
    const int r = i / BK;
    const int k = i - r * BK;
    float x = 0.0f;
    if (r0 + r < nrows && k0 + k < c) x = to_f32(src[(size_t)(r0 + r) * c + k0 + k]);
    dst[k][r] = x;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
sim_block_kernel(const T* __restrict__ rows, const T* __restrict__ h, T* __restrict__ out,
                 int b, int n, int c) {
  __shared__ __align__(16) float Rs[BK][BM + 4];   // rows tile, [k][row]
  __shared__ __align__(16) float Hs[BK][BN + 4];   // h tile, [k][col]

  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < c; k0 += BK) {
    __syncthreads();   // the last chunk's readers are done
    stage(Rs, rows, row0, b, k0, c);
    stage(Hs, h, col0, n, k0, c);
    __syncthreads();
    const int kn = min(BK, c - k0);
    for (int k = 0; k < kn; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&Rs[k][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&Rs[k][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Hs[k][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Hs[k][64 + 4 * tx]);
      const float ra[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float rb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + (i - 4));
    if (r >= b) continue;
    T* o = out + (size_t)r * n;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int v = 0; v < 4; v += VEC) {
        const int col = col0 + 64 * half + 4 * tx + v;
        if (col < n) store_vec<VEC>(o + col, &acc[i][4 * half + v]);
      }
  }
}

template <typename T>
int launch(const void* rows, const void* h, void* out, int b, int n, int c,
           cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (b + BM - 1) / BM);
  const T* r = static_cast<const T*>(rows);
  const T* hh = static_cast<const T*>(h);
  T* o = static_cast<T*>(out);
  // n % VEC == 0 keeps every row's start, and so every vector, aligned.
  if (n % 4 == 0)
    sim_block_kernel<T, 4><<<grid, THREADS, 0, stream>>>(r, hh, o, b, n, c);
  else if (n % 2 == 0)
    sim_block_kernel<T, 2><<<grid, THREADS, 0, stream>>>(r, hh, o, b, n, c);
  else
    sim_block_kernel<T, 1><<<grid, THREADS, 0, stream>>>(r, hh, o, b, n, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows [b, c], h [n, c], out [b, n]: contiguous on the device, all float32
// (dtype 0) or all bfloat16 (dtype 1), out 16-byte aligned. Launches on
// `stream` and returns the cudaError_t of the launch.
extern "C" int sim_block_fwd(const void* rows, const void* h, void* out, int dtype,
                             int b, int n, int c, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(rows, h, out, b, n, c, s);
  if (dtype == 1) return launch<__nv_bfloat16>(rows, h, out, b, n, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
