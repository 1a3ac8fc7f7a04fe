// Batched GraphSAGE neighbor mean: out[b] = (A[b] @ H[b]) / max(rowsum(A[b]), 1).
//
// Replaces the TPU kernel `sage_aggregate` / `_sage_kernel` in
// src/repro/kernels/sage_aggregate.py (wrapper and custom VJP in
// src/repro/kernels/ops.py). The Pallas kernel walks a sequential
// (row, col, k) grid, carries the product and the row degree in VMEM scratch
// across k steps and divides on the last one. Here the k loop runs inside the
// block, and one launch covers every client: blockIdx.z indexes the batch.
//
// What bounds it on the H100: float32 operations. At the main path's layer-1
// shape (6 clients, n = 6123, d = 6805) it is 2*6*6123^2*6805 ~ 3.1 TFLOP over
// ~2.9 GB of inputs and output, ~1000 FLOP per byte, far above the card's
// ratio. The product stays in plain f32 FMA on the CUDA cores (67 TFLOP/s
// peak) rather than TF32 tensor cores, to hold float32 parity with the
// reference.
//
// What the design does about it: each 256-thread block owns a 128x128 output
// tile. A (128 x 8) and H (8 x 128) tiles are double-buffered in shared
// memory with the next tile's global loads in flight during the current
// tile's FMAs, and each thread keeps an 8x8 accumulator in registers, so
// every value read from shared memory feeds 8 FMAs. The row degree is summed
// from the same A values the thread loaded for the tile (4 adds per thread
// per k tile), reduced across the thread pair that shares a row, and the
// division happens once in the epilogue. Ragged edges (n, d not multiples of
// 128) are masked in the loads and stores, so the caller pads nothing.
// Tensor cores (wgmma), TMA and a persistent schedule are later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 128;      // output rows per block
constexpr int BN = 128;      // output columns per block
constexpr int BK = 8;        // contraction depth per shared-memory tile
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
sage_aggregate_kernel(const float* __restrict__ adj, const float* __restrict__ h,
                      float* __restrict__ out, int n, int d) {
  __shared__ __align__(16) float As[2][BK][BM];   // A tile, transposed: [k][row]
  __shared__ __align__(16) float Hs[2][BK][BN];   // H tile: [k][col]
  __shared__ float deg_s[BM];

  const size_t b = blockIdx.z;
  const float* A = adj + b * (size_t)n * n;
  const float* H = h + b * (size_t)n * d;
  float* O = out + b * (size_t)n * d;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tid = threadIdx.x;

  // Load roles: A row (tid >> 1), 4 columns at (tid & 1) * 4;
  //             H row (tid >> 5), 4 columns at (tid & 31) * 4.
  const int a_r = tid >> 1;
  const int a_c = (tid & 1) * 4;
  const int h_r = tid >> 5;
  const int h_c = (tid & 31) * 4;
  const int a_row = row0 + a_r;

  // Compute roles: rows ty*4 + {0..3} and 64 + ty*4 + {0..3}; same for cols.
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float a_reg[4];
  float h_reg[4];
  float deg_part = 0.0f;

  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kc = k0 + a_c + i;
      a_reg[i] = (a_row < n && kc < n) ? __ldg(A + (size_t)a_row * n + kc) : 0.0f;
      deg_part += a_reg[i];
    }
    const int kr = k0 + h_r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + h_c + j;
      h_reg[j] = (kr < n && c < d) ? __ldg(H + (size_t)kr * d + c) : 0.0f;
    }
  };
  auto store_tile = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[buf][a_c + i][a_r] = a_reg[i];
    *reinterpret_cast<float4*>(&Hs[buf][h_r][h_c]) =
        make_float4(h_reg[0], h_reg[1], h_reg[2], h_reg[3]);
  };

  const int k_tiles = (n + BK - 1) / BK;
  load_tile(0);
  store_tile(0);
  __syncthreads();

  for (int t = 0; t < k_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < k_tiles) load_tile((t + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Hs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Hs[buf][kk][64 + tx * 4]);
      const float ra[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float rb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    if (t + 1 < k_tiles) store_tile(buf ^ 1);
    __syncthreads();
  }

  // Row degree: the two threads that loaded row a_r hold its two halves.
  deg_part += __shfl_xor_sync(0xffffffffu, deg_part, 1);
  if ((tid & 1) == 0) deg_s[a_r] = deg_part;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int lr = (i < 4) ? ty * 4 + i : 64 + ty * 4 + (i - 4);
    const int r = row0 + lr;
    if (r >= n) continue;
    const float deg = fmaxf(deg_s[lr], 1.0f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + ((j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (c < d) O[(size_t)r * d + c] = acc[i][j] / deg;
    }
  }
}

}  // namespace

// adj [batch, n, n], h [batch, n, d], out [batch, n, d]: contiguous float32 on
// the device. Launches on `stream` and returns the cudaError_t of the launch.
extern "C" int sage_aggregate_f32(const float* adj, const float* h, float* out,
                                  int batch, int n, int d, void* stream) {
  const dim3 grid((d + BN - 1) / BN, (n + BM - 1) / BM, batch);
  sage_aggregate_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      adj, h, out, n, d);
  return static_cast<int>(cudaGetLastError());
}
