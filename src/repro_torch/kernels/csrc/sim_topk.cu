// Fused masked similarity top-k: for every row r of h[b] (one edge server b),
// the k candidates j maximising <h[b, r], h[b, j]> among those owned by another
// client (cid[b, j] != cid[b, r]) and allowed as targets (mask[b, j] > 0).
//
// Replaces the TPU kernel `sim_topk` / `_sim_topk_kernel` (with its merge
// `topk_merge`) in src/repro/kernels/sim_topk.py, wrapper in
// src/repro/kernels/ops.py. The Pallas kernel computes one gram tile on the
// MXU per grid step and folds it into a running top-k in VMEM by k argmax
// passes. Here one thread owns one query row for the whole candidate axis,
// and one launch covers all N servers: blockIdx.y indexes the server.
//
// What bounds it on the H100: float32 operations, 2*n^2*c per server plus a
// compare per candidate; its inputs are a few MB. At the main path's shape
// (N = 3 servers, n = 12246 flat slots, c = 15 classes) that is ~13.5 GFLOP,
// a fraction of a millisecond at the 67 TFLOP/s CUDA-core peak. The n x n
// gram (1.8 GB for the three servers) is what must never reach device
// memory, and it does not.
//
// What the design does about it: each block stages a tile of 128 candidates
// (features zero-padded from c to 16, client ids, target mask) in shared
// memory; every thread reads the same staged candidate at the same time
// (a broadcast), computes the c-long dot in a fixed order, applies both masks
// and inserts the score into a sorted top-k held in registers (k is a
// template constant, so the arrays never spill). Insertion uses a strict `>`
// and candidates arrive in ascending index, so ties go to the smallest index,
// exactly like `topk_merge`. Slots never filled come out as (-inf, -1).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;     // query rows per block, one per thread
constexpr int BC = 128;    // candidates staged per shared-memory tile
constexpr int CPAD = 16;   // feature width the tile is padded to (c <= 16)

template <int K>
__global__ void __launch_bounds__(BQ)
sim_topk_kernel(const float* __restrict__ h, const int* __restrict__ cid,
                const float* __restrict__ mask, float* __restrict__ vals,
                int* __restrict__ idx, int n, int c, int col_offset) {
  __shared__ float hs[BC][CPAD];
  __shared__ int cs[BC];
  __shared__ float ms[BC];

  const size_t b = blockIdx.y;
  const float* H = h + b * (size_t)n * c;
  const int* C = cid + b * (size_t)n;
  const float* Mk = mask + b * (size_t)n;
  const int r = blockIdx.x * BQ + threadIdx.x;
  const bool live = r < n;

  float q[CPAD];
#pragma unroll
  for (int t = 0; t < CPAD; ++t) q[t] = (live && t < c) ? H[(size_t)r * c + t] : 0.0f;
  const int rc = live ? C[r] : 0;

  float v[K];
  int ix[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    v[t] = -CUDART_INF_F;
    ix[t] = -1;
  }

  for (int j0 = 0; j0 < n; j0 += BC) {
    __syncthreads();   // the previous tile is no longer read
    for (int e = threadIdx.x; e < BC * CPAD; e += BQ) {
      const int jr = e / CPAD;
      const int jc = e % CPAD;
      const int j = j0 + jr;
      hs[jr][jc] = (j < n && jc < c) ? H[(size_t)j * c + jc] : 0.0f;
    }
    for (int e = threadIdx.x; e < BC; e += BQ) {
      const int j = j0 + e;
      cs[e] = (j < n) ? C[j] : 0;
      ms[e] = (j < n) ? Mk[j] : 0.0f;
    }
    __syncthreads();

    const int count = min(BC, n - j0);
    for (int jj = 0; jj < count; ++jj) {
      if (cs[jj] == rc || !(ms[jj] > 0.0f)) continue;
      float s = 0.0f;
#pragma unroll
      for (int t = 0; t < CPAD; ++t) s = fmaf(q[t], hs[jj][t], s);
      if (s > v[K - 1]) {
        v[K - 1] = s;
        ix[K - 1] = j0 + jj;
#pragma unroll
        for (int t = K - 1; t > 0; --t) {
          if (v[t] > v[t - 1]) {
            const float tv = v[t];
            v[t] = v[t - 1];
            v[t - 1] = tv;
            const int ti = ix[t];
            ix[t] = ix[t - 1];
            ix[t - 1] = ti;
          }
        }
      }
    }
  }

  if (!live) return;
  float* vo = vals + (b * (size_t)n + r) * K;
  int* io = idx + (b * (size_t)n + r) * K;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    vo[t] = v[t];
    io[t] = ix[t] >= 0 ? ix[t] + col_offset : -1;
  }
}

}  // namespace

// h [batch, n, c] float32, cid [batch, n] int32, mask [batch, n] float32;
// vals [batch, n, k] float32 and idx [batch, n, k] int32 are written. All
// contiguous on the device; 1 <= k <= 16 and c <= 16. Launches on `stream`
// and returns the cudaError_t of the launch.
extern "C" int sim_topk_f32(const float* h, const int* cid, const float* mask,
                            float* vals, int* idx, int batch, int n, int c, int k,
                            int col_offset, void* stream) {
  if (c < 1 || c > CPAD) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + BQ - 1) / BQ, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SIM_TOPK_CASE(KK)                                                      \
  case KK:                                                                     \
    sim_topk_kernel<KK><<<grid, BQ, 0, s>>>(h, cid, mask, vals, idx, n, c,     \
                                            col_offset);                       \
    break;
  switch (k) {
    SIM_TOPK_CASE(1) SIM_TOPK_CASE(2) SIM_TOPK_CASE(3) SIM_TOPK_CASE(4)
    SIM_TOPK_CASE(5) SIM_TOPK_CASE(6) SIM_TOPK_CASE(7) SIM_TOPK_CASE(8)
    SIM_TOPK_CASE(9) SIM_TOPK_CASE(10) SIM_TOPK_CASE(11) SIM_TOPK_CASE(12)
    SIM_TOPK_CASE(13) SIM_TOPK_CASE(14) SIM_TOPK_CASE(15) SIM_TOPK_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SIM_TOPK_CASE
  return static_cast<int>(cudaGetLastError());
}
