// Causal (optionally windowed) online-softmax attention with grouped kv heads,
// for float32 q, k, v:
// out[b, h] = softmax(mask(Q[b, h] K[b, h / G]^T * scale)) V[b, h / G], with
// G = Hq / Hkv, queries end-aligned with the keys (query i sits at key
// position i + Skv - Sq), and fully masked rows written as 0. bfloat16 inputs
// take the tensor-core kernel of flash_attention_tc.cu, with the same contract.
//
// Replaces the TPU kernel `flash_attention` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py (wrapper `mha` in
// src/repro/kernels/ops.py) for float32 inputs. The Pallas kernel walks a
// (head, q block, kv block) grid whose kv axis runs in order on one core and
// carries the running max m, running sum l and the output accumulator in
// VMEM scratch from step to step; `mha` repeats the kv heads and pads both
// sequence axes to 128. Here one block owns one (batch * q head, 64-row query
// block) pair and the kv axis is a loop inside it, with m, l and the [64, D]
// accumulator in registers. The block maps its q head to its kv head itself
// (no repeated kv), masks ragged Sq and Skv itself (no padded copies), and its
// loop runs only over the kv tiles that hold a key some row of the block may
// see: from the window start of its first row to the diagonal of its last.
// Skipping fully masked tiles changes no result.
//
// What bounds it on the H100: operations. The causal work at the serving main
// path's shape (8 x 32 heads, 2048 tokens, D = 80) is 4 * 8 * 32 * 80 *
// 2048 * 2049 / 2 ~ 172 GFLOP over ~252 MB of f32 q, k, v and output: ~700
// FLOP per byte. The math stays f32 on the CUDA cores (67 TFLOP/s): tensor
// cores would mean TF32, which breaks the f32 parity (1e-5) that the f32
// serving runs are held to.
//
// What the design does about it: 128 threads (16 row groups x 8 column
// lanes). Q and each K / V tile are staged in shared memory as f32 with rows
// padded to D + 4 floats, so the float4 reads of 8 different K rows by one
// quarter-warp hit 32 different banks. For S = Q K^T each thread computes a
// 4 x 8 tile (rows 4 * ty + i, columns tx + 8 * j) from float4 reads along D:
// 12 shared loads feed 128 FMAs. Row max and row sum are reduced across the 8
// lanes of a row group with shuffles. P goes through shared memory, and for
// P V each thread accumulates its 4 rows x D / 8 columns (float2 pairs at
// 2 * tx + 16 * w), reading 4 P values and one float2 of V per 8 FMAs. The
// grid's x axis is the head and its y axis the query block, walked from the
// last block (the longest causal row) to the first, so the blocks dispatched
// first are the longest ones.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // key rows per shared-memory tile
constexpr int THREADS = 128;  // 16 row groups x 8 column lanes
constexpr int LDP = BKV + 4;  // padded row stride of the P tile (floats)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 4) + 2 * BKV * (D + 4) + BQ * LDP);
}

// Rows [r0, r0 + 64) of a row-major [nrows, D] array, as f32, into a
// [64][D + 4] shared tile; rows at or past nrows read as 0.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int r0, int nrows) {
  constexpr int LD = D + 4;
  constexpr int VPR = D / 4;  // 4-element vectors per row
  for (int i = threadIdx.x; i < BKV * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = (i - r * VPR) * 4;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + r < nrows) val = load4(src + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out, int hq,
                       int hkv, int sq, int skv, int window, float scale) {
  constexpr int LD = D + 4;   // padded row stride of Q, K, V tiles (floats)
  constexpr int CW = D / 16;  // float2 column pairs of the output per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // [BQ][LD]
  float* Ks = Qs + BQ * LD;       // [BKV][LD]
  float* Vs = Ks + BKV * LD;      // [BKV][LD]
  float* Ps = Vs + BKV * LD;      // [BQ][LDP]

  const int bh = blockIdx.x;                      // b * hq + h
  const int qb = gridDim.y - 1 - blockIdx.y;      // longest rows first
  const int b = bh / hq;
  const int kvh = (bh - b * hq) / (hq / hkv);
  const float* Q = q + (size_t)bh * sq * D;
  const float* K = k + ((size_t)b * hkv + kvh) * skv * D;
  const float* V = v + ((size_t)b * hkv + kvh) * skv * D;
  float* O = out + (size_t)bh * sq * D;

  const int tx = threadIdx.x & 7;   // column lane
  const int ty = threadIdx.x >> 3;  // row group: rows 4 * ty + i
  const int q0 = qb * BQ;
  const int off = skv - sq;         // query i sits at key position i + off

  load_tile<D>(Qs, Q, q0, sq);

  // Keys some row of this block may see: from the window start of its first
  // row to the diagonal of its last.
  const int k_hi = min(skv, min(q0 + BQ, sq) + off) - 1;
  const int k_lo = window > 0 ? max(0, q0 + off - window + 1) : 0;

  float m[4], l[4], acc[4][2 * CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 2 * CW; ++c) acc[i][c] = 0.0f;
  }

  for (int kb = (k_lo / BKV) * BKV; kb <= k_hi; kb += BKV) {
    __syncthreads();  // the last tile's readers are done
    load_tile<D>(Ks, K, kb, skv);
    load_tile<D>(Vs, V, kb, skv);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(Qs + (4 * ty + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 8 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          s[i][j] = fmaf(qv[i].w, kv[j].w, a);
        }
    }

    // Mask, then fold the tile into the running max, sum and accumulator.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i + off;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = kb + tx + 8 * j;
        const bool keep = kpos <= qpos && kpos < skv && (window <= 0 || kpos > qpos - window);
        s[i][j] = keep ? s[i][j] * scale : -INFINITY;
        rmax = fmaxf(rmax, s[i][j]);
      }
      rmax = fmaxf(rmax, __shfl_xor_sync(FULL, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(FULL, rmax, 2));
      rmax = fmaxf(rmax, __shfl_xor_sync(FULL, rmax, 4));
      const float m_new = fmaxf(m[i], rmax);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;  // row still fully masked
      const float alpha = expf(m[i] - m_use);                  // 0 while m[i] is -inf
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_use);                 // 0 where masked
        rsum += p;
        Ps[(4 * ty + i) * LDP + tx + 8 * j] = p;
      }
      rsum += __shfl_xor_sync(FULL, rsum, 1);
      rsum += __shfl_xor_sync(FULL, rsum, 2);
      rsum += __shfl_xor_sync(FULL, rsum, 4);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 2 * CW; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BKV; c += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(Ps + (4 * ty + i) * LDP + c);
        p[i][0] = pv.x;
        p[i][1] = pv.y;
        p[i][2] = pv.z;
        p[i][3] = pv.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int w = 0; w < CW; ++w) {
          const float2 vv = *reinterpret_cast<const float2*>(Vs + (c + cc) * LD + 2 * tx + 16 * w);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][2 * w] = fmaf(p[i][cc], vv.x, acc[i][2 * w]);
            acc[i][2 * w + 1] = fmaf(p[i][cc], vv.y, acc[i][2 * w + 1]);
          }
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= sq) continue;
    const float inv = l[i] > 0.0f ? 1.0f / l[i] : 0.0f;  // fully masked row -> 0
#pragma unroll
    for (int w = 0; w < CW; ++w)
      store2(O + (size_t)r * D + 2 * tx + 16 * w, acc[i][2 * w] * inv, acc[i][2 * w + 1] * inv);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* out, int batch, int hq,
           int hkv, int sq, int skv, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  const cudaError_t set = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(batch * hq, (sq + BQ - 1) / BQ);
  flash_attention_kernel<D><<<grid, THREADS, smem, stream>>>(q, k, v, out, hq, hkv, sq, skv,
                                                             window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out [batch, hq, sq, d]; k, v [batch, hkv, skv, d]: contiguous float32,
// 16-byte aligned, with hq a multiple of hkv and d one of 32, 64, 80, 128.
// window <= 0 means no window. Launches on `stream` and returns the
// cudaError_t of the launch. bfloat16 inputs take flash_attention_tc.cu.
extern "C" int flash_attention_f32(const float* q, const float* k, const float* v, float* out,
                                   int batch, int hq, int hkv, int sq, int skv, int d,
                                   int window, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(q, k, v, out, batch, hq, hkv, sq, skv, window, scale, s);
    case 64: return launch<64>(q, k, v, out, batch, hq, hkv, sq, skv, window, scale, s);
    case 80: return launch<80>(q, k, v, out, batch, hq, hkv, sq, skv, window, scale, s);
    case 128: return launch<128>(q, k, v, out, batch, hq, hkv, sq, skv, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
