// The backward pass of causal (optionally windowed) attention with grouped kv
// heads, for float32 inputs, on the CUDA cores: from q, k, v, the forward's
// output O and row log-sum-exp L, and the output's gradient dO, the gradients
// dQ, dK and dV. The bfloat16 inputs have a kernel of their own on the tensor
// cores, flash_attention_bwd_tc.cu, with the same contract: q, O, dO
// [B, Hq, Sq, D] and k, v [B, Hkv, Skv, D] with Hq a multiple of Hkv, q head
// h reading kv head h / (Hq / Hkv); query i sits at key position
// i + Skv - Sq and sees the keys at positions <= its own, and with a window
// only those > its own minus the window. With S = Q K^T * scale over the keys
// a row sees:
//   P = exp(S - L), dP = dO V^T, D = rowsum(dO * O), dS = P * (dP - D),
//   dQ = dS K * scale, dK = dS^T Q * scale, dV = P^T dO,
// where dK and dV sum over the q heads of each kv head's group. A pair (row,
// key) the row may not see contributes nothing: a fully masked row gets
// dQ = 0 and adds nothing to dK or dV. The plain version is
// ref.flash_attention_bwd.
//
// Replaces: no TPU kernel. The JAX package's Pallas `flash_attention`
// (src/repro/kernels/flash_attention.py, `_flash_kernel`) has no VJP; the
// reference trains through its plain jnp attention. This kernel is the port's
// own, so that training on the card runs through a kernel on both passes.
//
// What bounds it on the H100: operations. At the training shape (2 x 32 q
// heads, 2048 tokens, D = 80) the five products the gradient needs (S, dP,
// dQ, dK, dV) over the causal pairs are 107.4 GFLOP, against ~210 MB of
// f32 inputs and outputs: 1.60 ms on the CUDA cores' 67 TFLOP/s float32
// peak, where this kernel runs (0.217 ms at the 495 TFLOP/s TF32 peak, which
// three passes for f32 accuracy would make 0.65 ms).
//
// What the design does about it (a simple first kernel, on the CUDA cores;
// the f32 route is off the training main path, which runs bf16):
// - Three launches on one stream. A pass for D, one warp per row. Then a
//   dK/dV kernel: one block per (batch, kv head, tile of 64 keys), which
//   loops over the q heads of the group and over only the 64-row query tiles
//   that the causal mask and the window let see its keys, accumulating dK and
//   dV in registers; the GQA sum happens inside the block, so there are no
//   atomics. Then a dQ kernel: one block per (batch, q head, tile of 64
//   rows), over only the key tiles its rows see. S and dP are computed in
//   both (seven products instead of five), the price of needing no atomics:
//   every output element is written by one thread, in a fixed order, so two
//   runs give the same bits.
// - 256 threads, 16 x 16: for S and dP each thread owns 4 rows (4 ty + r)
//   and every 16th key (tx + 16 c); for dK, dV and dQ, 4 keys or rows and
//   every 16th column. Tiles live in shared memory as float32 rows of odd
//   stride D + 1, so a warp's 16 columns or keys fall in 16 banks and its 2
//   row groups are broadcasts; P and dS pass between the two mappings
//   through one [64][65] tile.
// - Blocks are launched longest first (the first key tiles, the last query
//   tiles). Shared memory is 99 KB at D = 80; registers are capped at 128 a
//   thread for D <= 80 so that two blocks fit on an SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // query rows per tile
constexpr int BK = 64;           // keys per tile
constexpr int THREADS = 256;     // 16 x 16
constexpr int LDP = BK + 1;      // row stride of the P / dS tile
constexpr float LOG2E = 1.4426950408889634f;

// Four [64][D + 1] tiles, the P / dS tile, and a row's L (in log2 units) and D.
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(4 * 64 * (D + 1) + BQ * LDP + 2 * BQ);
}

// Rows [r0, r0 + 64) of a row-major [nrows, D] array as a [64][D + 1] float32
// tile; rows at or past nrows are 0.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int r0,
                                          int nrows) {
#pragma unroll
  for (int it = 0; it < 64 * D / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / D, c = i - r * D;
    dst[r * (D + 1) + c] = r0 + r < nrows ? src[(size_t)(r0 + r) * D + c] : 0.0f;
  }
}

// Rows [q0, q0 + 64) of L (as log2 units) and of D; 0 past sq.
__device__ __forceinline__ void load_rows(float* Ls, float* Ds, const float* __restrict__ lse,
                                          const float* __restrict__ delta, size_t base, int q0,
                                          int sq) {
  if (threadIdx.x < BQ) {
    const int i = q0 + threadIdx.x;
    Ls[threadIdx.x] = i < sq ? lse[base + i] * LOG2E : 0.0f;
    Ds[threadIdx.x] = i < sq ? delta[base + i] : 0.0f;
  }
}

// S = Q K^T and dP = dO V^T (unscaled) for this thread's rows 4 ty + r and
// keys tx + 16 c of the tiles, then, in place, P and dS: where row q0 + 4 ty
// + r may see key k0 + tx + 16 c, p = exp(S scale - L) and ds = p (dP - D);
// elsewhere both are 0.
template <int D>
__device__ __forceinline__ void probs(const float* Qs, const float* dOs, const float* Ks,
                                      const float* Vs, const float* Ls, const float* Ds, int q0,
                                      int k0, int sq, int skv, int window, float scale_log2,
                                      float (&p)[4][4], float (&ds)[4][4]) {
  constexpr int LD = D + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) p[r][c] = ds[r][c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      qv[r] = Qs[(4 * ty + r) * LD + d];
      ov[r] = dOs[(4 * ty + r) * LD + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kv[c] = Ks[(tx + 16 * c) * LD + d];
      vv[c] = Vs[(tx + 16 * c) * LD + d];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[r][c] = fmaf(qv[r], kv[c], p[r][c]);
        ds[r][c] = fmaf(ov[r], vv[c], ds[r][c]);
      }
  }
  const int off = skv - sq;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + 4 * ty + r;
    const int qpos = i + off;
    const float l = Ls[4 * ty + r], dd = Ds[4 * ty + r];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kpos = k0 + tx + 16 * c;
      const bool seen =
          i < sq && kpos < skv && kpos <= qpos && (window <= 0 || kpos > qpos - window);
      const float pv = seen ? exp2f(fmaf(p[r][c], scale_log2, -l)) : 0.0f;
      ds[r][c] = seen ? pv * (ds[r][c] - dd) : 0.0f;
      p[r][c] = pv;
    }
  }
}

// A [4][4] register tile of rows 4 ty + r and keys tx + 16 c into the P / dS tile.
__device__ __forceinline__ void store_pt(float* Ps, const float (&x)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) Ps[(4 * ty + r) * LDP + tx + 16 * c] = x[r][c];
}

// acc[r][j] += sum over the 64 rows i of Ps[i][4 ty + r] * X[i][tx + 16 j]:
// dV += P^T dO and dK += dS^T Q for this thread's keys 4 ty + r.
template <int D>
__device__ __forceinline__ void acc_keys(float (&acc)[4][D / 16], const float* Ps,
                                         const float* X) {
  constexpr int LD = D + 1, NJ = D / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int i = 0; i < BQ; ++i) {
    float pv[4], xv[NJ];
#pragma unroll
    for (int r = 0; r < 4; ++r) pv[r] = Ps[i * LDP + 4 * ty + r];
#pragma unroll
    for (int j = 0; j < NJ; ++j) xv[j] = X[i * LD + tx + 16 * j];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[r][j] = fmaf(pv[r], xv[j], acc[r][j]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                                 float* __restrict__ delta, long long rows) {
  const long long row = (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.0f;
  for (int c = lane; c < D; c += 32)
    acc = fmaf(dout[row * D + c], o[row * D + c], acc);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) delta[row] = acc;
}

template <int D>
__global__ void __launch_bounds__(THREADS, D <= 80 ? 2 : 1)
flash_attention_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                float* __restrict__ dk, float* __restrict__ dv, int hq, int hkv,
                                int sq, int skv, int window, float scale_log2, float scale) {
  constexpr int LD = D + 1, NJ = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;               // [BK][LD]
  float* Vs = Ks + BK * LD;       // [BK][LD]
  float* Qs = Vs + BK * LD;       // [BQ][LD]
  float* dOs = Qs + BQ * LD;      // [BQ][LD]
  float* Ps = dOs + BQ * LD;      // [BQ][LDP]: P, then dS
  float* Ls = Ps + BQ * LDP;      // [BQ]
  float* Ds = Ls + BQ;            // [BQ]

  const int b = blockIdx.x / hkv, kvh = blockIdx.x - b * hkv;
  const int k0 = blockIdx.y * BK;   // the first key tiles are seen by the most rows
  const int group = hq / hkv, off = skv - sq;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t kv_base = ((size_t)b * hkv + kvh) * skv;
  load_tile<D>(Ks, k + kv_base * D, k0, skv);
  load_tile<D>(Vs, v + kv_base * D, k0, skv);

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[r][j] = dv_acc[r][j] = 0.0f;

  // Rows that see some key of the tile: from its first key's diagonal to
  // the window's end of its last key.
  const int k_last = min(k0 + BK, skv) - 1;
  const int i_lo = max(0, k0 - off);
  const int i_hi = window > 0 ? (int)min((long long)sq - 1, (long long)k_last + window - 1 - off)
                              : sq - 1;
  for (int hg = 0; hg < group; ++hg) {
    const size_t row_base = ((size_t)b * hq + kvh * group + hg) * sq;
    for (int q0 = (i_lo / BQ) * BQ; q0 <= i_hi; q0 += BQ) {
      __syncthreads();                        // the last tile's Qs, dOs and Ps are free
      load_tile<D>(Qs, q + row_base * D, q0, sq);
      load_tile<D>(dOs, dout + row_base * D, q0, sq);
      load_rows(Ls, Ds, lse, delta, row_base, q0, sq);
      __syncthreads();
      float p[4][4], ds[4][4];
      probs<D>(Qs, dOs, Ks, Vs, Ls, Ds, q0, k0, sq, skv, window, scale_log2, p, ds);
      store_pt(Ps, p);
      __syncthreads();
      acc_keys<D>(dv_acc, Ps, dOs);           // dV += P^T dO
      __syncthreads();
      store_pt(Ps, ds);
      __syncthreads();
      acc_keys<D>(dk_acc, Ps, Qs);            // dK += dS^T Q
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + 4 * ty + r;
    if (key >= skv) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const size_t at = (kv_base + key) * D + tx + 16 * j;
      dk[at] = dk_acc[r][j] * scale;
      dv[at] = dv_acc[r][j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, D <= 80 ? 2 : 1)
flash_attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ dq, int hq, int hkv, int sq, int skv,
                              int window, float scale_log2, float scale) {
  constexpr int LD = D + 1, NJ = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // [BQ][LD]
  float* dOs = Qs + BQ * LD;      // [BQ][LD]
  float* Ks = dOs + BQ * LD;      // [BK][LD]
  float* Vs = Ks + BK * LD;       // [BK][LD]
  float* Ps = Vs + BK * LD;       // [BQ][LDP]: dS
  float* Ls = Ps + BQ * LDP;      // [BQ]
  float* Ds = Ls + BQ;            // [BQ]

  const int bh = blockIdx.x;                          // b * hq + h
  const int b = bh / hq;
  const int kvh = (bh - b * hq) / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest rows first
  const int off = skv - sq;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t row_base = (size_t)bh * sq;
  const size_t kv_base = ((size_t)b * hkv + kvh) * skv;
  load_tile<D>(Qs, q + row_base * D, q0, sq);
  load_tile<D>(dOs, dout + row_base * D, q0, sq);
  load_rows(Ls, Ds, lse, delta, row_base, q0, sq);

  float dq_acc[4][NJ];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq_acc[r][j] = 0.0f;

  // Keys some row of the tile may see: from the window start of its first
  // row to the diagonal of its last.
  const int k_hi = min(skv, min(q0 + BQ, sq) + off) - 1;
  const int k_lo = window > 0 ? max(0, q0 + off - window + 1) : 0;
  for (int k0 = (k_lo / BK) * BK; k0 <= k_hi; k0 += BK) {
    __syncthreads();                          // the last tile's Ks, Vs and Ps are free
    load_tile<D>(Ks, k + kv_base * D, k0, skv);
    load_tile<D>(Vs, v + kv_base * D, k0, skv);
    __syncthreads();
    float p[4][4], ds[4][4];
    probs<D>(Qs, dOs, Ks, Vs, Ls, Ds, q0, k0, sq, skv, window, scale_log2, p, ds);
    store_pt(Ps, ds);
    __syncthreads();
    // dQ += dS K for this thread's rows 4 ty + r and columns tx + 16 j.
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float sv[4], kv[NJ];
#pragma unroll
      for (int r = 0; r < 4; ++r) sv[r] = Ps[(4 * ty + r) * LDP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = Ks[kk * LD + tx + 16 * j];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dq_acc[r][j] = fmaf(sv[r], kv[j], dq_acc[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * ty + r;
    if (row >= sq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dq[(row_base + row) * D + tx + 16 * j] = dq_acc[r][j] * scale;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int batch, int hq,
           int hkv, int sq, int skv, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* Q = static_cast<const float*>(q);
  const float* K = static_cast<const float*>(k);
  const float* V = static_cast<const float*>(v);
  const float* dO = static_cast<const float*>(dout);
  const long long rows = (long long)batch * hq * sq;
  const int rows_per_block = THREADS / 32;
  flash_attention_bwd_delta_kernel<D>
      <<<(unsigned)((rows + rows_per_block - 1) / rows_per_block), THREADS, 0, stream>>>(
          static_cast<const float*>(o), dO, delta, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const float sl2 = scale * LOG2E;
  flash_attention_bwd_dkdv_kernel<D>
      <<<dim3(batch * hkv, (skv + BK - 1) / BK), THREADS, smem, stream>>>(
          Q, K, V, dO, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), hq, hkv, sq,
          skv, window, sl2, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_attention_bwd_dq_kernel<D>
      <<<dim3(batch * hq, (sq + BQ - 1) / BQ), THREADS, smem, stream>>>(
          Q, K, V, dO, lse, delta, static_cast<float*>(dq), hq, hkv, sq, skv, window, sl2, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int d, const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv,
             int batch, int hq, int hkv, int sq, int skv, int window, float scale,
             cudaStream_t s) {
  switch (d) {
    case 32: return launch<32>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch, hq, hkv, sq,
                               skv, window, scale, s);
    case 64: return launch<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch, hq, hkv, sq,
                               skv, window, scale, s);
    case 80: return launch<80>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch, hq, hkv, sq,
                               skv, window, scale, s);
    case 128: return launch<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch, hq, hkv,
                                 sq, skv, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o, dout, dq [batch, hq, sq, d]; k, v, dk, dv [batch, hkv, skv, d]: contiguous
// float32; lse and delta [batch, hq, sq] float32 (lse as the forward wrote
// it; delta is scratch). hq a multiple of hkv, d one of 32, 64, 80, 128,
// window <= 0 for none. Launches three kernels on `stream` and returns the
// cudaError_t of the launches.
extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                                       const void* dout, const void* lse, void* delta, void* dq,
                                       void* dk, void* dv, int batch, int hq, int hkv, int sq,
                                       int skv, int d, int window, float scale, void* stream) {
  return dispatch(d, q, k, v, o, dout, static_cast<const float*>(lse),
                  static_cast<float*>(delta), dq, dk, dv, batch, hq, hkv, sq, skv, window, scale,
                  static_cast<cudaStream_t>(stream));
}
