// Causal (optionally windowed) online-softmax attention with grouped kv heads,
// for bfloat16 q, k, v, on the tensor cores:
// out[b, h] = softmax(mask(Q[b, h] K[b, h / G]^T * scale)) V[b, h / G], with
// G = Hq / Hkv, queries end-aligned with the keys (query i sits at key
// position i + Skv - Sq), and fully masked rows written as 0. The contract is
// that of flash_attention.cu, which keeps the float32 inputs.
//
// Replaces the TPU kernel `flash_attention` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py (wrapper `mha` in
// src/repro/kernels/ops.py) for bfloat16 inputs. The Pallas kernel computes in
// f32 from bf16 inputs. Products of two bf16 values are exact in f32, so
// Q K^T on the tensor cores with f32 accumulation changes only the order of
// the sums; the one new rounding is P to bf16 before P V, as in FlashAttention-2.
//
// What bounds it on the H100: operations. At the serving main path's shape
// (8 x 32 heads, 2048 tokens, D = 80) the causal work is ~172 GFLOP over
// ~126 MB, ~1400 FLOP per byte: the bound is the bf16 tensor-core peak. The
// f32 SIMT kernel could not come within 5x of it even at the CUDA-core peak.
//
// What the design does about it (FlashAttention-2 on mma.sync): one block of
// 8 warps owns 128 query rows of one (batch, q head), 16 rows per warp, and
// loops over tiles of 64 keys. Q is loaded once into registers as m16n8k16
// A fragments (ldmatrix). K and V tiles stay bf16 in shared memory, rows
// padded to D + 8 elements so that every ldmatrix is free of bank conflicts,
// and are double-buffered with 16-byte cp.async: tile j + 1 loads while tile
// j is computed. S = Q K^T is D / 16 k-steps of
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 per 8 keys, with K fragments
// from ldmatrix. The online softmax runs on the S accumulator fragments in
// registers: row max and row sum reduce across each quad of lanes by
// shuffles, with exp2 and scale * log2(e) folded into one FMA per score. P is
// rounded to bf16 in registers, where two adjacent m16n8 C fragments are the
// A fragment of the next m16n8k16, so P never touches shared memory; the sum
// l is taken over the rounded P, so the output is a convex combination of
// V rows. O += P V takes V fragments from ldmatrix.trans, D / 8 n-tiles of 8
// columns. Masks are applied per element only on tiles that cross the
// diagonal, the window edge or the end of the keys; interior tiles skip them.
// Tiles no row of a block may see are skipped, as in flash_attention.cu, and
// so is the compute of a tile no row of a warp may see; the grid walks the
// query blocks longest first. The output is normalised by l, staged through
// the warp's own rows of the Q tile and written with 16-byte stores.
//
// The D = 240 tile (gemma3-12b: 3840 / 16 heads). What bounds it is the
// register file: Q's A fragments would be 60 registers a thread, the O
// accumulator 120 and S 32, ~212 before addresses, m and l, against the cap
// of 255, so the tile that holds Q in registers spills. So above D = 128 Q
// stays in its shared tile (which holds it anyway, 190,464 B of shared
// memory with the K and V stages: one block of 8 warps an SM) and each of
// the 15 k-steps of S = Q K^T reads its A fragment with one more ldmatrix.x4
// beside the four of K, as FlashAttention-2 does at D = 256. Nothing else
// changes, so the sums and roundings are those of the other head dims.
// `-Xptxas -v` reports 255 registers for both D = 240 kernels and spills of
// 28 bytes (serving) and 40 (LSE). Their cost, by tools/sass_spills.py: per
// key tile a warp issues 2 spill stores and 6 spill loads (LSE: 4 and 6)
// beside the tile's 240 mma.sync of a 2,400-instruction kernel; the rest sit
// at entry and exit. At gemma's prefill (q [8,16,2048,240], kv 8 heads) the
// serving kernel takes 1.037-1.043 ms, 4.0x its 0.261 ms bound, and
// 0.834-0.840 ms with window 1024 (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py).
//
// For training, a second kernel (flash_attention_tc_lse_kernel, chosen by a
// non-null `lse`) also keeps each row's sum of P before rounding and writes
// the row's log-sum-exp m + log l, which the backward pass
// (flash_attention_bwd_tc.cu) recomputes P from. The serving path passes null
// and runs the kernel it always ran.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;           // each owns 16 query rows
constexpr int BQ = 16 * WARPS;     // query rows per block
constexpr int BKV = 64;            // keys per shared-memory tile
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
constexpr size_t smem_bytes() {
  // Q tile, then two stages each of K and V, rows padded to D + 8.
  return sizeof(bf16) * (size_t)(BQ + 4 * BKV) * (D + 8);
}

// Two f32 as a bf16 pair (lo in the low half, the element with the lower
// index in an mma fragment); `sum` gains the two rounded values.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi, float& sum) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  const float2 r = __bfloat1622float2(v);
  sum += r.x + r.y;
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [r0, r0 + ROWS) of a row-major [nrows, D] bf16 array into a
// [ROWS][D + 8] shared tile by cp.async; rows at or past nrows are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int r0,
                                          int nrows) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < (ROWS * CHUNKS + THREADS - 1) / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    if (ROWS * CHUNKS % THREADS != 0 && i >= ROWS * CHUNKS) break;
    const int r = i / CHUNKS;
    const int ch = i - r * CHUNKS;
    const bool valid = r0 + r < nrows;
    const bf16* g = src + (size_t)(valid ? r0 + r : 0) * D + ch * 8;
    cp_async16(smem_u32(dst + r * (D + 8) + ch * 8), g, valid);
  }
}

// The body of both kernels below; LSE also writes each row's log-sum-exp.
template <int D, bool LSE>
__device__ __forceinline__ void attend(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                       const bf16* __restrict__ v, bf16* __restrict__ out,
                                       float* __restrict__ lse, int hq, int hkv, int sq, int skv,
                                       int window, float scale_log2) {
  constexpr int LD = D + 8;        // padded row stride of every tile (elements)
  constexpr int KSTEPS = D / 16;   // k-steps of S = Q K^T
  constexpr int NT = D / 8;        // n-tiles of O = P V
  constexpr int STAGE = BKV * LD;  // elements of one K or V stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                        // [2][BKV][LD]
  bf16* Vs = Ks + 2 * STAGE;                      // [2][BKV][LD]

  const int bh = blockIdx.x;                      // b * hq + h
  const int qb = gridDim.y - 1 - blockIdx.y;      // longest rows first
  const int b = bh / hq;
  const int kvh = (bh - b * hq) / (hq / hkv);
  const bf16* Q = q + (size_t)bh * sq * D;
  const bf16* K = k + ((size_t)b * hkv + kvh) * skv * D;
  const bf16* V = v + ((size_t)b * hkv + kvh) * skv * D;
  bf16* O = out + (size_t)bh * sq * D;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;          // fragment row (and row + 8)
  const int t = lane & 3;           // fragment column pair
  const int mi = lane >> 3;         // which 8 x 8 matrix this lane addresses
  const int mr = lane & 7;          // which row of it
  const int q0 = qb * BQ;
  const int off = skv - sq;         // query i sits at key position i + off

  // Keys some row of this block may see: from the window start of its first
  // row to the diagonal of its last.
  const int k_hi = min(skv, min(q0 + BQ, sq) + off) - 1;
  const int k_lo = window > 0 ? max(0, q0 + off - window + 1) : 0;
  const int kb0 = (k_lo / BKV) * BKV;
  const int n_tiles = k_hi >= kb0 ? (k_hi - kb0) / BKV + 1 : 0;

  load_tile<D, BQ>(Qs, Q, q0, sq);
  if (n_tiles > 0) {
    load_tile<D, BKV>(Ks, K, kb0, skv);
    load_tile<D, BKV>(Vs, V, kb0, skv);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Q as A fragments: matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15) of each
  // 16-column step give a0..a3. Held in registers up to D = 128; above, each
  // k-step reads its fragment from the Q tile again (QREG false).
  constexpr bool QREG = D <= 128;
  const uint32_t q_at = smem_u32(Qs + (warp * 16 + (mi & 1) * 8 + mr) * LD + (mi >> 1) * 8);
  uint32_t qf[KSTEPS][4];
  if constexpr (QREG) {
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) ldmatrix_x4(qf[ks], q_at + ks * 32);
  }

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8 (log2 units)
  float l_run[2] = {0.0f, 0.0f};            // this lane's share of the running sums
  float l_exact[2] = {0.0f, 0.0f};          // the same over P before rounding (LSE only)

  const int qpos0 = q0 + warp * 16 + off;   // key position of this warp's first row
  const int qpos[2] = {qpos0 + g, qpos0 + g + 8};

  for (int j = 0; j < n_tiles; ++j) {
    const int kb = kb0 + j * BKV;
    const int st = j & 1;
    if (j + 1 < n_tiles) {           // the stage read in iteration j - 1 is free
      load_tile<D, BKV>(Ks + (st ^ 1) * STAGE, K, kb + BKV, skv);
      load_tile<D, BKV>(Vs + (st ^ 1) * STAGE, V, kb + BKV, skv);
    }
    cp_async_commit();
    cp_async_wait<1>();              // tile j has landed
    __syncthreads();
    const bf16* Kt = Ks + st * STAGE;
    const bf16* Vt = Vs + st * STAGE;

    // A tile no row of this warp may see (past its last row's diagonal or
    // before its first row's window) costs the warp nothing.
    const bool seen = kb <= qpos0 + 15 && (window <= 0 || kb + BKV - 1 > qpos0 - window);
    if (seen) {
      // S = Q K^T: 8 n-tiles of 8 keys; one ldmatrix.x4 gives the B fragments
      // of two n-tiles for one k-step.
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        if constexpr (!QREG) ldmatrix_x4(qf[ks], q_at + ks * 32);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t kf[4];
          ldmatrix_x4(kf, smem_u32(Kt + (np * 16 + (mi >> 1) * 8 + mr) * LD + ks * 16 +
                                   (mi & 1) * 8));
          mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);
        }
      }

      // Per-element masks only where the tile crosses this warp's diagonal, the
      // window edge of its last row, or the end of the keys.
      const bool edge = kb + BKV - 1 > qpos0 || kb + BKV > skv ||
                        (window > 0 && kb <= qpos0 + 15 - window);
      if (edge) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = kb + n * 8 + 2 * t + (e & 1);
            const int qp = qpos[e >> 1];
            const bool keep = kpos <= qp && kpos < skv && (window <= 0 || kpos > qp - window);
            if (!keep) s[n][e] = -INFINITY;
          }
      }

      // Online softmax on rows g (elements 0, 1) and g + 8 (elements 2, 3).
      float alpha[2], m_use[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        const float m_new = fmaxf(m_run[r], mx * scale_log2);
        m_use[r] = m_new == -INFINITY ? 0.0f : m_new;   // row still fully masked
        alpha[r] = ex2(m_run[r] - m_use[r]);            // 0 while m_run is -inf
        m_run[r] = m_new;
      }

      // P in bf16 as the A fragments of four k-steps of 16 keys.
      uint32_t pa[4][4];
      float psum[2] = {0.0f, 0.0f};
      float pex[2] = {0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = 2 * kk + h;
          const float p0 = ex2(fmaf(s[n][0], scale_log2, -m_use[0]));
          const float p1 = ex2(fmaf(s[n][1], scale_log2, -m_use[0]));
          const float p2 = ex2(fmaf(s[n][2], scale_log2, -m_use[1]));
          const float p3 = ex2(fmaf(s[n][3], scale_log2, -m_use[1]));
          if (LSE) {
            pex[0] += p0 + p1;
            pex[1] += p2 + p3;
          }
          pa[kk][2 * h] = pack_bf16(p0, p1, psum[0]);
          pa[kk][2 * h + 1] = pack_bf16(p2, p3, psum[1]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] = l_run[r] * alpha[r] + psum[r];
        if (LSE) l_exact[r] = l_exact[r] * alpha[r] + pex[r];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }

      // O += P V: one ldmatrix.x4.trans gives the B fragments of two n-tiles
      // of 8 columns for one k-step of 16 keys.
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int dp = 0; dp < NT / 2; ++dp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, smem_u32(Vt + (kk * 16 + (mi & 1) * 8 + mr) * LD + dp * 16 +
                                         (mi >> 1) * 8));
          mma_bf16(o[2 * dp], pa[kk], vf[0], vf[1]);
          mma_bf16(o[2 * dp + 1], pa[kk], vf[2], vf[3]);
        }
    }
    __syncthreads();                 // every warp is done with stage st
  }

  // Normalise, stage the warp's 16 rows in its own rows of the Q tile (read
  // by no other warp), then store 16-byte chunks of whole rows.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(FULL, l, 1);
    l += __shfl_xor_sync(FULL, l, 2);
    inv[r] = l > 0.0f ? 1.0f / l : 0.0f;           // fully masked row -> 0
    if (LSE) {    // L = m + log l in natural units, over P before rounding; -inf if fully masked
      float le = l_exact[r];
      le += __shfl_xor_sync(FULL, le, 1);
      le += __shfl_xor_sync(FULL, le, 2);
      const int row = q0 + warp * 16 + g + 8 * r;
      if (t == 0 && row < sq)
        lse[(size_t)bh * sq + row] = le == 0.0f ? -INFINITY : (m_run[r] + log2f(le)) * LN2;
    }
  }
  bf16* Ow = Qs + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(Ow + g * LD + n * 8 + 2 * t) =
        __floats2bfloat162_rn(o[n][0] * inv[0], o[n][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(Ow + (g + 8) * LD + n * 8 + 2 * t) =
        __floats2bfloat162_rn(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
  __syncwarp();
  constexpr int CHUNKS = D / 8;
  for (int i = lane; i < 16 * CHUNKS; i += 32) {
    const int r = i / CHUNKS;
    const int ch = i - r * CHUNKS;
    const int row = q0 + warp * 16 + r;
    if (row < sq)
      *reinterpret_cast<uint4*>(O + (size_t)row * D + ch * 8) =
          *reinterpret_cast<const uint4*>(Ow + r * LD + ch * 8);
  }
}

// The serving path's kernel, with the launch bounds it always had.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out, int hq, int hkv,
                          int sq, int skv, int window, float scale_log2) {
  attend<D, false>(q, k, v, out, nullptr, hq, hkv, sq, skv, window, scale_log2);
}

// The training path's, which keeps each row's log-sum-exp. Its extra running
// sum takes the registers over 128 a thread, and one block of 8 warps per SM
// ran it 36 % slower than two blocks with the registers capped (D <= 80).
template <int D>
__global__ void __launch_bounds__(THREADS, D <= 80 ? 2 : 1)
flash_attention_tc_lse_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, bf16* __restrict__ out,
                              float* __restrict__ lse, int hq, int hkv, int sq, int skv,
                              int window, float scale_log2) {
  attend<D, true>(q, k, v, out, lse, hq, hkv, sq, skv, window, scale_log2);
}

template <typename Kernel, typename... Args>
int launch_as(Kernel kernel, size_t smem, int batch, int hq, int sq, cudaStream_t stream,
              Args... args) {
  const cudaError_t set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(batch * hq, (sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int batch, int hq,
           int hkv, int sq, int skv, int window, float scale_log2, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  bf16* O = static_cast<bf16*>(out);
  if (lse)
    return launch_as(flash_attention_tc_lse_kernel<D>, smem, batch, hq, sq, stream, Q, K, V, O,
                     lse, hq, hkv, sq, skv, window, scale_log2);
  return launch_as(flash_attention_tc_kernel<D>, smem, batch, hq, sq, stream, Q, K, V, O, hq,
                   hkv, sq, skv, window, scale_log2);
}

}  // namespace

// q, out [batch, hq, sq, d]; k, v [batch, hkv, skv, d]: contiguous bfloat16,
// 16-byte aligned, with hq a multiple of hkv and d one of 32, 64, 80, 128, 240.
// window <= 0 means no window. lse, if not null, is [batch, hq, sq] float32
// and gets each row's log-sum-exp of its scaled scores (-inf for a fully
// masked row), for the backward pass. Launches on `stream` and returns the
// cudaError_t of the launch.
extern "C" int flash_attention_tc_bf16(const void* q, const void* k, const void* v, void* out,
                                       float* lse, int batch, int hq, int hkv, int sq, int skv,
                                       int d, int window, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * LOG2E;
  switch (d) {
    case 32: return launch<32>(q, k, v, out, lse, batch, hq, hkv, sq, skv, window, sl2, s);
    case 64: return launch<64>(q, k, v, out, lse, batch, hq, hkv, sq, skv, window, sl2, s);
    case 80: return launch<80>(q, k, v, out, lse, batch, hq, hkv, sq, skv, window, sl2, s);
    case 128: return launch<128>(q, k, v, out, lse, batch, hq, hkv, sq, skv, window, sl2, s);
    case 240: return launch<240>(q, k, v, out, lse, batch, hq, hkv, sq, skv, window, sl2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
