// Causal (optionally windowed) online-softmax attention with grouped kv heads,
// for float32 q, k, v, on the tensor cores, accurate to float32:
// out[b, h] = softmax(mask(Q[b, h] K[b, h / G]^T * scale)) V[b, h / G], with
// G = Hq / Hkv, queries end-aligned with the keys (query i sits at key
// position i + Skv - Sq), and fully masked rows written as 0. bfloat16 inputs
// take the kernel of flash_attention_tc.cu, with the same contract.
//
// Replaces the TPU kernel `flash_attention` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py (wrapper `mha` in
// src/repro/kernels/ops.py) for float32 inputs. The Pallas kernel walks a
// (head, q block, kv block) grid whose kv axis runs in order on one core and
// carries the running max m, running sum l and the output accumulator in
// VMEM scratch from step to step; `mha` repeats the kv heads and pads both
// sequence axes to 128. Here one block owns one (batch * q head, query block)
// pair and the kv axis is a loop inside it, with m, l and the output
// accumulator in registers. The block maps its q head to its kv head itself
// (no repeated kv), masks ragged Sq and Skv itself (no padded copies), and its
// loop runs only over the kv tiles that hold a key some row of the block may
// see: from the window start of its first row to the diagonal of its last.
// Skipping fully masked tiles changes no result.
//
// Accuracy: the 3-pass TF32 split of tf32.cuh (its note says why).
// One TF32 product keeps 11 significant bits of each operand: ~1e-3 of the
// output at the serving shape, 100 times the 1e-5 the f32 route is held to.
// Each operand is written as x = hi + lo, both TF32, which holds x to
// ~2^-22, and each product as x_lo y_hi + x_hi y_lo + x_hi y_hi, the two
// small products first: S = Q K^T from split Q and K, O += P V from split P
// and V. The tensor cores' f32 accumulation is not round-to-nearest, and
// its error grows with what one accumulator takes: the three passes of S
// over all of D, and P V over all the keys, drift towards the 1e-5 limit at
// the serving shape (FLASH_F32_ABLATE=4 below). So the small passes of S go
// into an accumulator of their own, added to the large one after the last
// k-step, and each kv tile's P V into a fresh one, added to O in f32 after
// the online rescale. The scale and the mask are applied to S after
// the product, never to a split operand. The exponential is ex2.approx of
// s * (scale * log2 e) - m, one FMA per score, ~2^-22 relative: inside the
// 1e-5 limit. The row sum l is taken over the unsplit f32 P. Q, K and V keep
// tf32.cuh's rule for non-finite values (all of a non-finite x goes into
// lo), so a NaN or ±Inf that a row sees reaches its product. P is split
// without the finiteness test: it lies in [0, 1] or is NaN (a NaN or +Inf
// score), and the split turns the canonical NaN into -0; the NaN reaches the
// output through l instead, since a row's output is its accumulator times
// 1 / l, and l is 0 only for a fully masked row, which is written as 0.
//
// What bounds it on the H100: operations. At the serving shape (8 x 32 heads,
// 2048 tokens, D = 80) the causal work is 4 * 8 * 32 * 80 * 2048 * 2049 / 2
// = 171.9 GFLOP over ~252 MB of f32 q, k, v and output. Three TF32 passes are
// 515.6 GFLOP: 1.042 ms at the 495 TFLOP/s dense TF32 peak, ~1.6 ms at the
// 317-320 TFLOP/s that mma.sync alone reaches on the H100
// (tools/mma_tf32_ceiling.py); one f32 pass on the CUDA cores needs 2.565 ms
// at their 67 TFLOP/s peak. The exponentials add ~0.15 ms on the SFUs.
//
// What the design does about it (FlashAttention-2 on
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32):
// - A block of 8 warps owns 128 query rows, 16 per warp, and loops over
//   tiles of 64 keys (D = 128: 4 warps and 32-key tiles, for shared memory).
// - Each value is split once per block, not by every warp that reads it.
//   Q is split once into a plane that holds each warp's A fragments in lane
//   order, hi and lo apart, so one 16-byte load gives a lane the four
//   registers of an A operand. Each K and V tile arrives raw by 16-byte
//   cp.async (tile j + 1 while tile j is computed), then one pass of the
//   whole block writes it as planes: K key-major, V d-major (transposed in
//   that pass), each pair of elements as (hi, hi, lo, lo). Lane (g, t) of a
//   k-step of 8 reads elements 2t and 2t + 1 of row g, mma indices t and
//   t + 4 (the order of k inside a sum is free), in one 16-byte load that
//   lands as the register pairs a B operand takes: loaded any other way,
//   most fragment values cost a register move before their mma. Rows of
//   2 * len + 16 floats keep the loads free of bank conflicts.
// - P stays in registers. The S accumulator gives lane (g, t) keys 2t and
//   2t + 1 of each 8; read as mma indices t and t + 4 they are the A
//   fragment of P V's k-step over the same keys, which is why V's fragments
//   are read in that key order too. No shuffle and no trip through shared
//   memory.
// - The online softmax runs on the accumulator fragments, row max and sum
//   reduced across each quad by shuffles. Per-element masks only on tiles
//   that cross a warp's diagonal, its window edge or the end of the keys;
//   a tile no row of a warp may see costs the warp nothing. The grid walks
//   the query blocks longest first.
// What holds it: shared memory (Q plane 80 KB, K and V planes 44 and 45
// KB, raw K and V 42 KB at D = 80) allows one block of 8 warps per SM, and
// the registers (246 a thread at D = 80) no more warps; two warps per
// scheduler do not hide the dependent phases of a tile (split pass between
// two barriers, S, softmax, P V). A second plane stage would overlap the
// split with the products, but only fits with 32-key tiles, which cost more
// than they saved, as did 2 blocks of 4 warps per SM with 32-key tiles; 4
// warps of two m16 tiles each spilled.
//
// The D = 240 tile (gemma3-12b: 3840 / 16 heads). What bounds it is shared
// memory, then registers. With D = 128's 4 warps and 32-key tiles the Q
// plane (120 KB), the K and V planes and the two raw tiles come to 325,632
// B against the 232,448 a block may have; the Q plane alone is half of it
// and every warp reads it at every k-step, so it stays, and the key tile
// shrinks to 16 (Tile<240, 4, 16>: 231,936 B, one block of 4 warps an SM,
// as at D = 128). O is 120 registers a thread, and a fresh accumulator of
// all 240 columns beside it would be 120 more, so P V goes into fresh
// accumulators of 48 columns (DCH) at a time, each over the tile's two
// k-steps, added to O; the source forms P's fragments from S in each chunk
// (the same bits), which ptxas may keep instead. Each output element gets
// the same products in the same order as with one accumulator, so the
// accuracy scheme above is unchanged; tests/test_torch_flash_split.py
// emulates the 16-key tiles at D = 240. `-Xptxas -v` reports 255 registers
// and a 156-byte spill. Its cost, by tools/sass_spills.py: per key tile a
// warp issues 18 spill loads and no spill store beside the tile's 360
// mma.sync; the stores sit outside the loops. At q [2,16,2048,240] (kv 8
// heads) the kernel takes 2.74-2.76 ms, 7.0-7.1x the 0.391 ms of its three
// TF32 passes at the TF32 peak: four warps an SM, with 16-key tiles two
// barriers and a split pass every 16 keys (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py).
//
// FLASH_F32_ABLATE (0 in every normal build) changes one mechanism, for
// tools/mma_tf32_ceiling.py --ablate only: 1, each warp splits the fragments
// it reads (the planes hold x where hi would be); 2, no split pass (the
// planes keep what they held: timing only); 3, one TF32 pass (hi x hi) in
// both products; 4, one accumulator for all three passes of S and for P V
// over all the tiles.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "tf32.cuh"

#ifndef FLASH_F32_ABLATE
#define FLASH_F32_ABLATE 0
#endif

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// A block of WARPS warps, each owning 16 query rows, over tiles of BKV keys
// of head dim D. Above D = 128, O += P V goes into fresh accumulators of DCH
// columns at a time (the registers of one for all D columns beside O's).
template <int D_, int WARPS_, int BKV_>
struct Tile {
  static constexpr int D = D_, WARPS = WARPS_, BKV = BKV_;
  static constexpr int DCH = D <= 128 ? D : 48;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * WARPS;       // query rows per block
  static constexpr int LDK = 2 * D + 16;      // K plane rows: hi and lo of each element
  static constexpr int LDV = 2 * BKV + 16;    // V plane rows, one per column of V
  static constexpr int LDR = D + 4;           // raw K and V tile rows
  static constexpr int Q_FLOATS = 2 * BQ * D;  // Q plane: the warps' A fragments
  static constexpr int K_FLOATS = BKV * LDK, V_FLOATS = D * LDV;
  static constexpr int R_FLOATS = BKV * LDR;
  static constexpr size_t SMEM =
      sizeof(float) * (size_t)(Q_FLOATS + K_FLOATS + V_FLOATS + 2 * R_FLOATS);
  static_assert(BQ * D / 4 % THREADS == 0 && D % DCH == 0, "whole Q rounds, whole chunks");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

using T32 = Tile<32, 8, 64>;
using T64 = Tile<64, 8, 64>;
using T80 = Tile<80, 8, 64>;
using T128 = Tile<128, 4, 32>;   // 8 warps of 128-wide planes would not fit
using T240 = Tile<240, 4, 16>;   // 231,936 B of shared memory: the note above

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where !valid (nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x as the hi and lo that a plane holds.
__device__ __forceinline__ void split_x(float x, float& hi, float& lo) {
#if FLASH_F32_ABLATE == 1
  hi = x;
  lo = 0.0f;
#else
  uint32_t h, l;
  split(x, h, l);
  hi = __uint_as_float(h);
  lo = __uint_as_float(l);
#endif
}

// A pair of elements (x, y) as (hi(x), hi(y), lo(x), lo(y)).
__device__ __forceinline__ float4 split_pair(float x, float y) {
  float4 r;
  split_x(x, r.x, r.z);
  split_x(y, r.y, r.w);
  return r;
}

// One plane load: the (hi, lo) of mma indices t and t + 4 of a B fragment,
// (hi(2t), hi(2t + 1), lo(2t), lo(2t + 1)), with each pair in consecutive
// registers as mma takes them.
__device__ __forceinline__ void frag_b(const float* p, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
#if FLASH_F32_ABLATE == 1
  split(r.x, hi[0], lo[0]);
  split(r.y, hi[1], lo[1]);
#else
  hi[0] = __float_as_uint(r.x);
  hi[1] = __float_as_uint(r.y);
  lo[0] = __float_as_uint(r.z);
  lo[1] = __float_as_uint(r.w);
#endif
}

// Two plane loads: the hi and lo of a whole A fragment.
__device__ __forceinline__ void frag_a(const float* p, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float4 h = *reinterpret_cast<const float4*>(p);
  const float4 l = *reinterpret_cast<const float4*>(p + 128);
#if FLASH_F32_ABLATE == 1
  split(h.x, hi[0], lo[0]);
  split(h.y, hi[1], lo[1]);
  split(h.z, hi[2], lo[2]);
  split(h.w, hi[3], lo[3]);
#else
  hi[0] = __float_as_uint(h.x);
  hi[1] = __float_as_uint(h.y);
  hi[2] = __float_as_uint(h.z);
  hi[3] = __float_as_uint(h.w);
  lo[0] = __float_as_uint(l.x);
  lo[1] = __float_as_uint(l.y);
  lo[2] = __float_as_uint(l.z);
  lo[3] = __float_as_uint(l.w);
#endif
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
}

template <class T>
__global__ void __launch_bounds__(T::THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ lse, int hq, int hkv, int sq, int skv, int window,
                       float scale_log2) {
  constexpr int D = T::D, BQ = T::BQ, BKV = T::BKV, THREADS = T::THREADS;
  constexpr int LDK = T::LDK, LDV = T::LDV, LDR = T::LDR;
  constexpr int KSTEPS = D / 8;   // k-steps of S = Q K^T
  constexpr int NS = BKV / 8;     // n-tiles of S, k-steps of O += P V
  constexpr int NO = D / 8;       // n-tiles of O
  constexpr int VEC = D / 4;      // float4 per row
  extern __shared__ __align__(16) float smem[];
  float* Qp = smem;                   // [WARPS][KSTEPS][hi, lo][32 lanes][4]
  float* Kp = Qp + T::Q_FLOATS;       // [BKV][LDK]
  float* Vp = Kp + T::K_FLOATS;       // [D][LDV]
  float* Kr = Vp + T::V_FLOATS;       // [BKV][LDR]
  float* Vr = Kr + T::R_FLOATS;       // [BKV][LDR]

  const int bh = blockIdx.x;                      // b * hq + h
  const int qb = gridDim.y - 1 - blockIdx.y;      // longest rows first
  const int b = bh / hq;
  const int kvh = (bh - b * hq) / (hq / hkv);
  const float* Q = q + (size_t)bh * sq * D;
  const float* K = k + ((size_t)b * hkv + kvh) * skv * D;
  const float* V = v + ((size_t)b * hkv + kvh) * skv * D;
  float* O = out + (size_t)bh * sq * D;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;          // fragment row (and row + 8)
  const int t = lane & 3;           // fragment column pair
  const int q0 = qb * BQ;
  const int off = skv - sq;         // query i sits at key position i + off

  // Keys some row of this block may see: from the window start of its first
  // row to the diagonal of its last.
  const int k_hi = min(skv, min(q0 + BQ, sq) + off) - 1;
  const int k_lo = window > 0 ? max(0, q0 + off - window + 1) : 0;
  const int kb0 = (k_lo / BKV) * BKV;
  const int n_tiles = k_hi >= kb0 ? (k_hi - kb0) / BKV + 1 : 0;

  constexpr int KV_ITEMS = BKV * VEC;   // float4 of one raw K or V tile
  auto load_raw = [&](int kb) {   // K and V rows [kb, kb + BKV); past skv as 0
#pragma unroll
    for (int it = 0; it < (KV_ITEMS + THREADS - 1) / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS;
      if (KV_ITEMS % THREADS != 0 && i >= KV_ITEMS) break;
      const int r = i / VEC, c = (i - r * VEC) * 4;
      const bool valid = kb + r < skv;
      const size_t src = (size_t)(valid ? kb + r : 0) * D + c;
      cp_async16(smem_u32(Kr + r * LDR + c), K + src, valid);
      cp_async16(smem_u32(Vr + r * LDR + c), V + src, valid);
    }
    cp_async_commit();
  };

  if (n_tiles > 0) load_raw(kb0);
  // Q, split once, as each warp's A fragments in lane order: element
  // (row g + 8 h, column 8 kk + 2 t + w) of warp r / 16 is register h + 2 w
  // of lane 4 g + t in k-step kk. Rows at or past sq are 0.
#pragma unroll
  for (int it = 0; it < BQ * VEC / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / VEC, c = (i - r * VEC) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q0 + r < sq) x = *reinterpret_cast<const float4*>(Q + (size_t)(q0 + r) * D + c);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    float* dst = Qp + ((r / 16) * KSTEPS + c / 8) * 256 + (r & 7) * 16 + ((r >> 3) & 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = (c & 7) + j;             // t = col / 2, w = col % 2
      float* e = dst + (col >> 1) * 4 + 2 * (col & 1);
      split_x(xs[j], e[0], e[128]);
    }
  }

  float o[NO][4];
  zero(o);
  float m_run[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8 (log2 units)
  float l_run[2] = {0.0f, 0.0f};            // this lane's share of the running sums

  const int qpos0 = q0 + warp * 16 + off;   // key position of this warp's first row
  const float* qs = Qp + warp * KSTEPS * 256 + lane * 4;
  const float* ks = Kp + g * LDK + 4 * t;
  const float* vs = Vp + g * LDV + 4 * t;

  for (int j = 0; j < n_tiles; ++j) {
    const int kb = kb0 + j * BKV;
    cp_async_wait_all();
    __syncthreads();          // raw tile j is in; every warp is done with the planes
#if FLASH_F32_ABLATE != 2
#pragma unroll
    for (int it = 0; it < (KV_ITEMS + THREADS - 1) / THREADS; ++it) {   // K: key-major plane
      const int i = threadIdx.x + it * THREADS;
      if (KV_ITEMS % THREADS != 0 && i >= KV_ITEMS) break;
      const int r = i / VEC, c = (i - r * VEC) * 4;
      const float4 x = *reinterpret_cast<const float4*>(Kr + r * LDR + c);
      float4* dst = reinterpret_cast<float4*>(Kp + r * LDK + 2 * c);
      dst[0] = split_pair(x.x, x.y);
      dst[1] = split_pair(x.z, x.w);
    }
    constexpr int V_ITEMS = BKV / 2 * VEC;
#pragma unroll
    for (int it = 0; it < (V_ITEMS + THREADS - 1) / THREADS; ++it) {   // V: d-major plane
      const int i = threadIdx.x + it * THREADS;
      if (V_ITEMS % THREADS != 0 && i >= V_ITEMS) break;
      const int kp = i % (BKV / 2), c = (i / (BKV / 2)) * 4;   // keys 2 kp, 2 kp + 1
      const float4 x = *reinterpret_cast<const float4*>(Vr + 2 * kp * LDR + c);
      const float4 y = *reinterpret_cast<const float4*>(Vr + (2 * kp + 1) * LDR + c);
      float4* dst = reinterpret_cast<float4*>(Vp + c * LDV + 4 * kp);
      dst[0] = split_pair(x.x, y.x);
      dst[LDV / 4] = split_pair(x.y, y.y);
      dst[2 * LDV / 4] = split_pair(x.z, y.z);
      dst[3 * LDV / 4] = split_pair(x.w, y.w);
    }
#endif
    __syncthreads();          // the planes are in; the raw tile is free
    if (j + 1 < n_tiles) load_raw(kb + BKV);

    // A tile no row of this warp may see costs the warp nothing.
    if (kb > qpos0 + 15 || (window > 0 && kb + BKV - 1 <= qpos0 - window)) continue;

    // S = Q K^T: per k-step, the Q fragment and the K fragments of every 8
    // keys, then the three passes: the two small ones into s2, the large one
    // into s.
    float s[NS][4], s2[NS][4];
    zero(s);
    zero(s2);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      // a0: (g, t), a1: (g + 8, t), a2: (g, t + 4), a3: (g + 8, t + 4).
      uint32_t a_hi[4], a_lo[4];
      frag_a(qs + kk * 256, a_hi, a_lo);
      uint32_t b_hi[NS][2], b_lo[NS][2];
#pragma unroll
      for (int n = 0; n < NS; ++n) frag_b(ks + n * 8 * LDK + kk * 16, b_hi[n], b_lo[n]);
#if FLASH_F32_ABLATE != 3
#pragma unroll
      for (int n = 0; n < NS; ++n)
        mma_tf32(FLASH_F32_ABLATE == 4 ? s[n] : s2[n], a_lo, b_hi[n][0], b_hi[n][1]);
#pragma unroll
      for (int n = 0; n < NS; ++n)
        mma_tf32(FLASH_F32_ABLATE == 4 ? s[n] : s2[n], a_hi, b_lo[n][0], b_lo[n][1]);
#endif
#pragma unroll
      for (int n = 0; n < NS; ++n) mma_tf32(s[n], a_hi, b_hi[n][0], b_hi[n][1]);
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += s2[n][e];

    // Per-element masks only where the tile crosses this warp's diagonal, the
    // window edge of its last row, or the end of the keys. c0, c1: row g,
    // keys 2t, 2t + 1; c2, c3: row g + 8.
    const bool edge = kb + BKV - 1 > qpos0 || kb + BKV > skv ||
                      (window > 0 && kb <= qpos0 + 15 - window);
    if (edge) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = kb + n * 8 + 2 * t + (e & 1);
          const int qp = qpos0 + g + 8 * (e >> 1);
          const bool keep = kpos <= qp && kpos < skv && (window <= 0 || kpos > qp - window);
          if (!keep) s[n][e] = -INFINITY;
        }
    }

    // Online softmax on rows g (elements 0, 1) and g + 8 (2, 3).
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NS; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m_run[r], mx * scale_log2);
      m_use[r] = m_new == -INFINITY ? 0.0f : m_new;   // row still fully masked
      const float alpha = ex2(m_run[r] - m_use[r]);    // 0 while m_run is -inf
      m_run[r] = m_new;
      l_run[r] *= alpha;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }

    // O += P V into a fresh accumulator, one k-step per 8 keys, then added to
    // O in f32; DCH columns at a time (one chunk up to D = 128). P's A
    // fragment is the S accumulator read as mma indices t (key 2t: c0, c2)
    // and t + 4 (key 2t + 1: c1, c3); each chunk forms it, the same bits,
    // and the first adds it to the row sums.
    constexpr int NC = T::DCH / 8;
#pragma unroll
    for (int c0 = 0; c0 < NO; c0 += NC) {
      float ot[NC][4];
      zero(ot);
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        uint32_t p_hi[4], p_lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[kk][e], scale_log2, -m_use[e >> 1]));
          if (c0 == 0) l_run[e >> 1] += p;
          const int a = (e >> 1) | ((e & 1) << 1);   // c0 -> a0, c1 -> a2, c2 -> a1, c3 -> a3
          p_hi[a] = to_tf32(p);
          p_lo[a] = to_tf32(p - __uint_as_float(p_hi[a]));
        }
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          uint32_t b_hi[2], b_lo[2];
          frag_b(vs + (c0 + j) * 8 * LDV + kk * 16, b_hi, b_lo);
          float(&acc)[4] = FLASH_F32_ABLATE == 4 ? o[c0 + j] : ot[j];
#if FLASH_F32_ABLATE != 3
          mma_tf32(acc, p_lo, b_hi[0], b_hi[1]);
          mma_tf32(acc, p_hi, b_lo[0], b_lo[1]);
#endif
          mma_tf32(acc, p_hi, b_hi[0], b_hi[1]);
        }
      }
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[c0 + j][e] += ot[j][e];
    }
  }

  // Normalise and store: l is 0 only for a fully masked row (written as 0),
  // and NaN where the row met a NaN score. With `lse`, the row's log-sum-exp
  // m + log l in natural units (-inf for a fully masked row), for the
  // backward pass (flash_attention_bwd.cu).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(FULL, l, 1);
    l += __shfl_xor_sync(FULL, l, 2);
    const float inv = l == 0.0f ? 0.0f : 1.0f / l;
    const int row = q0 + warp * 16 + 8 * r + g;
    if (row >= sq) continue;
    if (lse != nullptr && t == 0)
      lse[(size_t)bh * sq + row] = l == 0.0f ? -INFINITY : (m_run[r] + log2f(l)) * LN2;
    float* dst = O + (size_t)row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(dst + n * 8) =
          make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

template <class T>
int launch(const float* q, const float* k, const float* v, float* out, float* lse, int batch,
           int hq, int hkv, int sq, int skv, int window, float scale_log2, cudaStream_t stream) {
  const cudaError_t set = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(batch * hq, (sq + T::BQ - 1) / T::BQ);
  flash_attention_kernel<T><<<grid, T::THREADS, T::SMEM, stream>>>(q, k, v, out, lse, hq, hkv,
                                                                   sq, skv, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out [batch, hq, sq, d]; k, v [batch, hkv, skv, d]: contiguous float32,
// 16-byte aligned, with hq a multiple of hkv and d one of 32, 64, 80, 128,
// 240. window <= 0 means no window. lse, if not null, is [batch, hq, sq] and gets
// each row's log-sum-exp of its scaled scores. Launches on `stream` and
// returns the cudaError_t of the launch. bfloat16 inputs take
// flash_attention_tc.cu.
extern "C" int flash_attention_f32(const float* q, const float* k, const float* v, float* out,
                                   float* lse, int batch, int hq, int hkv, int sq, int skv,
                                   int d, int window, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * LOG2E;
  switch (d) {
    case 32: return launch<T32>(q, k, v, out, lse, batch, hq, hkv, sq, skv, window, sl2, s);
    case 64: return launch<T64>(q, k, v, out, lse, batch, hq, hkv, sq, skv, window, sl2, s);
    case 80: return launch<T80>(q, k, v, out, lse, batch, hq, hkv, sq, skv, window, sl2, s);
    case 128: return launch<T128>(q, k, v, out, lse, batch, hq, hkv, sq, skv, window, sl2, s);
    case 240: return launch<T240>(q, k, v, out, lse, batch, hq, hkv, sq, skv, window, sl2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
