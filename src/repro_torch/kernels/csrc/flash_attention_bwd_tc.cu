// The backward pass of causal (optionally windowed) attention with grouped kv
// heads, for bfloat16 inputs, on the tensor cores: from q, k, v, the forward's
// output O and row log-sum-exp L, and the output's gradient dO, the gradients
// dQ, dK and dV. The contract is that of flash_attention_bwd.cu, which keeps
// the float32 inputs: q, O, dO [B, Hq, Sq, D] and k, v [B, Hkv, Skv, D] with
// Hq a multiple of Hkv, q head h reading kv head h / (Hq / Hkv); query i sits
// at key position i + Skv - Sq and sees the keys at positions <= its own, and
// with a window only those > its own minus the window. With S = Q K^T * scale
// over the keys a row sees:
//   P = exp(S - L), dP = dO V^T, D = rowsum(dO * O), dS = P * (dP - D),
//   dQ = dS K * scale, dK = dS^T Q * scale, dV = P^T dO,
// where dK and dV sum over the q heads of each kv head's group. A pair (row,
// key) the row may not see contributes nothing: a fully masked row gets
// dQ = 0 and adds nothing to dK or dV. The plain version is
// ref.flash_attention_bwd.
//
// Replaces: no TPU kernel. The JAX package's Pallas `flash_attention`
// (src/repro/kernels/flash_attention.py:80, pallas_call at :98) has no VJP;
// the reference trains through its plain jnp attention. This kernel is the
// port's own, so that training on the card runs through a kernel on both
// passes.
//
// Numbers: products of bf16 values are exact in f32, so S and dP on the
// tensor cores with f32 accumulation differ from the plain version only in
// the order of their sums. The new roundings are P and dS to bf16 before
// their products (dV = P^T dO, dK = dS^T Q, dQ = dS K), as in
// FlashAttention-2; dS is formed from P before rounding. D = rowsum(dO * O)
// is a separate f32 pass over bf16 O and dO.
//
// What bounds it on the H100: operations. At the training shape (2 x 32 q
// heads, 2048 tokens, D = 80) the five products the gradient needs (S, dP,
// dQ, dK, dV) over the causal pairs are 107.4 GFLOP, against ~105 MB of bf16
// inputs and outputs: 0.109 ms at the bf16 tensor-core peak of 989 TFLOP/s.
// This design computes seven (S and dP in both kernels), 150.4 GFLOP:
// 0.152 ms at that peak.
//
// What the design does about it (FlashAttention-2's backward on mma.sync,
// without atomics, so that each output element is written once, by one
// thread, after sums in a fixed order, and two runs give the same bits):
// - Three launches on one stream: a pass for D (one warp per row), a dK/dV
//   kernel and a dQ kernel. Recomputing S and dP in the dQ kernel (seven
//   products instead of five) is the price of needing no atomics.
// - dK/dV: one block of 4 warps per (batch, kv head, 64 keys); each warp
//   owns 16 keys, K and V stay bf16 in shared memory for the block's life.
//   The block loops over the group's q heads and over only the q tiles the
//   causal mask and the window let see its keys, with Q, dO, L and D
//   double-buffered by cp.async (16-byte chunks, rows padded to D + 8 so
//   every ldmatrix is free of bank conflicts). Per q tile each warp computes
//   the transposed products S^T = K Q^T and dP^T = V dO^T on m16n8k16
//   (A fragments of K and V, B fragments of Q and dO by ldmatrix), so that
//   P^T and dS^T come out of the f32 accumulators in registers exactly where
//   the A fragments of the next products want them: two adjacent C
//   fragments, rounded to bf16, are one A fragment. dV += P^T dO and
//   dK += dS^T Q then take B fragments of dO and Q by ldmatrix.trans. P and
//   dS never touch shared memory; the GQA sum happens in the warp's
//   accumulators.
// - dQ: one block of 4 warps per (batch, q head, 64 rows); each warp owns
//   16 rows, Q and dO held as A fragments in registers, L and D of its rows
//   in registers; K and V tiles double-buffered over only the keys the rows
//   may see. S = Q K^T and dP = dO V^T, dS in registers, then dQ += dS K
//   with K's B fragments by ldmatrix.trans.
// - Masks per element only on tiles that cross the diagonal, the window
//   edge, the end of the keys or (dK/dV) the end of the rows; interior tiles
//   skip them, and a warp skips a tile none of whose pairs it may see. Rows
//   past Sq and keys past Skv load as zeros with L = D = 0; a row that sees
//   no key (L = -inf, where Sq > Skv) lies only on tiles that cross the
//   diagonal, where its P and dS are set to 0 by selection, never computed
//   as exp2(x - (-inf)).
// - Tiles: the dK/dV kernel takes 64 q rows a tile for D <= 80 and 32 at
//   D = 128, where the f32 accumulators of dK and dV (2 x 16 n-tiles x 4
//   registers) leave less room for S^T and dP^T; the dQ kernel takes 32
//   keys a tile. Registers are capped for two dK/dV blocks an SM (255) and
//   for three dQ blocks (168) for D <= 80. Blocks are launched longest first
//   (the first key blocks, the last query blocks).
// - At D = 80 `-Xptxas -v` reports 238 registers for dK/dV and 166 for dQ,
//   no spills. At the training shape (NVIDIA H100 80GB HBM3, 700 W;
//   tools/flash_bwd_variants.py) the three launches take ~0.65 ms: dK/dV
//   ~0.38 ms and dQ ~0.24 ms, 35 % and 42 % of the 617-638 TFLOP/s that
//   independent mma.sync bf16 products reach with nothing to load. Three
//   dK/dV blocks an SM (168 registers), 32-row dK/dV tiles, 8-warp blocks
//   and 64-key dQ tiles were each slower there.
// - D = 240 (gemma3-12b: 3840 / 16 heads; Tile<D>::WIDE). What bounds it is
//   the register file. A warp of the dK/dV kernel above holds the f32 dK and
//   dV of its 16 keys, 240 registers a thread at D = 240 before S^T and
//   dP^T; the dQ kernel holds Q and dO as A fragments (120) and dQ (120).
//   Shared memory is not the limit. So the dK/dV kernel takes the head dim
//   apart by output: flash_attention_bwd_dkdv_wide_tc_kernel runs 8 warps on
//   the block's 64 keys, two warps for each 16 keys. Role 0 computes
//   S^T = K Q^T and P^T and adds P^T dO into dV; role 1 computes
//   dP^T = V dO^T and adds dS^T Q into dK. Each holds one f32 accumulator of
//   16 keys x 240 (120 registers), so the two products the gradient needs of
//   each tile are split between the roles with none computed twice. dS^T
//   needs P^T, so role 0 writes P^T (f32, masked) to shared memory in
//   C-fragment lane order, one barrier later role 1 reads it at the same
//   positions (the C fragments of S^T and dP^T hold the same pairs), and dS^T
//   is formed from P before rounding, as above. 64-row tiles; 207,872 B of
//   shared memory, one block of 8 warps an SM. The dQ kernel keeps its
//   layout with Q and dO read from the block's tiles at each k-step (one
//   ldmatrix.x4 each) instead of held, and 16-key tiles, so that two blocks
//   (95,232 B each) share an SM. Outputs are still written once, after sums
//   in a fixed order: two runs give the same bits. `-Xptxas -v`: 244
//   registers (dK/dV) and 235 (dQ), no spill. At gemma's training shape (q
//   [2,16,2048,240], kv 8 heads) the three launches take 1.118-1.130 ms,
//   6.9x the 0.163 ms of the five products at the bf16 peak, 0.897-0.902 ms
//   with window 1024 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py, two runs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;            // each owns 16 keys (dK/dV) or 16 query rows (dQ)
constexpr int THREADS = 32 * WARPS;
constexpr int BLOCK = 16 * WARPS;   // keys (dK/dV) or query rows (dQ) per block
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr bool WIDE = D > 128;                // the D = 240 kernels: the note above
  static constexpr int BQ = D <= 80 || WIDE ? 64 : 32;  // dK/dV kernel: query rows per tile
  static constexpr int BKV = WIDE ? 16 : 32;           // dQ kernel: keys per tile
  static constexpr int DKDV_BLOCKS = WIDE ? 1 : 2;     // blocks an SM (the register cap)
  static constexpr int DQ_BLOCKS = D <= 80 ? 3 : 2;    // of each kernel
};

constexpr int WIDE_WARPS = 8;       // the wide dK/dV kernel: 4 key groups x 2 roles
constexpr int WIDE_THREADS = 32 * WIDE_WARPS;
constexpr int WIDE_GROUPS = WIDE_WARPS / 2;

// K and V of the block, two stages of Q and dO (rows padded to D + 8), and
// two stages of the rows' L and D; the wide kernel also stages P^T in f32.
template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(bf16) * (size_t)(2 * BLOCK + 4 * Tile<D>::BQ) * (D + 8) +
         sizeof(float) * 4 * Tile<D>::BQ +
         (Tile<D>::WIDE ? sizeof(float) * (size_t)BLOCK * Tile<D>::BQ : 0);
}

// Q and dO of the block, two stages of K and V.
template <int D>
constexpr size_t dq_smem() {
  return sizeof(bf16) * (size_t)(2 * BLOCK + 4 * Tile<D>::BKV) * (D + 8);
}

// Two f32 as a bf16 pair, lo in the low half (the element with the lower
// index in an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 4 bytes global -> shared, or 4 zero bytes where !valid (nothing is read).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

// Rows [r0, r0 + ROWS) of a row-major [nrows, D] bf16 array into a
// [ROWS][D + 8] shared tile by cp.async, by a block of NTH threads; rows at or
// past nrows are zero-filled.
template <int D, int ROWS, int NTH = THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int r0,
                                          int nrows) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < (ROWS * CHUNKS + NTH - 1) / NTH; ++it) {
    const int i = threadIdx.x + it * NTH;
    if (ROWS * CHUNKS % NTH != 0 && i >= ROWS * CHUNKS) break;
    const int r = i / CHUNKS;
    const int ch = i - r * CHUNKS;
    const bool valid = r0 + r < nrows;
    const bf16* g = src + (size_t)(valid ? r0 + r : 0) * D + ch * 8;
    cp_async16(smem_u32(dst + r * (D + 8) + ch * 8), g, valid);
  }
}

// Entries [r0, r0 + ROWS) of a float32 [nrows] array into shared memory by
// cp.async, by a block of NTH threads; 0 at or past nrows.
template <int ROWS, int NTH = THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int r0,
                                          int nrows) {
  for (int i = threadIdx.x; i < ROWS; i += NTH) {
    const bool valid = r0 + i < nrows;
    cp_async4(smem_u32(dst + i), src + (valid ? r0 + i : 0), valid);
  }
}

// D = rowsum(dO * O) in f32, one warp per row.
template <int D>
__global__ void __launch_bounds__(256)
flash_attention_bwd_delta_tc_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                    float* __restrict__ delta, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(o + row * D);
  const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(dout + row * D);
  float acc = 0.0f;
  for (int c = lane; c < D / 2; c += 32) {
    const float2 x = __bfloat1622float2(o2[c]), y = __bfloat1622float2(d2[c]);
    acc = fmaf(y.x, x.x, acc);
    acc = fmaf(y.y, x.y, acc);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) delta[row] = acc;
}

template <int D>
__global__ void __launch_bounds__(THREADS, Tile<D>::DKDV_BLOCKS)
flash_attention_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                   const float* __restrict__ lse, const float* __restrict__ delta,
                                   bf16* __restrict__ dk, bf16* __restrict__ dv, int hq, int hkv,
                                   int sq, int skv, int window, float scale_log2, float scale) {
  constexpr int BQ = Tile<D>::BQ;
  constexpr int LD = D + 8;       // padded row stride of every tile (elements)
  constexpr int KS = D / 16;      // k-steps of S^T = K Q^T and dP^T = V dO^T
  constexpr int NT = D / 8;       // n-tiles of dK and dV
  constexpr int QN = BQ / 8;      // n-tiles of S^T and dP^T (8 query rows each)
  constexpr int QSTAGE = BQ * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);              // [BLOCK][LD]
  bf16* Vs = Ks + BLOCK * LD;                                 // [BLOCK][LD]
  bf16* Qs = Vs + BLOCK * LD;                                 // [2][BQ][LD]
  bf16* dOs = Qs + 2 * QSTAGE;                                // [2][BQ][LD]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * QSTAGE);     // [2][BQ]
  float* Ds = Ls + 2 * BQ;                                    // [2][BQ]

  const int b = blockIdx.x / hkv, kvh = blockIdx.x - b * hkv;
  const int k0 = blockIdx.y * BLOCK;   // the first key blocks are seen by the most rows
  const int group = hq / hkv, off = skv - sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;             // fragment row (and row + 8)
  const int t = lane & 3;              // fragment column pair
  const int mi = lane >> 3;            // which 8 x 8 matrix this lane addresses
  const int mr = lane & 7;             // which row of it
  const size_t kv_base = ((size_t)b * hkv + kvh) * skv;
  const size_t head0 = (size_t)b * hq + (size_t)kvh * group;   // the group's first q head

  // Rows that see some key of the block: from its first key's diagonal to
  // the window's end of its last key; the loop runs over (q head, q tile).
  const int k_last = min(k0 + BLOCK, skv) - 1;
  const int i_lo = max(0, k0 - off);
  const int i_hi = window > 0 ? (int)min((long long)sq - 1, (long long)k_last + window - 1 - off)
                              : sq - 1;
  const int qt0 = i_lo / BQ;
  const int n_qt = i_hi >= i_lo ? i_hi / BQ - qt0 + 1 : 0;
  const int n_it = group * n_qt;

  auto load_q = [&](int it, int st) {
    const int hg = it / n_qt;
    const int q0 = (qt0 + it - hg * n_qt) * BQ;
    const size_t rb = (head0 + hg) * sq;
    load_tile<D, BQ>(Qs + st * QSTAGE, q + rb * D, q0, sq);
    load_tile<D, BQ>(dOs + st * QSTAGE, dout + rb * D, q0, sq);
    load_rows<BQ>(Ls + st * BQ, lse + rb, q0, sq);
    load_rows<BQ>(Ds + st * BQ, delta + rb, q0, sq);
  };

  if (n_it > 0) {
    load_tile<D, BLOCK>(Ks, k + kv_base * D, k0, skv);
    load_tile<D, BLOCK>(Vs, v + kv_base * D, k0, skv);
    load_q(0, 0);
  }
  cp_async_commit();

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;

  const int kw = k0 + warp * 16;       // this warp's first key
  const int a_row = warp * 16 + (mi & 1) * 8 + mr;   // its A fragments' ldmatrix row
  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) load_q(it + 1, st ^ 1);   // the stage read in iteration it - 1 is free
    cp_async_commit();
    cp_async_wait<1>();                          // tile it has landed
    __syncthreads();
    const int hg = it / n_qt;
    const int q0 = (qt0 + it - hg * n_qt) * BQ;
    const int p_lo = q0 + off;                   // key position of the tile's first row
    const int p_hi = min(q0 + BQ, sq) - 1 + off; // and of its last
    // A tile none of whose pairs this warp may see costs it nothing.
    const bool seen = kw < skv && kw <= p_hi && (window <= 0 || kw + 15 > p_lo - window);
    if (seen) {
      const bf16* Qt = Qs + st * QSTAGE;
      const bf16* dOt = dOs + st * QSTAGE;
      const float* Lt = Ls + st * BQ;
      const float* Dt = Ds + st * BQ;

      // S^T = K Q^T and dP^T = V dO^T, [16 keys, BQ rows]: per k-step the A
      // fragments of K and V, and per 16 rows one ldmatrix.x4 each of Q and
      // dO giving the B fragments of two n-tiles.
      float s[QN][4], dp[QN][4];
#pragma unroll
      for (int n = 0; n < QN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ka[4], va[4];
        const int a_at = a_row * LD + ks * 16 + (mi >> 1) * 8;
        ldmatrix_x4(ka, smem_u32(Ks + a_at));
        ldmatrix_x4(va, smem_u32(Vs + a_at));
#pragma unroll
        for (int np = 0; np < QN / 2; ++np) {
          const int b_at = (np * 16 + (mi >> 1) * 8 + mr) * LD + ks * 16 + (mi & 1) * 8;
          uint32_t qb[4], ob[4];
          ldmatrix_x4(qb, smem_u32(Qt + b_at));
          ldmatrix_x4(ob, smem_u32(dOt + b_at));
          mma_bf16(s[2 * np], ka, qb[0], qb[1]);
          mma_bf16(s[2 * np + 1], ka, qb[2], qb[3]);
          mma_bf16(dp[2 * np], va, ob[0], ob[1]);
          mma_bf16(dp[2 * np + 1], va, ob[2], ob[3]);
        }
      }

      // P^T = exp2(S^T scale log2(e) - L) and dS^T = P^T (dP^T - D), each
      // rounded to bf16 as the A fragments of the next products: elements 0,
      // 1 of n-tile n are key g and rows n * 8 + 2t, + 1 (2, 3: key g + 8),
      // and n-tiles 2kk, 2kk + 1 make k-step kk. Per-element masks only where
      // the tile crosses this warp's diagonal, its window edge, or the end of
      // the keys or the rows.
      const bool edge = kw + 15 > p_lo || kw + 16 > skv || q0 + BQ > sq ||
                        (window > 0 && kw <= p_hi - window);
      uint32_t pa[QN / 2][4], dsa[QN / 2][4];
#pragma unroll
      for (int n = 0; n < QN; ++n) {
        const int col = n * 8 + 2 * t;
        const float2 l = *reinterpret_cast<const float2*>(Lt + col);
        const float2 dd = *reinterpret_cast<const float2*>(Dt + col);
        const float lc[2] = {l.x * LOG2E, l.y * LOG2E};
        const float dc[2] = {dd.x, dd.y};
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = ex2(fmaf(s[n][e], scale_log2, -lc[e & 1]));
          ds[e] = p[e] * (dp[n][e] - dc[e & 1]);
        }
        if (edge) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kw + g + 8 * (e >> 1);
            const int row = q0 + col + (e & 1);
            const int qp = row + off;
            const bool keep =
                row < sq && key < skv && key <= qp && (window <= 0 || key > qp - window);
            if (!keep) p[e] = ds[e] = 0.0f;
          }
        }
        pa[n >> 1][2 * (n & 1)] = pack_bf16(p[0], p[1]);
        pa[n >> 1][2 * (n & 1) + 1] = pack_bf16(p[2], p[3]);
        dsa[n >> 1][2 * (n & 1)] = pack_bf16(ds[0], ds[1]);
        dsa[n >> 1][2 * (n & 1) + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dV += P^T dO and dK += dS^T Q: per k-step of 16 rows, one
      // ldmatrix.x4.trans each of dO and Q gives the B fragments of two
      // n-tiles of 8 columns.
#pragma unroll
      for (int kk = 0; kk < QN / 2; ++kk)
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          const int at = (kk * 16 + (mi & 1) * 8 + mr) * LD + dn * 16 + (mi >> 1) * 8;
          uint32_t ob[4], qb[4];
          ldmatrix_x4_trans(ob, smem_u32(dOt + at));
          ldmatrix_x4_trans(qb, smem_u32(Qt + at));
          mma_bf16(dva[2 * dn], pa[kk], ob[0], ob[1]);
          mma_bf16(dva[2 * dn + 1], pa[kk], ob[2], ob[3]);
          mma_bf16(dka[2 * dn], dsa[kk], qb[0], qb[1]);
          mma_bf16(dka[2 * dn + 1], dsa[kk], qb[2], qb[3]);
        }
    }
    __syncthreads();                             // every warp is done with stage st
  }

  // dK (scaled) and dV of keys kw + g and kw + g + 8, columns n * 8 + 2t.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw + g + 8 * r;
    if (key >= skv) continue;
    bf16* dkr = dk + (kv_base + key) * D;
    bf16* dvr = dv + (kv_base + key) * D;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dkr + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dka[n][2 * r] * scale, dka[n][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvr + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

// The dK/dV kernel above D = 128 (the note above): 8 warps, key group
// kg = warp % 4 of 16 keys, role warp / 4, one accumulator of 16 keys x D a
// warp. Role 0 computes S^T = K Q^T, forms P^T, stages it in f32 (masked) in
// shared memory in C-fragment lane order and adds P^T dO to dV; role 1
// computes dP^T = V dO^T, reads P^T back at the same lane positions (the C
// fragments of S^T and dP^T hold the same (key, row) pairs), forms
// dS^T = P^T (dP^T - D) and adds dS^T Q to dK. Each output element is
// written once after sums in a fixed order, as in the kernel above.
template <int D>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
flash_attention_bwd_dkdv_wide_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                        const bf16* __restrict__ v,
                                        const bf16* __restrict__ dout,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta, bf16* __restrict__ dk,
                                        bf16* __restrict__ dv, int hq, int hkv, int sq, int skv,
                                        int window, float scale_log2, float scale) {
  constexpr int BQ = Tile<D>::BQ;
  constexpr int LD = D + 8;       // padded row stride of every tile (elements)
  constexpr int KS = D / 16;      // k-steps of S^T and dP^T
  constexpr int NT = D / 8;       // n-tiles of dK or dV
  constexpr int QN = BQ / 8;      // n-tiles of S^T and dP^T (8 query rows each)
  constexpr int QSTAGE = BQ * LD;
  static_assert(WIDE_GROUPS * 16 == BLOCK, "the key groups cover the block's keys");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);              // [BLOCK][LD]
  bf16* Vs = Ks + BLOCK * LD;                                 // [BLOCK][LD]
  bf16* Qs = Vs + BLOCK * LD;                                 // [2][BQ][LD]
  bf16* dOs = Qs + 2 * QSTAGE;                                // [2][BQ][LD]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * QSTAGE);     // [2][BQ]
  float* Ds = Ls + 2 * BQ;                                    // [2][BQ]
  float* Ps = Ds + 2 * BQ;                                    // [GROUPS][QN][32 lanes][4]

  const int b = blockIdx.x / hkv, kvh = blockIdx.x - b * hkv;
  const int k0 = blockIdx.y * BLOCK;   // the first key blocks are seen by the most rows
  const int group = hq / hkv, off = skv - sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kg = warp % WIDE_GROUPS;   // this warp's 16 keys
  const int role = warp / WIDE_GROUPS; // 0: P^T and dV, 1: dS^T and dK
  const int g = lane >> 2;             // fragment row (and row + 8)
  const int t = lane & 3;              // fragment column pair
  const int mi = lane >> 3;            // which 8 x 8 matrix this lane addresses
  const int mr = lane & 7;             // which row of it
  const size_t kv_base = ((size_t)b * hkv + kvh) * skv;
  const size_t head0 = (size_t)b * hq + (size_t)kvh * group;   // the group's first q head

  const int k_last = min(k0 + BLOCK, skv) - 1;
  const int i_lo = max(0, k0 - off);
  const int i_hi = window > 0 ? (int)min((long long)sq - 1, (long long)k_last + window - 1 - off)
                              : sq - 1;
  const int qt0 = i_lo / BQ;
  const int n_qt = i_hi >= i_lo ? i_hi / BQ - qt0 + 1 : 0;
  const int n_it = group * n_qt;

  auto load_q = [&](int it, int st) {
    const int hg = it / n_qt;
    const int q0 = (qt0 + it - hg * n_qt) * BQ;
    const size_t rb = (head0 + hg) * sq;
    load_tile<D, BQ, WIDE_THREADS>(Qs + st * QSTAGE, q + rb * D, q0, sq);
    load_tile<D, BQ, WIDE_THREADS>(dOs + st * QSTAGE, dout + rb * D, q0, sq);
    load_rows<BQ, WIDE_THREADS>(Ls + st * BQ, lse + rb, q0, sq);
    load_rows<BQ, WIDE_THREADS>(Ds + st * BQ, delta + rb, q0, sq);
  };

  if (n_it > 0) {
    load_tile<D, BLOCK, WIDE_THREADS>(Ks, k + kv_base * D, k0, skv);
    load_tile<D, BLOCK, WIDE_THREADS>(Vs, v + kv_base * D, k0, skv);
    load_q(0, 0);
  }
  cp_async_commit();

  float acc[NT][4];                    // dV (role 0) or dK (role 1)
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  const int kw = k0 + kg * 16;         // this warp's first key
  const bf16* As = role == 0 ? Ks : Vs;                      // A of S^T or dP^T
  const uint32_t a_at = smem_u32(As + (kg * 16 + (mi & 1) * 8 + mr) * LD + (mi >> 1) * 8);
  float* ps = Ps + (kg * QN * 32 + lane) * 4;                // this lane's P^T, n-tile 0
  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) load_q(it + 1, st ^ 1);   // the stage read in iteration it - 1 is free
    cp_async_commit();
    cp_async_wait<1>();                          // tile it has landed
    __syncthreads();
    const int hg = it / n_qt;
    const int q0 = (qt0 + it - hg * n_qt) * BQ;
    const int p_lo = q0 + off;                   // key position of the tile's first row
    const int p_hi = min(q0 + BQ, sq) - 1 + off; // and of its last
    // A tile none of whose pairs this key group may see costs its warps nothing.
    const bool seen = kw < skv && kw <= p_hi && (window <= 0 || kw + 15 > p_lo - window);
    const bool edge = kw + 15 > p_lo || kw + 16 > skv || q0 + BQ > sq ||
                      (window > 0 && kw <= p_hi - window);
    const bf16* Qt = Qs + st * QSTAGE;
    const bf16* dOt = dOs + st * QSTAGE;
    const float* Lt = Ls + st * BQ;
    const float* Dt = Ds + st * BQ;
    const bf16* Bt = role == 0 ? Qt : dOt;      // B of S^T or dP^T
    auto keep = [&](int n, int e) {
      const int key = kw + g + 8 * (e >> 1);
      const int row = q0 + n * 8 + 2 * t + (e & 1);
      const int qp = row + off;
      return row < sq && key < skv && key <= qp && (window <= 0 || key > qp - window);
    };

    // S^T = K Q^T (role 0) or dP^T = V dO^T (role 1), [16 keys, BQ rows].
    float x[QN][4];
    if (seen) {
#pragma unroll
      for (int n = 0; n < QN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[n][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t af[4];
        ldmatrix_x4(af, a_at + ks * 32);
#pragma unroll
        for (int np = 0; np < QN / 2; ++np) {
          const int b_at = (np * 16 + (mi >> 1) * 8 + mr) * LD + ks * 16 + (mi & 1) * 8;
          uint32_t bfr[4];
          ldmatrix_x4(bfr, smem_u32(Bt + b_at));
          mma_bf16(x[2 * np], af, bfr[0], bfr[1]);
          mma_bf16(x[2 * np + 1], af, bfr[2], bfr[3]);
        }
      }
      if (role == 0) {   // P^T = exp2(S^T scale log2(e) - L), masked, kept and staged
#pragma unroll
        for (int n = 0; n < QN; ++n) {
          const float2 l = *reinterpret_cast<const float2*>(Lt + n * 8 + 2 * t);
          const float lc[2] = {l.x * LOG2E, l.y * LOG2E};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[n][e] = ex2(fmaf(x[n][e], scale_log2, -lc[e & 1]));
            if (edge && !keep(n, e)) x[n][e] = 0.0f;
          }
          *reinterpret_cast<float4*>(ps + n * 128) = make_float4(x[n][0], x[n][1], x[n][2],
                                                                 x[n][3]);
        }
      }
    }
    __syncthreads();                             // P^T of every key group is in

    if (seen) {
      // The A fragments of this warp's product in bf16: P^T (role 0), or
      // dS^T = P^T (dP^T - D) (role 1, masked), elements as in the kernel above.
      uint32_t pa[QN / 2][4];
#pragma unroll
      for (int n = 0; n < QN; ++n) {
        float y[4];
        if (role == 0) {
#pragma unroll
          for (int e = 0; e < 4; ++e) y[e] = x[n][e];
        } else {
          const float4 p = *reinterpret_cast<const float4*>(ps + n * 128);
          const float2 dd = *reinterpret_cast<const float2*>(Dt + n * 8 + 2 * t);
          const float pv[4] = {p.x, p.y, p.z, p.w};
          const float dc[2] = {dd.x, dd.y};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            y[e] = pv[e] * (x[n][e] - dc[e & 1]);
            if (edge && !keep(n, e)) y[e] = 0.0f;
          }
        }
        pa[n >> 1][2 * (n & 1)] = pack_bf16(y[0], y[1]);
        pa[n >> 1][2 * (n & 1) + 1] = pack_bf16(y[2], y[3]);
      }
      // dV += P^T dO (role 0) or dK += dS^T Q (role 1): per k-step of 16
      // rows, one ldmatrix.x4.trans gives the B fragments of two n-tiles.
      const bf16* Ct = role == 0 ? dOt : Qt;
#pragma unroll
      for (int kk = 0; kk < QN / 2; ++kk)
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t cb[4];
          ldmatrix_x4_trans(cb, smem_u32(Ct + (kk * 16 + (mi & 1) * 8 + mr) * LD + dn * 16 +
                                         (mi >> 1) * 8));
          mma_bf16(acc[2 * dn], pa[kk], cb[0], cb[1]);
          mma_bf16(acc[2 * dn + 1], pa[kk], cb[2], cb[3]);
        }
    }
    __syncthreads();                             // every warp is done with stage st and P^T
  }

  // dV (role 0) or dK, scaled (role 1), of keys kw + g and kw + g + 8.
  const float mult = role == 0 ? 1.0f : scale;
  bf16* outp = role == 0 ? dv : dk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw + g + 8 * r;
    if (key >= skv) continue;
    bf16* row = outp + (kv_base + key) * D;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * r] * mult, acc[n][2 * r + 1] * mult);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, Tile<D>::DQ_BLOCKS)
flash_attention_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 bf16* __restrict__ dq, int hq, int hkv, int sq, int skv,
                                 int window, float scale_log2, float scale) {
  constexpr int BKV = Tile<D>::BKV;
  constexpr int LD = D + 8;       // padded row stride of every tile (elements)
  constexpr int KS = D / 16;      // k-steps of S = Q K^T and dP = dO V^T
  constexpr int NT = D / 8;       // n-tiles of dQ
  constexpr int KN = BKV / 8;     // n-tiles of S and dP (8 keys each)
  constexpr int STAGE = BKV * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BLOCK][LD]
  bf16* dOs = Qs + BLOCK * LD;                     // [BLOCK][LD]
  bf16* Ks = dOs + BLOCK * LD;                     // [2][BKV][LD]
  bf16* Vs = Ks + 2 * STAGE;                       // [2][BKV][LD]

  const int bh = blockIdx.x;                       // b * hq + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK;   // longest rows first
  const int b = bh / hq;
  const int kvh = (bh - b * hq) / (hq / hkv);
  const size_t row_base = (size_t)bh * sq;
  const bf16* K = k + ((size_t)b * hkv + kvh) * skv * D;
  const bf16* V = v + ((size_t)b * hkv + kvh) * skv * D;
  const int off = skv - sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, mr = lane & 7;

  // Keys some row of the block may see: from the window start of its first
  // row to the diagonal of its last.
  const int k_hi = min(skv, min(q0 + BLOCK, sq) + off) - 1;
  const int k_lo = window > 0 ? max(0, q0 + off - window + 1) : 0;
  const int kb0 = (k_lo / BKV) * BKV;
  const int n_tiles = k_hi >= kb0 ? (k_hi - kb0) / BKV + 1 : 0;

  load_tile<D, BLOCK>(Qs, q + row_base * D, q0, sq);
  load_tile<D, BLOCK>(dOs, dout + row_base * D, q0, sq);
  if (n_tiles > 0) {
    load_tile<D, BKV>(Ks, K, kb0, skv);
    load_tile<D, BKV>(Vs, V, kb0, skv);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Q and dO as A fragments, and L (log2 units) and D of rows g and g + 8;
  // 0 past sq. Held in registers up to D = 128; above (QREG false), each
  // k-step reads them from the block's tiles again.
  constexpr bool QREG = D <= 128;
  const int a_at = (warp * 16 + (mi & 1) * 8 + mr) * LD + (mi >> 1) * 8;
  uint32_t qa[KS][4], oa[KS][4];
  if constexpr (QREG) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      ldmatrix_x4(qa[ks], smem_u32(Qs + a_at + ks * 16));
      ldmatrix_x4(oa[ks], smem_u32(dOs + a_at + ks * 16));
    }
  }
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    lr[r] = row < sq ? lse[row_base + row] * LOG2E : 0.0f;
    dr[r] = row < sq ? delta[row_base + row] : 0.0f;
  }

  float dqa[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.0f;

  const int qpos0 = q0 + warp * 16 + off;   // key position of this warp's first row
  const bool rows_in = q0 + warp * 16 < sq;
  for (int j = 0; j < n_tiles; ++j) {
    const int kb = kb0 + j * BKV;
    const int st = j & 1;
    if (j + 1 < n_tiles) {                   // the stage read in iteration j - 1 is free
      load_tile<D, BKV>(Ks + (st ^ 1) * STAGE, K, kb + BKV, skv);
      load_tile<D, BKV>(Vs + (st ^ 1) * STAGE, V, kb + BKV, skv);
    }
    cp_async_commit();
    cp_async_wait<1>();                      // tile j has landed
    __syncthreads();
    const bf16* Kt = Ks + st * STAGE;
    const bf16* Vt = Vs + st * STAGE;

    // A tile no row of this warp may see costs the warp nothing.
    const bool seen = rows_in && kb <= qpos0 + 15 &&
                      (window <= 0 || kb + BKV - 1 > qpos0 - window);
    if (seen) {
      // S = Q K^T and dP = dO V^T: one ldmatrix.x4 each of K and V gives the
      // B fragments of two n-tiles of 8 keys for one k-step.
      float s[KN][4], dp[KN][4];
#pragma unroll
      for (int n = 0; n < KN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if constexpr (!QREG) {
          ldmatrix_x4(qa[ks], smem_u32(Qs + a_at + ks * 16));
          ldmatrix_x4(oa[ks], smem_u32(dOs + a_at + ks * 16));
        }
#pragma unroll
        for (int np = 0; np < KN / 2; ++np) {
          const int at = (np * 16 + (mi >> 1) * 8 + mr) * LD + ks * 16 + (mi & 1) * 8;
          uint32_t kf[4], vf[4];
          ldmatrix_x4(kf, smem_u32(Kt + at));
          ldmatrix_x4(vf, smem_u32(Vt + at));
          mma_bf16(s[2 * np], qa[ks], kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qa[ks], kf[2], kf[3]);
          mma_bf16(dp[2 * np], oa[ks], vf[0], vf[1]);
          mma_bf16(dp[2 * np + 1], oa[ks], vf[2], vf[3]);
        }
      }

      // dS = P (dP - D) with P = exp2(S scale log2(e) - L), rounded to bf16
      // as the A fragments of dS K; per-element masks only where the tile
      // crosses this warp's diagonal, its window edge or the end of the keys.
      const bool edge = kb + BKV - 1 > qpos0 || kb + BKV > skv ||
                        (window > 0 && kb <= qpos0 + 15 - window);
      uint32_t dsa[KN / 2][4];
#pragma unroll
      for (int n = 0; n < KN; ++n) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[n][e], scale_log2, -lr[e >> 1]));
          ds[e] = p * (dp[n][e] - dr[e >> 1]);
        }
        if (edge) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kb + n * 8 + 2 * t + (e & 1);
            const int qp = qpos0 + g + 8 * (e >> 1);
            const bool keep = key <= qp && key < skv && (window <= 0 || key > qp - window);
            if (!keep) ds[e] = 0.0f;
          }
        }
        dsa[n >> 1][2 * (n & 1)] = pack_bf16(ds[0], ds[1]);
        dsa[n >> 1][2 * (n & 1) + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dQ += dS K: one ldmatrix.x4.trans of K gives the B fragments of two
      // n-tiles of 8 columns for one k-step of 16 keys.
#pragma unroll
      for (int kk = 0; kk < KN / 2; ++kk)
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t kf[4];
          ldmatrix_x4_trans(kf, smem_u32(Kt + (kk * 16 + (mi & 1) * 8 + mr) * LD + dn * 16 +
                                         (mi >> 1) * 8));
          mma_bf16(dqa[2 * dn], dsa[kk], kf[0], kf[1]);
          mma_bf16(dqa[2 * dn + 1], dsa[kk], kf[2], kf[3]);
        }
    }
    __syncthreads();                         // every warp is done with stage st
  }

  // dQ (scaled) of rows g and g + 8, columns n * 8 + 2t.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= sq) continue;
    bf16* out = dq + (row_base + row) * D;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dqa[n][2 * r] * scale, dqa[n][2 * r + 1] * scale);
  }
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
           const float* lse, float* delta, bf16* dq, bf16* dk, bf16* dv, int batch, int hq,
           int hkv, int sq, int skv, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem_kv = dkdv_smem<D>(), smem_q = dq_smem<D>();
  constexpr bool wide = Tile<D>::WIDE;
  void (*dkdv)(const bf16*, const bf16*, const bf16*, const bf16*, const float*, const float*,
               bf16*, bf16*, int, int, int, int, int, float, float);
  if constexpr (wide)
    dkdv = flash_attention_bwd_dkdv_wide_tc_kernel<D>;
  else
    dkdv = flash_attention_bwd_dkdv_tc_kernel<D>;
  cudaError_t e =
      cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(flash_attention_bwd_dq_tc_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rows = (long long)batch * hq * sq;
  flash_attention_bwd_delta_tc_kernel<D>
      <<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(o, dout, delta, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const float sl2 = scale * LOG2E;
  dkdv<<<dim3(batch * hkv, (skv + BLOCK - 1) / BLOCK), wide ? WIDE_THREADS : THREADS, smem_kv,
         stream>>>(q, k, v, dout, lse, delta, dk, dv, hq, hkv, sq, skv, window, sl2, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_attention_bwd_dq_tc_kernel<D>
      <<<dim3(batch * hq, (sq + BLOCK - 1) / BLOCK), THREADS, smem_q, stream>>>(
          q, k, v, dout, lse, delta, dq, hq, hkv, sq, skv, window, sl2, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq [batch, hq, sq, d]; k, v, dk, dv [batch, hkv, skv, d]:
// contiguous bfloat16, 16-byte aligned; lse and delta [batch, hq, sq]
// float32 (lse as the forward wrote it; delta is scratch). hq a multiple of
// hkv, d one of 32, 64, 80, 128, 240, window <= 0 for none. Launches three kernels
// on `stream` and returns the cudaError_t of the launches.
extern "C" int flash_attention_bwd_tc_bf16(const void* q, const void* k, const void* v,
                                           const void* o, const void* dout, const void* lse,
                                           void* delta, void* dq, void* dk, void* dv, int batch,
                                           int hq, int hkv, int sq, int skv, int d, int window,
                                           float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  const bf16* O = static_cast<const bf16*>(o);
  const bf16* dO = static_cast<const bf16*>(dout);
  const float* L = static_cast<const float*>(lse);
  float* Dl = static_cast<float*>(delta);
  bf16* dQ = static_cast<bf16*>(dq);
  bf16* dK = static_cast<bf16*>(dk);
  bf16* dV = static_cast<bf16*>(dv);
  switch (d) {
    case 32: return launch<32>(Q, K, V, O, dO, L, Dl, dQ, dK, dV, batch, hq, hkv, sq, skv,
                               window, scale, s);
    case 64: return launch<64>(Q, K, V, O, dO, L, Dl, dQ, dK, dV, batch, hq, hkv, sq, skv,
                               window, scale, s);
    case 80: return launch<80>(Q, K, V, O, dO, L, Dl, dQ, dK, dV, batch, hq, hkv, sq, skv,
                               window, scale, s);
    case 128: return launch<128>(Q, K, V, O, dO, L, Dl, dQ, dK, dV, batch, hq, hkv, sq, skv,
                                 window, scale, s);
    case 240: return launch<240>(Q, K, V, O, dO, L, Dl, dQ, dK, dV, batch, hq, hkv, sq, skv,
                                 window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
