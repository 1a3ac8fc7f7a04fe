// The backward pass of causal (optionally windowed) attention with grouped kv
// heads, for float32 inputs, on the tensor cores, accurate to float32: from q,
// k, v, the forward's output O and row log-sum-exp L, and the output's
// gradient dO, the gradients dQ, dK and dV. The bfloat16 inputs have a kernel
// of their own, flash_attention_bwd_tc.cu, with the same contract: q, O, dO
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
// (src/repro/kernels/flash_attention.py:80, pallas_call at :98) has no VJP;
// the reference trains through its plain jnp attention. This kernel is the
// port's own, so that training on the card runs through a kernel on both
// passes.
//
// Accuracy: the 3-pass TF32 split of csrc/tf32.cuh, as in the f32 forward
// (flash_attention.cu). One TF32 product keeps 11 significant bits of each
// operand, ~100 times the 1e-5 the f32 route is held to. Each operand is
// written as x = hi + lo, both TF32, and each product as
// x_lo y_hi + x_hi y_lo + x_hi y_hi, the two small products first. The
// tensor cores' f32 accumulation is not round-to-nearest, and its error grows
// with what one accumulator takes, so: the two small passes of S and of dP go
// into accumulators of their own, added to the large ones after the last
// k-step; each tile's dV, dK or dQ product goes into a fresh accumulator,
// added to the running sum in f32 (dK and dV sum over up to G q heads x Sq
// rows, dQ over up to Skv keys). The scale and the mask are applied after
// the products, never to a split operand; P = ex2(S * scale * log2 e -
// L * log2 e), one FMA and ex2.approx per score. Every operand, P and dS
// included, keeps tf32.cuh's rule for non-finite values (all of a non-finite
// x goes into lo): the backward has no row sum to carry a NaN of P or dS, so
// a split without the finiteness test, which turns the card's NaN into -0,
// would lose it. D = rowsum(dO * O) is a separate f32 pass on the CUDA cores.
// tests/test_torch_flash_bwd_split.py emulates these sums on the CPU.
//
// What bounds it on the H100: operations. At the training shape (2 x 32 q
// heads, 2048 tokens, D = 80) the five products the gradient needs (S, dP,
// dQ, dK, dV) over the causal pairs are 107.4 GFLOP; three TF32 passes of
// them are 322.2 GFLOP, 0.651 ms at the 495 TFLOP/s TF32 peak (1.60 ms for
// one f32 pass on the CUDA cores' 67 TFLOP/s). This design computes seven
// (S and dP in both kernels, the price of needing no atomics): 0.912 ms at
// the TF32 peak, ~1.41 ms at the 317-320 TFLOP/s that mma.sync TF32 reaches
// with nothing to load (tools/mma_tf32_ceiling.py). ~210 MB of f32 inputs and
// outputs take 0.063 ms at 3.35 TB/s.
//
// What the design does about it (FlashAttention-2's backward on
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, no atomics: each output
// element is written once, by one thread, after sums in a fixed order, so two
// runs give the same bits):
// - Three launches on one stream: the D pass (one warp per row), a dK/dV
//   kernel and a dQ kernel.
// - dK/dV: one block of 8 warps per (batch, kv head, 128 keys); each warp
//   owns 16 keys. The block loops over the group's q heads and over only the
//   tiles of 32 query rows that the causal mask and the window let see its
//   keys. Per tile each warp computes S^T = K Q^T and dP^T = V dO^T, whose C
//   fragments give P^T and dS^T in registers exactly where the A fragments of
//   dV += P^T dO and dK += dS^T Q want them: lane (g, t) holds rows 2t and
//   2t + 1 of each 8, read as mma indices t and t + 4, so the B operands (dO
//   and Q) are read in that row order too. P and dS never touch shared
//   memory; the GQA sum happens in the warp's accumulators.
// - dQ: one block of 8 warps per (batch, q head, 128 rows); each warp owns 16
//   rows, L and D of its rows in registers. The block loops over tiles of 32
//   keys that some of its rows may see: S = Q K^T and dP = dO V^T, then
//   dQ += dS K with dS's A fragment from the C fragment by the same rule.
// - Split once per block, read by every warp. The operands that change from
//   tile to tile (Q and dO in dK/dV; K and V in dQ) arrive raw by 16-byte
//   cp.async (tile j + 1 while tile j is computed), then one pass of the whole
//   block writes them as planes of (hi, hi, lo, lo) pairs: pairs along the
//   head dim for the B operands of S and dP (one row per query or key), pairs
//   along the rows or keys for those of dV, dK and dQ (one row per head-dim
//   column, transposed in that pass). Lane (g, t) of a k-step of 8 reads
//   floats 4t..4t + 3 of plane row g: the two values at mma indices t and
//   t + 4, hi and lo, in one 16-byte load. Rows of 2 * len + 16 floats keep
//   those loads free of bank conflicts. The A operands that stay for the
//   block's life (K and V in dK/dV; Q and dO in dQ) are kept raw in A-fragment
//   lane order, one 16-byte load a k-step, and each warp splits its own: an A
//   fragment serves every n-tile of its k-step.
// - Masks per element only on tiles that cross the diagonal, the window edge,
//   the end of the keys or (dK/dV) the end of the rows; a warp skips a tile
//   none of whose pairs it may see. Rows past Sq and keys past Skv load as
//   zeros with L = D = 0; a row that sees no key (L = -inf, where Sq > Skv)
//   lies only on tiles that cross the diagonal, where its P and dS are set to
//   0 by selection. Blocks are launched longest first (the first key blocks,
//   the last query blocks).
// - Registers: 8 warps a block, one block an SM (shared memory: ~200 KB for
//   dK/dV, ~174 KB for dQ at D = 80), so up to 255 a thread. The dK/dV
//   kernel holds dK and dV (2 x D / 2 a lane), the S^T and dP^T tiles with
//   their small passes (64 at 32 rows), then P and dS as hi and lo A
//   fragments (64) and one fresh accumulator of D columns (D / 2 registers)
//   at a time. D = 128 takes blocks of 4 warps, 16-row dK/dV tiles and fresh
//   accumulators of 64 columns, for shared memory and registers.
// - At D = 80 `-Xptxas -v` reports 255 registers and a 336-byte spill for
//   dK/dV, 196 registers for dQ. At the training shape (NVIDIA H100 80GB
//   HBM3, 700 W; tools/mma_tf32_ceiling.py) the three launches take ~3.2 ms:
//   dK/dV ~1.84 ms and dQ ~1.35 ms, 44 % and 45 % of the ~318 TFLOP/s that
//   mma.sync TF32 reaches with nothing to load. 16-row dK/dV tiles (252
//   registers, no spill) took 3.62 ms there; fresh accumulators of 40 columns
//   (a 192-byte spill) the same 3.2 ms.
// - D = 240 (gemma3-12b: 3840 / 16 heads). What bounds it is the register
//   file, then shared memory. A dK/dV warp holds dK and dV of its 16 keys,
//   240 registers a thread before S^T and dP^T; with D = 128's tiles the
//   dK/dV block needs 310,016 B and the dQ block 389,120 B of shared memory.
//   The dK/dV kernel takes the head dim apart by output
//   (flash_attention_bwd_dkdv_pair_kernel, PairTile<240, 4, 8, 48>): 8 warps
//   on 64 keys, two for each 16. Role 0 computes S^T and P^T and adds P^T dO
//   into dV; role 1 computes dP^T and adds dS^T Q into dK. Each holds one
//   accumulator (120 registers), and the two products of each tile are split
//   between the roles with none computed twice. Role 1 needs P^T: role 0
//   writes it (f32, masked) to shared memory in C-fragment lane order, and
//   one barrier later role 1 reads it at the same positions (the C
//   fragments of S^T and dP^T hold the same pairs). K and V in A order take
//   120 KB of the block's shared memory, so the row tiles are 8 rows (one
//   k-step of dV and dK) and the column planes 16 floats a row, unpadded
//   (pair_ld: 16 is already 16 more than a multiple of 32): 203,136 B. The
//   dQ kernel keeps its layout at 4 warps of 16 rows with 8-key tiles
//   (Tile<240, 4, 8, 8, 48>, 185,600 B). Both take fresh accumulators of 48
//   columns. Each output element gets the same products in the same order
//   as at the other head dims' kernels with these tiles, which
//   tests/test_torch_flash_bwd_split.py emulates at D = 240; no atomics, two
//   runs give the same bits. `-Xptxas -v`: 255 registers for both, spills of
//   88 bytes stored and loaded (dK/dV) and 72 stored, 88 loaded (dQ). Their
//   cost, by tools/sass_spills.py: per tile a dK/dV warp issues 5 spill
//   stores and 11 spill loads beside 180 mma.sync, a dQ warp 6 and 10 beside
//   270. At q [2,16,2048,240] (kv 8 heads) the three launches take
//   9.69-9.71 ms, 9.9x the 0.977 ms of three TF32 passes of the five
//   products at the TF32 peak: 8-row dK/dV and 8-key dQ tiles pay two or
//   three barriers and a split pass every 8 rows or keys (NVIDIA H100 80GB
//   HBM3, 700 W; chip_smoke.py, two runs).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "tf32.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// Rows of a plane of pairs along n tile rows: 2 n floats, padded to 16 more
// than a multiple of 32 so that a quarter warp's 16-byte loads (rows g and
// g + 1, floats 4t..4t + 3) fall in distinct banks.
__host__ __device__ constexpr int pair_ld(int n) {
  return 2 * n + ((2 * n) % 32 == 0 ? 16 : 0);
}

// WARPS warps of 16 keys (dK/dV) or 16 query rows (dQ); BQ query rows a dK/dV
// tile, BKV keys a dQ tile; fresh accumulators of DCH head-dim columns.
template <int D_, int WARPS_, int BQ_, int BKV_, int DCH_>
struct Tile {
  static constexpr bool PAIR = false;          // dK/dV by flash_attention_bwd_dkdv_kernel
  static constexpr int D = D_, WARPS = WARPS_, BQ = BQ_, BKV = BKV_, DCH = DCH_;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BLOCK = 16 * WARPS;     // keys (dK/dV) or rows (dQ) of a block
  static constexpr int KSTEPS = D / 8;         // k-steps of S and dP
  static constexpr int LDW = D + 4;            // raw tile rows
  static constexpr int LDR = 2 * D + 16;       // planes with pairs along the head dim
  static constexpr int LDQ = pair_ld(BQ);      // dK/dV planes with pairs along query rows
  static constexpr int LDK = pair_ld(BKV);     // dQ plane with pairs along keys
  static constexpr int A_FLOATS = BLOCK * D;   // one operand in A-fragment lane order
  // K and V (A order), Q and dO as row and column planes, raw Q and dO, and
  // four [BQ] rows: raw L and D, this tile's L (log2 units) and D.
  static constexpr size_t DKDV_SMEM =
      sizeof(float) * (size_t)(2 * A_FLOATS + 2 * BQ * LDR + 2 * D * LDQ + 2 * BQ * LDW +
                               4 * BQ);
  // Q and dO (A order), K and V as row planes, K as a column plane, raw K and V.
  static constexpr size_t DQ_SMEM =
      sizeof(float) * (size_t)(2 * A_FLOATS + 2 * BKV * LDR + D * LDK + 2 * BKV * LDW);
  static_assert(DKDV_SMEM <= 232448 && DQ_SMEM <= 232448, "shared memory of one block");
  static_assert(BQ % 8 == 0 && BKV % 8 == 0 && D % DCH == 0 && DCH % 8 == 0, "tiles");
};

using T32 = Tile<32, 8, 32, 32, 32>;
using T64 = Tile<64, 8, 32, 32, 64>;
using T80 = Tile<80, 8, 32, 32, 80>;
using T128 = Tile<128, 4, 16, 32, 64>;

// The dK/dV kernel at D = 240 (flash_attention_bwd_dkdv_pair_kernel, the note
// above): GROUPS key groups of 16 keys, two warps each (role 0: S^T, P^T and
// dV; role 1: dP^T, dS^T and dK), BQ query rows a tile, fresh accumulators
// of DCH columns; the smem of Tile's dK/dV kernel and P^T staged in f32.
template <int D_, int GROUPS_, int BQ_, int DCH_>
struct PairTile {
  static constexpr bool PAIR = true;
  static constexpr int D = D_, GROUPS = GROUPS_, BQ = BQ_, DCH = DCH_;
  static constexpr int WARPS = 2 * GROUPS;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BLOCK = 16 * GROUPS;    // keys of a block
  static constexpr int KSTEPS = D / 8;
  static constexpr int LDW = D + 4, LDR = 2 * D + 16, LDQ = pair_ld(BQ);
  static constexpr int A_FLOATS = BLOCK * D;
  static constexpr size_t DKDV_SMEM =
      sizeof(float) * (size_t)(2 * A_FLOATS + 2 * BQ * LDR + 2 * D * LDQ + 2 * BQ * LDW +
                               4 * BQ + BLOCK * BQ);
  static_assert(DKDV_SMEM <= 232448, "shared memory of one block");
  static_assert(BQ % 8 == 0 && D % DCH == 0 && DCH % 8 == 0, "tiles");
};

using T240 = Tile<240, 4, 8, 8, 48>;     // its dQ kernel
using P240 = PairTile<240, 4, 8, 48>;    // its dK/dV kernel

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where !valid (nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

// 4 bytes global -> shared, or 4 zero bytes where !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n)
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

// A pair of elements (x, y) as (hi(x), hi(y), lo(x), lo(y)).
__device__ __forceinline__ float4 split_pair(float x, float y) {
  uint32_t hx, lx, hy, ly;
  split(x, hx, lx);
  split(y, hy, ly);
  return make_float4(__uint_as_float(hx), __uint_as_float(hy), __uint_as_float(lx),
                     __uint_as_float(ly));
}

// One plane load: the (hi, lo) of mma indices t and t + 4 of a B fragment.
__device__ __forceinline__ void frag_b(const float* p, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  hi[0] = __float_as_uint(r.x);
  hi[1] = __float_as_uint(r.y);
  lo[0] = __float_as_uint(r.z);
  lo[1] = __float_as_uint(r.w);
}

// One load of a raw A fragment in lane order, split into hi and lo.
__device__ __forceinline__ void frag_a(const float* p, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  split(r.x, hi[0], lo[0]);
  split(r.y, hi[1], lo[1]);
  split(r.z, hi[2], lo[2]);
  split(r.w, hi[3], lo[3]);
}

// c += a b in three TF32 passes, the small ones first, into one accumulator.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                     const uint32_t (&b_lo)[2]) {
  mma_tf32(c, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(c, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(c, a_hi, b_hi[0], b_hi[1]);
}

// big += a_hi b_hi and small += a_lo b_hi + a_hi b_lo (S and dP).
__device__ __forceinline__ void mma3_apart(float (&big)[4], float (&small)[4],
                                           const uint32_t (&a_hi)[4], const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2], const uint32_t (&b_lo)[2]) {
  mma_tf32(small, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(small, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(big, a_hi, b_hi[0], b_hi[1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
}

// Rows [r0, r0 + BLOCK) of a row-major [nrows, D] array into the A-fragment
// order of the block's warps: element (row 16 w + g + 8 h, column
// 8 kk + 2 t + c) is float h + 2 c of lane 4 g + t in k-step kk of warp w,
// i.e. column 2t at mma index t and 2t + 1 at t + 4. Rows past nrows are 0.
template <class T>
__device__ __forceinline__ void load_a(float* dst, const float* __restrict__ src, int r0,
                                       int nrows) {
  constexpr int PAIRS = T::D / 2;
  for (int i = threadIdx.x; i < T::BLOCK * PAIRS; i += T::THREADS) {
    const int r = i / PAIRS, c = (i - r * PAIRS) * 2;
    float2 x = make_float2(0.0f, 0.0f);
    if (r0 + r < nrows) x = *reinterpret_cast<const float2*>(src + (size_t)(r0 + r) * T::D + c);
    const int w = r >> 4, g = r & 7, h = (r >> 3) & 1, kk = c >> 3, t = (c & 7) >> 1;
    float* e = dst + ((w * T::KSTEPS + kk) * 32 + 4 * g + t) * 4 + h;
    e[0] = x.x;
    e[2] = x.y;
  }
}

// Rows [r0, r0 + ROWS) of a row-major [nrows, D] array into a raw
// [ROWS][D + 4] tile by cp.async; rows at or past nrows are zero-filled.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_raw(float* dst, const float* __restrict__ src, int r0,
                                         int nrows) {
  constexpr int VEC = D / 4;
  for (int i = threadIdx.x; i < ROWS * VEC; i += THREADS) {
    const int r = i / VEC, c = (i - r * VEC) * 4;
    const bool valid = r0 + r < nrows;
    cp_async16(smem_u32(dst + r * (D + 4) + c), src + (size_t)(valid ? r0 + r : 0) * D + c,
               valid);
  }
}

// Entries [r0, r0 + ROWS) of a float32 [nrows] array by cp.async; 0 past nrows.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_vec(float* dst, const float* __restrict__ src, int r0,
                                         int nrows) {
  for (int i = threadIdx.x; i < ROWS; i += THREADS) {
    const bool valid = r0 + i < nrows;
    cp_async4(smem_u32(dst + i), src + (valid ? r0 + i : 0), valid);
  }
}

// A raw [ROWS][D + 4] tile as a plane of one row per tile row, each pair of
// columns (2j, 2j + 1) as (hi, hi, lo, lo) at floats 4j of rows 2D + 16 long:
// the B operand of a product over the head dim.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void row_plane(float* plane, const float* raw) {
  constexpr int VEC = D / 4;
  for (int i = threadIdx.x; i < ROWS * VEC; i += THREADS) {
    const int r = i / VEC, c = (i - r * VEC) * 4;
    const float4 x = *reinterpret_cast<const float4*>(raw + r * (D + 4) + c);
    float4* dst = reinterpret_cast<float4*>(plane + r * (2 * D + 16) + 2 * c);
    dst[0] = split_pair(x.x, x.y);
    dst[1] = split_pair(x.z, x.w);
  }
}

// The same tile as a plane of one row per head-dim column, each pair of tile
// rows (2j, 2j + 1) as (hi, hi, lo, lo) at floats 4j of rows pair_ld(ROWS)
// long: the B operand of a product over the tile's rows.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void col_plane(float* plane, const float* raw) {
  constexpr int VEC = D / 4, HALF = ROWS / 2, LDC = pair_ld(ROWS);
  for (int i = threadIdx.x; i < HALF * VEC; i += THREADS) {
    const int kp = i % HALF, c = (i / HALF) * 4;
    const float4 x = *reinterpret_cast<const float4*>(raw + 2 * kp * (D + 4) + c);
    const float4 y = *reinterpret_cast<const float4*>(raw + (2 * kp + 1) * (D + 4) + c);
    float* dst = plane + c * LDC + 4 * kp;
    *reinterpret_cast<float4*>(dst) = split_pair(x.x, y.x);
    *reinterpret_cast<float4*>(dst + LDC) = split_pair(x.y, y.y);
    *reinterpret_cast<float4*>(dst + 2 * LDC) = split_pair(x.z, y.z);
    *reinterpret_cast<float4*>(dst + 3 * LDC) = split_pair(x.w, y.w);
  }
}

// D = rowsum(dO * O) in f32, one warp per row.
template <int D>
__global__ void __launch_bounds__(256)
flash_attention_bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                                 float* __restrict__ delta, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.0f;
  for (int c = lane; c < D; c += 32)
    acc = fmaf(dout[row * D + c], o[row * D + c], acc);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) delta[row] = acc;
}

template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
flash_attention_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                float* __restrict__ dk, float* __restrict__ dv, int hq, int hkv,
                                int sq, int skv, int window, float scale_log2, float scale) {
  constexpr int D = T::D, BQ = T::BQ, BLOCK = T::BLOCK, THREADS = T::THREADS;
  constexpr int KSTEPS = T::KSTEPS, LDR = T::LDR, LDQ = T::LDQ, LDW = T::LDW;
  constexpr int QN = BQ / 8;        // n-tiles of S^T and dP^T, k-steps of dV and dK
  constexpr int NT = D / 8;         // n-tiles of dK and dV
  constexpr int NC = T::DCH / 8;    // n-tiles of one fresh accumulator
  extern __shared__ __align__(16) float smem[];
  float* KA = smem;                   // [WARPS][KSTEPS][32 lanes][4], raw
  float* VA = KA + T::A_FLOATS;
  float* Qr = VA + T::A_FLOATS;       // [BQ][LDR]: pairs along the head dim
  float* dOr = Qr + BQ * LDR;
  float* Qc = dOr + BQ * LDR;         // [D][LDQ]: pairs along the rows
  float* dOc = Qc + D * LDQ;
  float* Qw = dOc + D * LDQ;          // [BQ][LDW], raw
  float* dOw = Qw + BQ * LDW;
  float* Lw = dOw + BQ * LDW;         // [BQ], raw
  float* Dw = Lw + BQ;
  float* Ls = Dw + BQ;                // [BQ]: this tile's L (log2 units) and D
  float* Ds = Ls + BQ;

  const int b = blockIdx.x / hkv, kvh = blockIdx.x - b * hkv;
  const int k0 = blockIdx.y * BLOCK;   // the first key blocks are seen by the most rows
  const int group = hq / hkv, off = skv - sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;             // fragment row (and row + 8)
  const int t = lane & 3;              // fragment column pair
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

  auto load_q = [&](int it) {
    const int hg = it / n_qt;
    const int q0 = (qt0 + it - hg * n_qt) * BQ;
    const size_t rb = (head0 + hg) * sq;
    load_raw<D, BQ, THREADS>(Qw, q + rb * D, q0, sq);
    load_raw<D, BQ, THREADS>(dOw, dout + rb * D, q0, sq);
    load_vec<BQ, THREADS>(Lw, lse + rb, q0, sq);
    load_vec<BQ, THREADS>(Dw, delta + rb, q0, sq);
    cp_async_commit();
  };

  if (n_it > 0) load_q(0);
  load_a<T>(KA, k + kv_base * D, k0, skv);
  load_a<T>(VA, v + kv_base * D, k0, skv);

  float dka[NT][4], dva[NT][4];
  zero(dka);
  zero(dva);

  const int kw = k0 + warp * 16;       // this warp's first key
  const float* kap = KA + warp * KSTEPS * 128 + lane * 4;
  const float* vap = VA + warp * KSTEPS * 128 + lane * 4;
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait_all();
    __syncthreads();          // raw tile it is in; every warp is done with the planes
    row_plane<D, BQ, THREADS>(Qr, Qw);
    row_plane<D, BQ, THREADS>(dOr, dOw);
    col_plane<D, BQ, THREADS>(Qc, Qw);
    col_plane<D, BQ, THREADS>(dOc, dOw);
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      Ls[i] = Lw[i] * LOG2E;
      Ds[i] = Dw[i];
    }
    __syncthreads();          // the planes are in; the raw tile is free
    if (it + 1 < n_it) load_q(it + 1);

    const int hg = it / n_qt;
    const int q0 = (qt0 + it - hg * n_qt) * BQ;
    const int p_lo = q0 + off;                     // key position of the tile's first row
    const int p_hi = min(q0 + BQ, sq) - 1 + off;   // and of its last
    // A tile none of whose pairs this warp may see costs it nothing.
    if (!(kw < skv && kw <= p_hi && (window <= 0 || kw + 15 > p_lo - window))) continue;

    // S^T = K Q^T and dP^T = V dO^T, [16 keys, BQ rows]: per k-step the A
    // fragments of K and V, split here, and one plane load of Q and of dO
    // per 8 rows; the small passes into s2 and dp2.
    float s[QN][4], s2[QN][4], dp[QN][4], dp2[QN][4];
    zero(s);
    zero(s2);
    zero(dp);
    zero(dp2);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t ka_hi[4], ka_lo[4], va_hi[4], va_lo[4];
      frag_a(kap + kk * 128, ka_hi, ka_lo);
      frag_a(vap + kk * 128, va_hi, va_lo);
#pragma unroll
      for (int n = 0; n < QN; ++n) {
        uint32_t b_hi[2], b_lo[2];
        frag_b(Qr + (n * 8 + g) * LDR + kk * 16 + 4 * t, b_hi, b_lo);
        mma3_apart(s[n], s2[n], ka_hi, ka_lo, b_hi, b_lo);
        frag_b(dOr + (n * 8 + g) * LDR + kk * 16 + 4 * t, b_hi, b_lo);
        mma3_apart(dp[n], dp2[n], va_hi, va_lo, b_hi, b_lo);
      }
    }

    // P^T = exp2(S^T scale log2(e) - L) and dS^T = P^T (dP^T - D), split as
    // the A fragments of the next products: elements 0, 1 of n-tile n are key
    // g and rows n * 8 + 2t, + 1 (2, 3: key g + 8), used as A elements
    // (e >> 1) | ((e & 1) << 1) of k-step n (rows 2t at mma index t, 2t + 1
    // at t + 4). Per-element masks only where the tile crosses this warp's
    // diagonal, its window edge, or the end of the keys or the rows.
    const bool edge = kw + 15 > p_lo || kw + 16 > skv || q0 + BQ > sq ||
                      (window > 0 && kw <= p_hi - window);
    uint32_t pa_hi[QN][4], pa_lo[QN][4], da_hi[QN][4], da_lo[QN][4];
#pragma unroll
    for (int n = 0; n < QN; ++n) {
      const int col = n * 8 + 2 * t;
      const float2 l = *reinterpret_cast<const float2*>(Ls + col);
      const float2 dd = *reinterpret_cast<const float2*>(Ds + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lc = (e & 1) ? l.y : l.x, dc = (e & 1) ? dd.y : dd.x;
        const float sv = s[n][e] + s2[n][e];
        float p = ex2(fmaf(sv, scale_log2, -lc));
        float ds = p * ((dp[n][e] + dp2[n][e]) - dc);
        if (edge) {
          const int key = kw + g + 8 * (e >> 1);
          const int row = q0 + col + (e & 1);
          const int qp = row + off;
          const bool keep =
              row < sq && key < skv && key <= qp && (window <= 0 || key > qp - window);
          if (!keep) p = ds = 0.0f;
        }
        const int a = (e >> 1) | ((e & 1) << 1);
        split(p, pa_hi[n][a], pa_lo[n][a]);
        split(ds, da_hi[n][a], da_lo[n][a]);
      }
    }

    // dV += P^T dO and dK += dS^T Q, DCH columns at a time, each into a fresh
    // accumulator added to dV or dK in f32: per k-step of 8 rows, one plane
    // load of dO or Q per 8 columns.
#pragma unroll
    for (int c0 = 0; c0 < NT; c0 += NC) {
      float acc[NC][4];
      zero(acc);
#pragma unroll
      for (int kk = 0; kk < QN; ++kk)
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          uint32_t b_hi[2], b_lo[2];
          frag_b(dOc + ((c0 + j) * 8 + g) * LDQ + kk * 16 + 4 * t, b_hi, b_lo);
          mma3(acc[j], pa_hi[kk], pa_lo[kk], b_hi, b_lo);
        }
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dva[c0 + j][e] += acc[j][e];
      zero(acc);
#pragma unroll
      for (int kk = 0; kk < QN; ++kk)
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          uint32_t b_hi[2], b_lo[2];
          frag_b(Qc + ((c0 + j) * 8 + g) * LDQ + kk * 16 + 4 * t, b_hi, b_lo);
          mma3(acc[j], da_hi[kk], da_lo[kk], b_hi, b_lo);
        }
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[c0 + j][e] += acc[j][e];
    }
  }

  // dK (scaled) and dV of keys kw + g and kw + g + 8, columns n * 8 + 2t.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw + g + 8 * r;
    if (key >= skv) continue;
    float* dkr = dk + (kv_base + key) * D;
    float* dvr = dv + (kv_base + key) * D;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<float2*>(dkr + n * 8 + 2 * t) =
          make_float2(dka[n][2 * r] * scale, dka[n][2 * r + 1] * scale);
      *reinterpret_cast<float2*>(dvr + n * 8 + 2 * t) = make_float2(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

// The dK/dV kernel at D = 240 (PairTile, the note above): warp w is role
// w / GROUPS of key group w % GROUPS and holds one accumulator, dV (role 0)
// or dK (role 1), of its 16 keys x D. Role 0 computes S^T and P^T, stages
// P^T (f32, masked) in shared memory in C-fragment lane order, and adds
// P^T dO to dV; role 1 computes dP^T, reads P^T at the same lane positions
// (the C fragments of S^T and dP^T hold the same pairs), forms dS^T and adds
// dS^T Q to dK. The products, splits and sums of each output element are
// those of flash_attention_bwd_dkdv_kernel at the same tiles.
template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
flash_attention_bwd_dkdv_pair_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                     const float* __restrict__ v, const float* __restrict__ dout,
                                     const float* __restrict__ lse,
                                     const float* __restrict__ delta, float* __restrict__ dk,
                                     float* __restrict__ dv, int hq, int hkv, int sq, int skv,
                                     int window, float scale_log2, float scale) {
  constexpr int D = T::D, BQ = T::BQ, BLOCK = T::BLOCK, THREADS = T::THREADS;
  constexpr int KSTEPS = T::KSTEPS, LDR = T::LDR, LDQ = T::LDQ, LDW = T::LDW;
  constexpr int QN = BQ / 8;        // n-tiles of S^T and dP^T, k-steps of dV and dK
  constexpr int NT = D / 8;         // n-tiles of dK or dV
  constexpr int NC = T::DCH / 8;    // n-tiles of one fresh accumulator
  extern __shared__ __align__(16) float smem[];
  float* KA = smem;                   // [GROUPS][KSTEPS][32 lanes][4], raw
  float* VA = KA + T::A_FLOATS;
  float* Qr = VA + T::A_FLOATS;       // [BQ][LDR]: pairs along the head dim
  float* dOr = Qr + BQ * LDR;
  float* Qc = dOr + BQ * LDR;         // [D][LDQ]: pairs along the rows
  float* dOc = Qc + D * LDQ;
  float* Qw = dOc + D * LDQ;          // [BQ][LDW], raw
  float* dOw = Qw + BQ * LDW;
  float* Lw = dOw + BQ * LDW;         // [BQ], raw
  float* Dw = Lw + BQ;
  float* Ls = Dw + BQ;                // [BQ]: this tile's L (log2 units) and D
  float* Ds = Ls + BQ;
  float* Ps = Ds + BQ;                // [GROUPS][QN][32 lanes][4]: P^T, f32

  const int b = blockIdx.x / hkv, kvh = blockIdx.x - b * hkv;
  const int k0 = blockIdx.y * BLOCK;   // the first key blocks are seen by the most rows
  const int group = hq / hkv, off = skv - sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kg = warp % T::GROUPS;     // this warp's 16 keys
  const int role = warp / T::GROUPS;   // 0: P^T and dV, 1: dS^T and dK
  const int g = lane >> 2;             // fragment row (and row + 8)
  const int t = lane & 3;              // fragment column pair
  const size_t kv_base = ((size_t)b * hkv + kvh) * skv;
  const size_t head0 = (size_t)b * hq + (size_t)kvh * group;   // the group's first q head

  const int k_last = min(k0 + BLOCK, skv) - 1;
  const int i_lo = max(0, k0 - off);
  const int i_hi = window > 0 ? (int)min((long long)sq - 1, (long long)k_last + window - 1 - off)
                              : sq - 1;
  const int qt0 = i_lo / BQ;
  const int n_qt = i_hi >= i_lo ? i_hi / BQ - qt0 + 1 : 0;
  const int n_it = group * n_qt;

  auto load_q = [&](int it) {
    const int hg = it / n_qt;
    const int q0 = (qt0 + it - hg * n_qt) * BQ;
    const size_t rb = (head0 + hg) * sq;
    load_raw<D, BQ, THREADS>(Qw, q + rb * D, q0, sq);
    load_raw<D, BQ, THREADS>(dOw, dout + rb * D, q0, sq);
    load_vec<BQ, THREADS>(Lw, lse + rb, q0, sq);
    load_vec<BQ, THREADS>(Dw, delta + rb, q0, sq);
    cp_async_commit();
  };

  if (n_it > 0) load_q(0);
  load_a<T>(KA, k + kv_base * D, k0, skv);
  load_a<T>(VA, v + kv_base * D, k0, skv);

  float acc[NT][4];                    // dV (role 0) or dK (role 1)
  zero(acc);

  const int kw = k0 + kg * 16;         // this warp's first key
  const float* ap = (role == 0 ? KA : VA) + kg * KSTEPS * 128 + lane * 4;   // A of S^T, dP^T
  const float* br = role == 0 ? Qr : dOr;     // B of S^T or dP^T
  const float* bc = role == 0 ? dOc : Qc;     // B of dV or dK
  float* ps = Ps + (kg * QN * 32 + lane) * 4;
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait_all();
    __syncthreads();          // raw tile it is in; every warp is done with the planes
    row_plane<D, BQ, THREADS>(Qr, Qw);
    row_plane<D, BQ, THREADS>(dOr, dOw);
    col_plane<D, BQ, THREADS>(Qc, Qw);
    col_plane<D, BQ, THREADS>(dOc, dOw);
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      Ls[i] = Lw[i] * LOG2E;
      Ds[i] = Dw[i];
    }
    __syncthreads();          // the planes are in; the raw tile is free
    if (it + 1 < n_it) load_q(it + 1);

    const int hg = it / n_qt;
    const int q0 = (qt0 + it - hg * n_qt) * BQ;
    const int p_lo = q0 + off;                     // key position of the tile's first row
    const int p_hi = min(q0 + BQ, sq) - 1 + off;   // and of its last
    // A tile none of whose pairs this key group may see costs its warps nothing.
    const bool seen = kw < skv && kw <= p_hi && (window <= 0 || kw + 15 > p_lo - window);
    const bool edge = kw + 15 > p_lo || kw + 16 > skv || q0 + BQ > sq ||
                      (window > 0 && kw <= p_hi - window);
    auto keep = [&](int n, int e) {
      const int key = kw + g + 8 * (e >> 1);
      const int row = q0 + n * 8 + 2 * t + (e & 1);
      const int qp = row + off;
      return row < sq && key < skv && key <= qp && (window <= 0 || key > qp - window);
    };

    // S^T = K Q^T (role 0) or dP^T = V dO^T (role 1), [16 keys, BQ rows]: the
    // small passes into x2. Role 0 then forms P^T, masked, keeps it in x and
    // stages it.
    float x[QN][4], x2[QN][4];
    if (seen) {
      zero(x);
      zero(x2);
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t a_hi[4], a_lo[4];
        frag_a(ap + kk * 128, a_hi, a_lo);
#pragma unroll
        for (int n = 0; n < QN; ++n) {
          uint32_t b_hi[2], b_lo[2];
          frag_b(br + (n * 8 + g) * LDR + kk * 16 + 4 * t, b_hi, b_lo);
          mma3_apart(x[n], x2[n], a_hi, a_lo, b_hi, b_lo);
        }
      }
      if (role == 0) {
#pragma unroll
        for (int n = 0; n < QN; ++n) {
          const float2 l = *reinterpret_cast<const float2*>(Ls + n * 8 + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lc = (e & 1) ? l.y : l.x;
            float p = ex2(fmaf(x[n][e] + x2[n][e], scale_log2, -lc));
            if (edge && !keep(n, e)) p = 0.0f;
            x[n][e] = p;
          }
          *reinterpret_cast<float4*>(ps + n * 128) = make_float4(x[n][0], x[n][1], x[n][2],
                                                                 x[n][3]);
        }
      }
    }
    __syncthreads();          // P^T of every key group is in

    if (seen) {
      // P^T (role 0) or dS^T = P^T (dP^T - D) (role 1, masked), split as the A
      // fragments of the next product: element e of n-tile n is used as A
      // element (e >> 1) | ((e & 1) << 1) of k-step n.
      uint32_t a_hi[QN][4], a_lo[QN][4];
#pragma unroll
      for (int n = 0; n < QN; ++n) {
        float y[4];
        if (role == 0) {
#pragma unroll
          for (int e = 0; e < 4; ++e) y[e] = x[n][e];
        } else {
          const float4 p = *reinterpret_cast<const float4*>(ps + n * 128);
          const float2 dd = *reinterpret_cast<const float2*>(Ds + n * 8 + 2 * t);
          const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float dc = (e & 1) ? dd.y : dd.x;
            y[e] = pv[e] * ((x[n][e] + x2[n][e]) - dc);
            if (edge && !keep(n, e)) y[e] = 0.0f;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int a = (e >> 1) | ((e & 1) << 1);
          split(y[e], a_hi[n][a], a_lo[n][a]);
        }
      }

      // dV += P^T dO (role 0) or dK += dS^T Q (role 1), DCH columns at a time,
      // each into a fresh accumulator added in f32.
#pragma unroll
      for (int c0 = 0; c0 < NT; c0 += NC) {
        float f[NC][4];
        zero(f);
#pragma unroll
        for (int kk = 0; kk < QN; ++kk)
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            uint32_t b_hi[2], b_lo[2];
            frag_b(bc + ((c0 + j) * 8 + g) * LDQ + kk * 16 + 4 * t, b_hi, b_lo);
            mma3(f[j], a_hi[kk], a_lo[kk], b_hi, b_lo);
          }
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[c0 + j][e] += f[j][e];
      }
    }
  }

  // dV (role 0) or dK, scaled (role 1), of keys kw + g and kw + g + 8.
  const float mult = role == 0 ? 1.0f : scale;
  float* outp = role == 0 ? dv : dk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw + g + 8 * r;
    if (key >= skv) continue;
    float* row = outp + (kv_base + key) * D;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(row + n * 8 + 2 * t) =
          make_float2(acc[n][2 * r] * mult, acc[n][2 * r + 1] * mult);
  }
}

template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
flash_attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ dq, int hq, int hkv, int sq, int skv,
                              int window, float scale_log2, float scale) {
  constexpr int D = T::D, BKV = T::BKV, BLOCK = T::BLOCK, THREADS = T::THREADS;
  constexpr int KSTEPS = T::KSTEPS, LDR = T::LDR, LDK = T::LDK, LDW = T::LDW;
  constexpr int KN = BKV / 8;       // n-tiles of S and dP, k-steps of dQ
  constexpr int NT = D / 8;         // n-tiles of dQ
  constexpr int NC = T::DCH / 8;    // n-tiles of one fresh accumulator
  extern __shared__ __align__(16) float smem[];
  float* QA = smem;                   // [WARPS][KSTEPS][32 lanes][4], raw
  float* OA = QA + T::A_FLOATS;
  float* Kr = OA + T::A_FLOATS;       // [BKV][LDR]: pairs along the head dim
  float* Vr = Kr + BKV * LDR;
  float* Kc = Vr + BKV * LDR;         // [D][LDK]: pairs along the keys
  float* Kw = Kc + D * LDK;           // [BKV][LDW], raw
  float* Vw = Kw + BKV * LDW;

  const int bh = blockIdx.x;                             // b * hq + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK;   // longest rows first
  const int b = bh / hq;
  const int kvh = (bh - b * hq) / (hq / hkv);
  const size_t row_base = (size_t)bh * sq;
  const float* K = k + ((size_t)b * hkv + kvh) * skv * D;
  const float* V = v + ((size_t)b * hkv + kvh) * skv * D;
  const int off = skv - sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // Keys some row of the block may see: from the window start of its first
  // row to the diagonal of its last.
  const int k_hi = min(skv, min(q0 + BLOCK, sq) + off) - 1;
  const int k_lo = window > 0 ? max(0, q0 + off - window + 1) : 0;
  const int kb0 = (k_lo / BKV) * BKV;
  const int n_tiles = k_hi >= kb0 ? (k_hi - kb0) / BKV + 1 : 0;

  auto load_kv = [&](int kb) {
    load_raw<D, BKV, THREADS>(Kw, K, kb, skv);
    load_raw<D, BKV, THREADS>(Vw, V, kb, skv);
    cp_async_commit();
  };

  if (n_tiles > 0) load_kv(kb0);
  load_a<T>(QA, q + row_base * D, q0, sq);
  load_a<T>(OA, dout + row_base * D, q0, sq);

  // L (log2 units) and D of rows g and g + 8; 0 past sq.
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    lr[r] = row < sq ? lse[row_base + row] * LOG2E : 0.0f;
    dr[r] = row < sq ? delta[row_base + row] : 0.0f;
  }

  float dqa[NT][4];
  zero(dqa);

  const int qpos0 = q0 + warp * 16 + off;   // key position of this warp's first row
  const bool rows_in = q0 + warp * 16 < sq;
  const float* qap = QA + warp * KSTEPS * 128 + lane * 4;
  const float* oap = OA + warp * KSTEPS * 128 + lane * 4;
  for (int j = 0; j < n_tiles; ++j) {
    const int kb = kb0 + j * BKV;
    cp_async_wait_all();
    __syncthreads();          // raw tile j is in; every warp is done with the planes
    row_plane<D, BKV, THREADS>(Kr, Kw);
    row_plane<D, BKV, THREADS>(Vr, Vw);
    col_plane<D, BKV, THREADS>(Kc, Kw);
    __syncthreads();          // the planes are in; the raw tile is free
    if (j + 1 < n_tiles) load_kv(kb + BKV);

    // A tile no row of this warp may see costs the warp nothing.
    if (!(rows_in && kb <= qpos0 + 15 && (window <= 0 || kb + BKV - 1 > qpos0 - window)))
      continue;

    // S = Q K^T and dP = dO V^T, [16 rows, BKV keys]: per k-step the A
    // fragments of Q and dO, split here, and one plane load of K and of V per
    // 8 keys; the small passes into s2 and dp2.
    float s[KN][4], s2[KN][4], dp[KN][4], dp2[KN][4];
    zero(s);
    zero(s2);
    zero(dp);
    zero(dp2);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qa_hi[4], qa_lo[4], oa_hi[4], oa_lo[4];
      frag_a(qap + kk * 128, qa_hi, qa_lo);
      frag_a(oap + kk * 128, oa_hi, oa_lo);
#pragma unroll
      for (int n = 0; n < KN; ++n) {
        uint32_t b_hi[2], b_lo[2];
        frag_b(Kr + (n * 8 + g) * LDR + kk * 16 + 4 * t, b_hi, b_lo);
        mma3_apart(s[n], s2[n], qa_hi, qa_lo, b_hi, b_lo);
        frag_b(Vr + (n * 8 + g) * LDR + kk * 16 + 4 * t, b_hi, b_lo);
        mma3_apart(dp[n], dp2[n], oa_hi, oa_lo, b_hi, b_lo);
      }
    }

    // dS = P (dP - D) with P = exp2(S scale log2(e) - L), split as the A
    // fragments of dS K (keys 2t at mma index t, 2t + 1 at t + 4); per-element
    // masks only where the tile crosses this warp's diagonal, its window edge
    // or the end of the keys.
    const bool edge = kb + BKV - 1 > qpos0 || kb + BKV > skv ||
                      (window > 0 && kb <= qpos0 + 15 - window);
    uint32_t d_hi[KN][4], d_lo[KN][4];
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sv = s[n][e] + s2[n][e];
        const float p = ex2(fmaf(sv, scale_log2, -lr[e >> 1]));
        float ds = p * ((dp[n][e] + dp2[n][e]) - dr[e >> 1]);
        if (edge) {
          const int key = kb + n * 8 + 2 * t + (e & 1);
          const int qp = qpos0 + g + 8 * (e >> 1);
          const bool keep = key <= qp && key < skv && (window <= 0 || key > qp - window);
          if (!keep) ds = 0.0f;
        }
        const int a = (e >> 1) | ((e & 1) << 1);
        split(ds, d_hi[n][a], d_lo[n][a]);
      }

    // dQ += dS K, DCH columns at a time, each into a fresh accumulator added
    // to dQ in f32: per k-step of 8 keys, one plane load of K per 8 columns.
#pragma unroll
    for (int c0 = 0; c0 < NT; c0 += NC) {
      float acc[NC][4];
      zero(acc);
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
#pragma unroll
        for (int jn = 0; jn < NC; ++jn) {
          uint32_t b_hi[2], b_lo[2];
          frag_b(Kc + ((c0 + jn) * 8 + g) * LDK + kk * 16 + 4 * t, b_hi, b_lo);
          mma3(acc[jn], d_hi[kk], d_lo[kk], b_hi, b_lo);
        }
#pragma unroll
      for (int jn = 0; jn < NC; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) dqa[c0 + jn][e] += acc[jn][e];
    }
  }

  // dQ (scaled) of rows g and g + 8, columns n * 8 + 2t.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= sq) continue;
    float* out = dq + (row_base + row) * D;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(out + n * 8 + 2 * t) =
          make_float2(dqa[n][2 * r] * scale, dqa[n][2 * r + 1] * scale);
  }
}

// T: the tile of the dQ kernel; K: that of the dK/dV kernel (a PairTile
// takes flash_attention_bwd_dkdv_pair_kernel).
template <class T, class K = T>
int launch(const float* q, const float* k, const float* v, const float* o, const float* dout,
           const float* lse, float* delta, float* dq, float* dk, float* dv, int batch, int hq,
           int hkv, int sq, int skv, int window, float scale, cudaStream_t stream) {
  void (*dkdv)(const float*, const float*, const float*, const float*, const float*,
               const float*, float*, float*, int, int, int, int, int, float, float);
  if constexpr (K::PAIR)
    dkdv = flash_attention_bwd_dkdv_pair_kernel<K>;
  else
    dkdv = flash_attention_bwd_dkdv_kernel<K>;
  cudaError_t e =
      cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::DKDV_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::DQ_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rows = (long long)batch * hq * sq;
  flash_attention_bwd_delta_kernel<T::D>
      <<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(o, dout, delta, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const float sl2 = scale * LOG2E;
  dkdv<<<dim3(batch * hkv, (skv + K::BLOCK - 1) / K::BLOCK), K::THREADS, K::DKDV_SMEM,
         stream>>>(q, k, v, dout, lse, delta, dk, dv, hq, hkv, sq, skv, window, sl2, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_attention_bwd_dq_kernel<T>
      <<<dim3(batch * hq, (sq + T::BLOCK - 1) / T::BLOCK), T::THREADS, T::DQ_SMEM, stream>>>(
          q, k, v, dout, lse, delta, dq, hq, hkv, sq, skv, window, sl2, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq [batch, hq, sq, d]; k, v, dk, dv [batch, hkv, skv, d]: contiguous
// float32, 16-byte aligned; lse and delta [batch, hq, sq] float32 (lse as the
// forward wrote it; delta is scratch). hq a multiple of hkv, d one of 32, 64,
// 80, 128, 240, window <= 0 for none. Launches three kernels on `stream` and
// returns the cudaError_t of the launches.
extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                                       const void* dout, const void* lse, void* delta, void* dq,
                                       void* dk, void* dv, int batch, int hq, int hkv, int sq,
                                       int skv, int d, int window, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Q = static_cast<const float*>(q);
  const float* K = static_cast<const float*>(k);
  const float* V = static_cast<const float*>(v);
  const float* O = static_cast<const float*>(o);
  const float* dO = static_cast<const float*>(dout);
  const float* L = static_cast<const float*>(lse);
  float* Dl = static_cast<float*>(delta);
  float* dQ = static_cast<float*>(dq);
  float* dK = static_cast<float*>(dk);
  float* dV = static_cast<float*>(dv);
  switch (d) {
    case 32: return launch<T32>(Q, K, V, O, dO, L, Dl, dQ, dK, dV, batch, hq, hkv, sq, skv,
                                window, scale, s);
    case 64: return launch<T64>(Q, K, V, O, dO, L, Dl, dQ, dK, dV, batch, hq, hkv, sq, skv,
                                window, scale, s);
    case 80: return launch<T80>(Q, K, V, O, dO, L, Dl, dQ, dK, dV, batch, hq, hkv, sq, skv,
                                window, scale, s);
    case 128: return launch<T128>(Q, K, V, O, dO, L, Dl, dQ, dK, dV, batch, hq, hkv, sq, skv,
                                  window, scale, s);
    case 240: return launch<T240, P240>(Q, K, V, O, dO, L, Dl, dQ, dK, dV, batch, hq, hkv, sq,
                                        skv, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
