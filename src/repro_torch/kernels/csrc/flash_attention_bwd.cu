// The backward pass of causal (optionally windowed) attention with grouped kv
// heads, for float32 inputs, on Hopper's tensor cores, accurate to float32:
// from q, k, v, the forward's output O and row log-sum-exp L, and the
// output's gradient dO, the gradients dQ, dK and dV. The bfloat16 inputs
// have a kernel of their own, flash_attention_bwd_tc.cu, with the same
// contract: q, O, dO [B, Hq, Sq, D] and k, v [B, Hkv, Skv, D] with Hq a
// multiple of Hkv, q head h reading kv head h / (Hq / Hkv); query i sits at
// key position i + Skv - Sq and sees the keys at positions <= its own, and
// with a window only those > its own minus the window. With S = Q K^T *
// scale over the keys a row sees:
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
// written as x = hi + lo, both TF32 (rounded to nearest, ties away), and
// each product as x_lo y_hi + x_hi y_lo + x_hi y_hi, the two small products
// first. The tensor cores' f32 accumulation is not round-to-nearest, and its
// error grows with what one accumulator takes, so: the two small passes of
// S and of dP go into accumulators of their own, added to the large ones
// after the last k-step; each tile's dV, dK or dQ product goes into a fresh
// accumulator of DCH columns, added to the running sum in f32. The scale and
// the mask are applied after the products, never to a split operand;
// P = ex2(S * scale * log2 e - L * log2 e), one FMA and ex2.approx per
// score. Every operand, P and dS included, keeps tf32.cuh's rule for
// non-finite values (all of a non-finite x goes into lo): the backward has
// no row sum to carry a NaN of P or dS, so a split without the finiteness
// test, which turns the card's NaN into -0, would lose it.
// tests/test_torch_flash_bwd_split.py and
// tests/test_torch_flash_bwd_f32_wgmma.py emulate these sums on the CPU.
//
// What bounds it on the H100: operations. At the training shape (2 x 32 q
// heads, 2048 tokens, D = 80) the five products the gradient needs (S, dP,
// dQ, dK, dV) over the causal pairs are 107.4 GFLOP; three TF32 passes of
// them are 322.2 GFLOP, 0.651 ms at the 495 TFLOP/s TF32 peak, which only
// wgmma reaches. This layout computes seven (S and dP in both kernels, the
// price of needing no atomics): 0.912 ms at that peak. At gemma3-12b's
// global layers (q [2,16,2048,240], 8 kv heads) the five take 0.977 ms and
// the seven 1.367 ms. ~210 MB (D = 80) of f32 inputs and outputs take
// 0.063 ms at 3.35 TB/s.
//
// What the card allows and what the design does about it:
// - TF32 wgmma (m64nNk8) takes B, and A from shared memory, only K-major:
//   the transpose flags exist for 16-bit types alone. S^T = K Q^T,
//   dP^T = V dO^T, S = Q K^T and dP = dO V^T have both operands K-major as
//   stored; dV += P^T dO, dK += dS^T Q and dQ += dS K contract over rows or
//   keys, so their B (dO, Q, K) must be transposed, [D, rows].
// - Three passes need B as two planes, hi and lo. So a pre-pass
//   (tf32_split_kernel of tf32.cuh, one launch) writes, from q, dO, k and
//   v, the planes the two kernels stream: hi and lo of each in its own
//   layout ("natural"), and hi and lo of Q, dO and K transposed, [D, S8]
//   with S8 = S rounded up to 8 and zeros past S, each group of 8 positions
//   holding rows 0, 2, 4, 6, 1, 3, 5, 7 of its group. That order lets an
//   accumulator's C fragment serve as the next product's A fragment with no
//   shuffle: lane (g, t) holds columns 2t and 2t + 1 of each 8, used as mma
//   indices t and t + 4. The planes live in the scratch array the wrapper
//   allocates (flash_attention_bwd_f32_scratch). TMA lands them ready.
// - The operand each block keeps (K or V in dK/dV; Q or dO in dQ) stays raw
//   in shared memory: hi and lo planes of it would double its 64 KB at
//   D = 240. Its hi and lo A fragments are split into registers once a block
//   and held there where they fit (HOLD, D <= 80: D registers a thread), or
//   split at use, KCH k-steps at a time (D = 128 and 240). The other A
//   operands (P^T, dS^T, dS) are split from the accumulators in registers.
// - Shared memory. The 128-byte swizzle box is 32 f32 wide, so D = 80 takes
//   3 boxes (96 f32) and D = 240 takes 8 (256). Per 64 rows one f32 plane
//   is 24,576 B at D = 80 and 65,536 B at D = 240, so K and V as hi and lo
//   take 262,144 B at D = 240, more than a block's 232,448, and even raw
//   (131,072 B) they leave room for only 8-row tiles of Q, dO and their
//   transposes. So each block is a cluster of two CTAs split by output,
//   each with the shared memory of one SM: in dK/dV, CTA 0 holds K, streams
//   Q (natural) and dO (transposed), computes S^T and P^T and owns dV; CTA 1
//   holds V, streams dO (natural) and Q (transposed), computes dP^T and owns
//   dK. P^T passes from CTA 0 to CTA 1 through distributed shared memory
//   (st.shared::cluster into an inbox of PBUF buffers a consumer, mbarriers
//   across the pair both ways), so no product is computed twice. In dQ,
//   CTA 0 holds Q, streams K and computes S and P; CTA 1 holds dO, streams
//   V and K (transposed), computes dP, forms dS from the P it receives and
//   owns dQ. A CTA at D = 240 holds 64 KB of K or V and two stages of 62 KB
//   (16-row tiles: Q or dO natural, hi and lo, [16, 256] and dO or Q
//   transposed, [240, 16] in boxes of 16 f32 with the 64-byte swizzle), at
//   D = 80 24 KB and three stages of 44 KB (32-row tiles).
// - Each CTA: a producer warpgroup (setmaxnreg 24) whose warp 0 issues the
//   TMA loads (lane 0) and, in dK/dV, writes each tile's rows of L log2 e
//   (CTA 0) or D (CTA 1) into shared memory beside it; two consumer
//   warpgroups (setmaxnreg 240) of the block's 64 keys or q rows, taking its
//   tiles in turn, each summing its own tiles, the first adding the
//   second's sums to its own at the end (through the stages), so one's
//   exponentials and splits overlap the other's products. Every product is
//   a TF32 wgmma with A in registers (wgmma_tf32).
// - Tiles (F32Tiling<D>): BT q rows a dK/dV tile and keys a dQ tile, STAGES
//   stages of the ring, DCH columns a fresh accumulator, HOLD.
// - Masks per element only on tiles that cross the diagonal, the window edge,
//   or the end of the keys or (dK/dV) the rows. Rows past Sq and keys past
//   Skv load as zeros (TMA's zero fill and the pre-pass's zeros) with
//   L = D = 0; a row that sees no key (L = -inf, where Sq > Skv) lies only on
//   tiles that cross the diagonal, where its P and dS are set to 0 by
//   selection.
// - Order: one cluster a block, launched in the order of kv_block_at (key
//   blocks first to last, the first seen by the most rows) and q_block_at
//   (q blocks last to first). No atomics: each output element is written
//   once, by one thread, after sums in a fixed order, so two runs give the
//   same bits.
//
// Registers and times. `-Xptxas -v` reports 168 registers (the launch
// bound) for every instance; in the SASS the consumers reach R195 (dK/dV)
// and R205 (dQ) at D = 80, R237 at D = 240. Spills: dK/dV and dQ at D = 240
// 360 / 444 and 428 / 524 bytes stored / loaded, dK/dV 24-36 / 24-52 bytes
// at the other head dims, dQ none. At the training shapes (NVIDIA H100 80GB
// HBM3, 700.00 W; tools/flash_bwd_turns.py --dtype float32, device time of
// a call in turns with the mma.sync kernels this file held before):
// Qwen3-4B q [2,32,2048,80] 2.893-2.912 ms against 3.108-3.110 (pre-pass
// 0.183, D pass 0.036, dK/dV 1.426 at 37 % of the TF32 peak over its four
// three-pass products, dQ 1.270 at 31 % over three), 3.2x the seven-product
// bound; gemma3-12b q [2,16,2048,240] global 6.285-6.315 against
// 9.539-9.611 and SDPA's f32 backward 6.413, window 1024 5.037-5.058
// against 7.444-7.446; OLMoE [2,16,2048,128] 2.799-2.838 against
// 4.167-4.171; Hymba [2,25,2048,64] window 1024 1.647-1.667 against
// 1.646-1.665; Whisper [8,16,448,64] 0.566-0.567 against 0.351-0.353 (short
// blocks of few tiles: the pre-pass is 0.094 ms of it, and one cluster a
// block pays its set-up every 64 keys). Built and measured slower there
// (PERF.md): one consumer a CTA (1.06-1.38x), the resident operand split at
// use at D = 80 (1.09x), two stages at D = 80 (1.26x), four stages with one
// inbox buffer (1.07x), 16-row tiles at D = 80 (1.43x), two k-steps a split
// at D = 240 (1.01x), dQ's columns split between the two CTAs with dS sent
// back (1.26x at D = 80, 1.01x at 240). Not built: persistent CTAs (a work
// counter would have to hand each block to both CTAs of a cluster), the D
// pass folded into the pre-pass, S and dP shared between the kernels.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int ROWS = 64;        // keys (dK/dV) or q rows (dQ) of a block
constexpr int CONSUMERS = 2;    // consumer warpgroups, taking a block's tiles in turn
constexpr int THREADS = 128 * (1 + CONSUMERS);   // and a producer warpgroup
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int BOX = 32;         // f32 columns of one 128-byte swizzled box
constexpr int PBUF = 2;         // inbox buffers of P a consumer
constexpr int KCH = 4;          // k-steps of a resident operand split at a time (HOLD 0)

// Per head dim: BT q rows a dK/dV tile and keys a dQ tile, STAGES stages of
// the ring, DCH columns of one fresh accumulator of dV, dK or dQ, and the
// resident operand's A fragments: HOLD 1 splits them once a block and keeps
// them in registers (D of them a thread), HOLD 0 splits them at use, KCH
// k-steps at a time.
template <int D> struct F32Tiling;
template <> struct F32Tiling<32> {
  static constexpr int BT = 32, STAGES = 4, DCH = 32, HOLD = 1;
};
template <> struct F32Tiling<64> {
  static constexpr int BT = 32, STAGES = 4, DCH = 64, HOLD = 1;
};
template <> struct F32Tiling<80> {
  static constexpr int BT = 32, STAGES = 3, DCH = 80, HOLD = 1;
};
template <> struct F32Tiling<128> {
  static constexpr int BT = 32, STAGES = 2, DCH = 64, HOLD = 0;
};
template <> struct F32Tiling<240> {
  static constexpr int BT = 16, STAGES = 2, DCH = 48, HOLD = 0;
};

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__host__ __device__ constexpr uint32_t align_up(uint32_t x, uint32_t a) {
  return (x + a - 1) / a * a;
}

// Shared memory of either CTA of a cluster, in either kernel: the resident
// raw tile [BOXES][64][32] (K or V; Q or dO), STAGES stages each of a
// natural plane pair (hi, lo) [BOXES][BT][32] and a transposed plane pair
// (hi, lo) [TBOXES][D][TW], STAGES rows of L log2 e or D (dK/dV), PBUF
// inbox tiles of P per consumer warpgroup (f32, [BT / 8][128 threads]
// float4, written by the other CTA), then the barriers. At the end the
// stages hold consumer 1's partial sums for consumer 0 ([D / 2][128] f32).
template <int D>
struct F32Layout {
  static constexpr int BT = F32Tiling<D>::BT, STAGES = F32Tiling<D>::STAGES;
  static constexpr int DCH = F32Tiling<D>::DCH;
  static constexpr bool HOLD = F32Tiling<D>::HOLD;
  static constexpr int HELD = HOLD ? D / 8 : 1;   // k-steps of A fragments held
  static constexpr int BOXES = (D + BOX - 1) / BOX;
  static constexpr int TW = BT < BOX ? BT : BOX;   // f32 a transposed box row
  static constexpr int TSWIZZLE = 4 * TW;          // its swizzle, 64 or 128 bytes
  static constexpr int TBOXES = BT / TW;
  static constexpr uint32_t RES_BOX = ROWS * 128, RES_BYTES = BOXES * RES_BOX;
  static constexpr uint32_t N_BOX = BT * 128, N_BYTES = BOXES * N_BOX;
  static constexpr uint32_t T_BOX = D * TW * 4, T_BYTES = TBOXES * T_BOX;
  static constexpr uint32_t STAGE = 2 * N_BYTES + 2 * T_BYTES;
  static constexpr uint32_t RES_AT = 0, STAGE_AT = RES_BYTES;
  static constexpr uint32_t NH = 0, NL = N_BYTES, TH = 2 * N_BYTES, TL = TH + T_BYTES;
  static constexpr uint32_t VEC_AT = STAGE_AT + STAGES * STAGE;
  static constexpr uint32_t INBOX_TILE = ROWS * BT * 4;
  static constexpr uint32_t INBOX_AT = align_up(VEC_AT + STAGES * BT * 4, 16);
  static constexpr uint32_t BAR_AT = INBOX_AT + PBUF * CONSUMERS * INBOX_TILE;
  // Barriers: the resident tile full, per stage full and empty, per inbox
  // tile (consumer c's buffer b at PBUF c + b) full (the other CTA wrote it)
  // and empty (the other CTA read it).
  static constexpr uint32_t RES_FULL = BAR_AT, TILE_FULL = BAR_AT + 8;
  static constexpr uint32_t TILE_EMPTY = TILE_FULL + 8 * STAGES;
  static constexpr uint32_t P_FULL = TILE_EMPTY + 8 * STAGES;
  static constexpr uint32_t P_EMPTY = P_FULL + 8 * PBUF * CONSUMERS;
  static constexpr uint32_t BYTES = P_EMPTY + 8 * PBUF * CONSUMERS;
  static constexpr size_t SMEM = BYTES + 1024;     // slack to align the start to 1024
  static_assert(SMEM <= 232448, "a block's shared memory");
  static_assert(D % 16 == 0 && D % DCH == 0 && DCH % 8 == 0 && BT % 16 == 0, "tiles");
  static_assert(STAGE % 1024 == 0 && T_BOX % 512 == 0, "swizzle atoms stay aligned");
  static_assert(STAGES * STAGE >= 128 * D / 2 * 4, "the partial sums fit the stages");
};

// Rows [i_lo, i_hi] that see some key of [k_first, k_last] (none if
// i_lo > i_hi).
__device__ __forceinline__ void rows_seeing(int k_first, int k_last, int sq, int skv, int window,
                                            int& i_lo, int& i_hi) {
  const int off = skv - sq;
  i_lo = max(0, k_first - off);
  i_hi = window > 0 ? (int)min((long long)sq - 1, (long long)k_last + window - 1 - off) : sq - 1;
}

// Whether (key, row) is a pair the row sees (and both exist).
__device__ __forceinline__ bool sees(int key, int row, int sq, int skv, int window) {
  const int qp = row + skv - sq;
  return row < sq && key < skv && key <= qp && (window <= 0 || key > qp - window);
}

// One block of the dK/dV kernel's order: kv head `kv_head` (b * hkv + h),
// keys [k0, k0 + 64), and the q tiles qt0 ... qt0 + n_qt - 1 of each q head
// of the group whose rows see some key of it. Key blocks first to last (the
// first are seen by the most rows), the kv heads side by side.
struct KvBlock {
  int kv_head, k0, qt0, n_qt;
};

template <int BT>
__device__ __forceinline__ KvBlock kv_block_at(int x, int kv_heads, int sq, int skv, int window) {
  KvBlock blk;
  blk.kv_head = x % kv_heads;
  blk.k0 = x / kv_heads * ROWS;
  int i_lo, i_hi;
  rows_seeing(blk.k0, min(blk.k0 + ROWS, skv) - 1, sq, skv, window, i_lo, i_hi);
  blk.qt0 = i_lo / BT;
  blk.n_qt = i_hi >= i_lo ? i_hi / BT - blk.qt0 + 1 : 0;
  return blk;
}

// One block of the dQ kernel's order: head bh (b * hq + h), rows
// [q0, q0 + 64), its kv head, and the key tiles [kb0, kb0 + n_tiles * BT)
// some row of it may see. Query blocks last to first, the heads side by side.
struct QBlock {
  int bh, q0, kv_head, kb0, n_tiles;
};

template <int BT>
__device__ __forceinline__ QBlock q_block_at(int x, int bhs, int hq, int hkv, int sq, int skv,
                                             int window) {
  const int nqb = (sq + ROWS - 1) / ROWS;
  QBlock blk;
  blk.bh = x % bhs;
  blk.q0 = (nqb - 1 - x / bhs) * ROWS;
  const int b = blk.bh / hq;
  blk.kv_head = b * hkv + (blk.bh - b * hq) / (hq / hkv);
  const int off = skv - sq;
  const int k_hi = min(skv, min(blk.q0 + ROWS, sq) + off) - 1;
  const int k_lo = window > 0 ? max(0, blk.q0 + off - window + 1) : 0;
  blk.kb0 = k_lo / BT * BT;
  blk.n_tiles = k_hi >= blk.kb0 ? (k_hi - blk.kb0) / BT + 1 : 0;
  return blk;
}

// The hi and lo A fragments of k-step ks of the resident raw tile at `res`
// (64 rows of D f32, 128-byte swizzled boxes of 32): thread (warp w, lane
// 4g + t) reads rows 16 w + g and + 8, columns 8 ks + t and + 4.
template <int D>
__device__ __forceinline__ void res_frag(uint32_t (&ah)[4], uint32_t (&al)[4], uint32_t res,
                                         int ks, int warp, int g, int t) {
  const uint32_t box = res + (16 * warp + g) * 128 + 4 * t + (ks / 4) * F32Layout<D>::RES_BOX;
  const uint32_t lo_col = box + (((2 * (ks % 4)) ^ g) << 4);       // column 8 ks + t
  const uint32_t hi_col = box + (((2 * (ks % 4) + 1) ^ g) << 4);   // column 8 ks + t + 4
  split(ld_shared_f32(lo_col), ah[0], al[0]);
  split(ld_shared_f32(lo_col + 1024), ah[1], al[1]);   // row + 8
  split(ld_shared_f32(hi_col), ah[2], al[2]);
  split(ld_shared_f32(hi_col + 1024), ah[3], al[3]);
}

// x2 += A_lo N_hi + A_hi N_lo and x += A_hi N_hi for k-step ks of N^T's
// natural planes at `nh` and `nl`; `ks > 0` accumulates.
template <int D>
__device__ __forceinline__ void issue_kstep(float (&x)[F32Tiling<D>::BT / 2],
                                            float (&x2)[F32Tiling<D>::BT / 2],
                                            const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                            uint32_t nh, uint32_t nl, int ks) {
  constexpr int BT = F32Tiling<D>::BT;
  const uint32_t at = (ks / 4) * F32Layout<D>::N_BOX + (ks % 4) * 32;
  const uint64_t bh = wgmma_desc(nh + at, 16, 1024), bl = wgmma_desc(nl + at, 16, 1024);
  wgmma_tf32<BT>(x2, al, bh, ks > 0);
  wgmma_tf32<BT>(x2, ah, bl, 1);
  wgmma_tf32<BT>(x, ah, bh, ks > 0);
}

// x (64 x BT) = R N^T in three TF32 passes, the two small ones into x2:
// R the resident raw tile at `res`, its A fragments either held (rh, rl:
// HOLD) or split here KCH k-steps at a time; N the BT rows of the natural
// planes at `nh` (hi) and `nl` (lo).
template <int D>
__device__ __forceinline__ void first_product(float (&x)[F32Tiling<D>::BT / 2],
                                              float (&x2)[F32Tiling<D>::BT / 2],
                                              const uint32_t (&rh)[F32Layout<D>::HELD][4],
                                              const uint32_t (&rl)[F32Layout<D>::HELD][4],
                                              uint32_t res, uint32_t nh, uint32_t nl, int warp,
                                              int g, int t) {
  using L = F32Layout<D>;
  constexpr int KS = D / 8, C = KCH;
  if constexpr (L::HOLD) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) issue_kstep<D>(x, x2, rh[ks], rl[ks], nh, nl, ks);
    wgmma_commit();
  } else {
#pragma unroll
    for (int c0 = 0; c0 < KS; c0 += C) {
      uint32_t ah[C][4], al[C][4];
#pragma unroll
      for (int i = 0; i < C; ++i)
        if (c0 + i < KS) res_frag<D>(ah[i], al[i], res, c0 + i, warp, g, t);
      wgmma_hold(ah);
      wgmma_hold(al);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < C; ++i)
        if (c0 + i < KS) issue_kstep<D>(x, x2, ah[i], al[i], nh, nl, c0 + i);
      wgmma_commit();
      wgmma_wait<1>();   // the group before is done: its fragments' registers are free
    }
  }
  wgmma_wait<0>();
  wgmma_hold(x);
  wgmma_hold(x2);
}

// out (64 x N) += Z T^T in three TF32 passes, DCH columns at a time, each
// into a fresh accumulator added to `out` in f32: Z the hi and lo A
// fragments zh, zl of BT / 8 k-steps, T the N rows of the transposed planes
// at `th` (hi) and `tl` (lo), BT f32 of K each (boxes of N rows).
template <int D, int N, int DCH>
__device__ __forceinline__ void second_product(float (&out)[N / 2],
                                               const uint32_t (&zh)[F32Tiling<D>::BT / 8][4],
                                               const uint32_t (&zl)[F32Tiling<D>::BT / 8][4],
                                               uint32_t th, uint32_t tl) {
  using L = F32Layout<D>;
  constexpr int BT = L::BT;
#pragma unroll
  for (int c0 = 0; c0 < N; c0 += DCH) {
    float f[DCH / 2];
#pragma unroll
    for (int i = 0; i < DCH / 2; ++i) f[i] = 0.0f;
    wgmma_hold(f);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 8; ++kk) {
      const uint32_t at = (8 * kk / L::TW) * (N * L::TW * 4) + c0 * L::TW * 4 +
                          (kk % (L::TW / 8)) * 32;
      uint64_t bh, bl;
      if constexpr (L::TSWIZZLE == 128) {
        bh = wgmma_desc(th + at, 16, 1024);
        bl = wgmma_desc(tl + at, 16, 1024);
      } else {
        bh = wgmma_desc64(th + at, 512);
        bl = wgmma_desc64(tl + at, 512);
      }
      wgmma_tf32<DCH>(f, zl[kk], bh, 1);
      wgmma_tf32<DCH>(f, zh[kk], bl, 1);
      wgmma_tf32<DCH>(f, zh[kk], bh, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(f);
#pragma unroll
    for (int i = 0; i < DCH / 2; ++i) out[c0 / 2 + i] += f[i];
  }
}

// Element e of n-tile n of an accumulator (row g + 8 (e >> 1), column
// 8 n + 2 t + (e & 1)), split as element (e >> 1) | ((e & 1) << 1) of the
// A fragment of k-step n: column 2t at mma index t, 2t + 1 at t + 4, the
// order the pre-pass gives the transposed planes' rows.
__device__ __forceinline__ void split_frag(const float (&z)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(z[e], hi[(e >> 1) | ((e & 1) << 1)], lo[(e >> 1) | ((e & 1) << 1)]);
}

// The accumulator's rows (N columns) of this thread, stored (times `mult`)
// into rows [r0, limit) of a row-major array at `out`, rows `ld` apart.
template <int N>
__device__ __forceinline__ void store_rows(float* __restrict__ out, const float (&acc)[N / 2],
                                           int r0, int limit, int ld, int warp, int g, int t,
                                           float mult) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * warp + g + 8 * h;
    if (r >= limit) continue;
    float* p = out + (size_t)r * ld + 2 * t;
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
      *reinterpret_cast<float2*>(p + 8 * n) =
          make_float2(acc[4 * n + 2 * h] * mult, acc[4 * n + 2 * h + 1] * mult);
  }
}

// Consumer 1's partial sums into consumer 0's, through the stages (free once
// both are done with their tiles): acc of consumer 0 becomes its own plus
// consumer 1's, in that order. `c` is the consumer, `tid` its thread.
template <int N>
__device__ __forceinline__ void combine(float (&acc)[N / 2], float* stages, int c, int tid) {
  if constexpr (CONSUMERS == 1) return;
  named_sync(1, 128 * CONSUMERS);   // both consumers are done reading the stages
  if (c == 1) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) stages[i * 128 + tid] = acc[i];
  }
  named_sync(1, 128 * CONSUMERS);
  if (c == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] += stages[i * 128 + tid];
  }
}

// The barriers of a CTA, initialised by one thread, then the cluster's
// barrier so that the other CTA may arrive on them.
template <int D>
__device__ __forceinline__ void init_barriers(uint32_t base) {
  using L = F32Layout<D>;
  if (threadIdx.x == 0) {
    mbar_init(base + L::RES_FULL, 1);
    for (int st = 0; st < L::STAGES; ++st) {
      mbar_init(base + L::TILE_FULL + 8 * st, 1);
      mbar_init(base + L::TILE_EMPTY + 8 * st, 128);
    }
    for (int b = 0; b < PBUF * CONSUMERS; ++b) {
      mbar_init(base + L::P_FULL + 8 * b, 128);
      mbar_init(base + L::P_EMPTY + 8 * b, 128);
    }
    mbar_init_fence();
  }
  cluster_sync();
}

// -- dK/dV ----------------------------------------------------------------------

// A cluster of two CTAs per block of 64 keys, split by output. CTA 0 holds
// K, streams Q (natural planes) and dO (transposed), computes S^T = K Q^T,
// P^T = exp2(S^T scale log2 e - L log2 e), sends P^T to CTA 1 and adds
// P^T dO into dV. CTA 1 holds V, streams dO (natural) and Q (transposed),
// computes dP^T = V dO^T, forms dS^T = P^T (dP^T - D) from the P^T it
// receives and adds dS^T Q into dK. Warp 0 of warpgroup 0 produces: the
// resident tile, then per tile its planes by TMA and its rows of L log2 e
// (CTA 0) or D (CTA 1) by the warp's plain loads.
template <int D>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1)
flash_attention_bwd_dkdv_f32_kernel(
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap qhmap, const __grid_constant__ CUtensorMap qlmap,
    const __grid_constant__ CUtensorMap dohmap, const __grid_constant__ CUtensorMap dolmap,
    const __grid_constant__ CUtensorMap qthmap, const __grid_constant__ CUtensorMap qtlmap,
    const __grid_constant__ CUtensorMap dothmap, const __grid_constant__ CUtensorMap dotlmap,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int kv_heads, int hq, int hkv, int sq, int skv, int window,
    float scale_log2, float scale) {
  using L = F32Layout<D>;
  constexpr int BT = L::BT, NQ = BT / 8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* vecs = reinterpret_cast<float*>(smem_raw + (base - raw) + L::VEC_AT);
  float* stages = reinterpret_cast<float*>(smem_raw + (base - raw) + L::STAGE_AT);
  const uint32_t rank = cluster_ctarank();
  const int wg = __shfl_sync(FULL, threadIdx.x / 128, 0);
  const KvBlock blk = kv_block_at<BT>(blockIdx.x >> 1, kv_heads, sq, skv, window);
  const int group = hq / hkv, n_it = group * blk.n_qt;
  const int b = blk.kv_head / hkv;
  const int head0 = b * hq + (blk.kv_head - b * hkv) * group;   // the group's first q head
  init_barriers<D>(base);

  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const bool lead = lane == 0;
      const CUtensorMap* res = rank ? &vmap : &kmap;
      const CUtensorMap* nh = rank ? &dohmap : &qhmap;
      const CUtensorMap* nl = rank ? &dolmap : &qlmap;
      const CUtensorMap* th = rank ? &qthmap : &dothmap;
      const CUtensorMap* tl = rank ? &qtlmap : &dotlmap;
      if (lead) {
        mbar_arrive_expect(base + L::RES_FULL, L::RES_BYTES);
#pragma unroll
        for (int c = 0; c < L::BOXES; ++c)
          tma_load_3d(base + L::RES_AT + c * L::RES_BOX, res, base + L::RES_FULL, c * BOX, blk.k0,
                      blk.kv_head);
      }
      for (int j = 0; j < n_it; ++j) {
        const int st = j % L::STAGES;
        if (j >= L::STAGES) mbar_wait(base + L::TILE_EMPTY + 8 * st, ((j / L::STAGES) & 1) ^ 1);
        const int hg = j / blk.n_qt;
        const int q0 = (blk.qt0 + j - hg * blk.n_qt) * BT;
        const int bh = head0 + hg;
        for (int r = lane; r < BT; r += 32) {
          const bool in = q0 + r < sq;
          const size_t at = (size_t)bh * sq + q0 + r;
          vecs[st * BT + r] = !in ? 0.0f : rank ? delta[at] : lse[at] * LOG2E;
        }
        __syncwarp();
        if (lead) {
          const uint32_t full = base + L::TILE_FULL + 8 * st;
          const uint32_t at = base + L::STAGE_AT + st * L::STAGE;
          mbar_arrive_expect(full, L::STAGE);
#pragma unroll
          for (int c = 0; c < L::BOXES; ++c) {
            tma_load_3d(at + L::NH + c * L::N_BOX, nh, full, c * BOX, q0, bh);
            tma_load_3d(at + L::NL + c * L::N_BOX, nl, full, c * BOX, q0, bh);
          }
#pragma unroll
          for (int c = 0; c < L::TBOXES; ++c) {
            tma_load_3d(at + L::TH + c * L::T_BOX, th, full, q0 + c * L::TW, 0, bh);
            tma_load_3d(at + L::TL + c * L::T_BOX, tl, full, q0 + c * L::TW, 0, bh);
          }
        }
      }
    }
    cluster_sync();   // in each role's branch: each runs with its own register count
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1;                  // this consumer takes tiles c, c + 2, ...
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int off = skv - sq;
    const int key = blk.k0 + 16 * warp + g;   // this thread's keys: key and key + 8
    const uint32_t peer = cluster_addr(base, rank ^ 1u);
    float acc[D / 2];   // dV (CTA 0) or dK (CTA 1): this consumer's tiles
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    mbar_wait(base + L::RES_FULL, 0);
    uint32_t rh[L::HELD][4], rl[L::HELD][4];   // K's or V's A fragments (HOLD)
    if constexpr (L::HOLD) {
#pragma unroll
      for (int ks = 0; ks < L::HELD; ++ks)
        res_frag<D>(rh[ks], rl[ks], base + L::RES_AT, ks, warp, g, t);
    }
    for (int j = c; j < n_it; j += CONSUMERS) {
      const int jj = j / CONSUMERS;        // this consumer's tile count so far
      const int st = j % L::STAGES, buf = PBUF * c + jj % PBUF;
      const uint32_t use = jj / PBUF;   // this buffer's uses before this one
      const uint32_t at = base + L::STAGE_AT + st * L::STAGE;
      mbar_wait(base + L::TILE_FULL + 8 * st, (j / L::STAGES) & 1);
      const int hg = j / blk.n_qt;
      const int q0 = (blk.qt0 + j - hg * blk.n_qt) * BT;
      float x[BT / 2] = {}, x2[BT / 2] = {};   // S^T (CTA 0) or dP^T (CTA 1), [64 keys, BT rows]
      first_product<D>(x, x2, rh, rl, base + L::RES_AT, at + L::NH, at + L::NL, warp, g, t);
      // Masks only on tiles that cross the diagonal, the window edge, or the
      // end of the keys or of the rows.
      const bool edge = blk.k0 + ROWS - 1 > q0 + off || blk.k0 + ROWS > skv || q0 + BT > sq ||
                        (window > 0 && blk.k0 <= q0 + BT - 1 + off - window);
      const float* vec = vecs + st * BT;
      const uint32_t slot = L::INBOX_AT + buf * L::INBOX_TILE + tid * 16;
      uint32_t zh[NQ][4], zl[NQ][4];
      if (rank == 0) {
        if (use > 0) mbar_wait_cluster(base + L::P_EMPTY + 8 * buf, (use - 1) & 1);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          const float2 l = *reinterpret_cast<const float2*>(vec + 8 * n + 2 * t);
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[e] = ex2(fmaf(x[4 * n + e] + x2[4 * n + e], scale_log2, -((e & 1) ? l.y : l.x)));
            if (edge && !sees(key + 8 * (e >> 1), q0 + 8 * n + 2 * t + (e & 1), sq, skv, window))
              p[e] = 0.0f;
          }
          st_cluster_f32x4(peer + slot + n * 128 * 16, p[0], p[1], p[2], p[3]);
          split_frag(p, zh[n], zl[n]);
        }
        mbar_arrive_cluster(peer + L::P_FULL + 8 * buf);
      } else {
        mbar_wait_cluster(base + L::P_FULL + 8 * buf, use & 1);
        const float4* in = reinterpret_cast<const float4*>(smem_raw + (base - raw) + slot);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          const float4 p4 = in[n * 128];
          const float p[4] = {p4.x, p4.y, p4.z, p4.w};
          const float2 d = *reinterpret_cast<const float2*>(vec + 8 * n + 2 * t);
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ds[e] = p[e] * ((x[4 * n + e] + x2[4 * n + e]) - ((e & 1) ? d.y : d.x));
            if (edge && !sees(key + 8 * (e >> 1), q0 + 8 * n + 2 * t + (e & 1), sq, skv, window))
              ds[e] = 0.0f;
          }
          split_frag(ds, zh[n], zl[n]);
        }
        mbar_arrive_cluster(peer + L::P_EMPTY + 8 * buf);
      }
      second_product<D, D, L::DCH>(acc, zh, zl, at + L::TH, at + L::TL);   // dV, dK
      mbar_arrive(base + L::TILE_EMPTY + 8 * st);
    }
    combine<D>(acc, stages, c, tid);
    const size_t kv0 = (size_t)blk.kv_head * skv;
    if (c == 0)
      store_rows<D>((rank ? dk : dv) + kv0 * D, acc, blk.k0, skv, D, warp, g, t,
                    rank ? scale : 1.0f);
    cluster_sync();   // no CTA of the cluster still reads or arrives on the other's memory
  }
}

// -- dQ -------------------------------------------------------------------------

// A cluster of two CTAs per block of 64 q rows. CTA 0 holds Q, streams K
// (natural planes), computes S = Q K^T and P = exp2(S scale log2 e -
// L log2 e) and sends P to CTA 1. CTA 1 holds dO, streams V (natural) and
// K (transposed), computes dP = dO V^T, forms dS = P (dP - D) and adds dS K
// into dQ.
template <int D>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1)
flash_attention_bwd_dq_f32_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
    const __grid_constant__ CUtensorMap khmap, const __grid_constant__ CUtensorMap klmap,
    const __grid_constant__ CUtensorMap vhmap, const __grid_constant__ CUtensorMap vlmap,
    const __grid_constant__ CUtensorMap kthmap, const __grid_constant__ CUtensorMap ktlmap,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq,
    int bhs, int hq, int hkv, int sq, int skv, int window, float scale_log2, float scale) {
  using L = F32Layout<D>;
  constexpr int BT = L::BT, NK = BT / 8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* stages = reinterpret_cast<float*>(smem_raw + (base - raw) + L::STAGE_AT);
  const uint32_t rank = cluster_ctarank();
  const int wg = __shfl_sync(FULL, threadIdx.x / 128, 0);
  const QBlock blk = q_block_at<BT>(blockIdx.x >> 1, bhs, hq, hkv, sq, skv, window);
  init_barriers<D>(base);

  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const CUtensorMap* res = rank ? &domap : &qmap;
      const CUtensorMap* nh = rank ? &vhmap : &khmap;
      const CUtensorMap* nl = rank ? &vlmap : &klmap;
      const uint32_t bytes = rank ? L::STAGE : 2 * L::N_BYTES;   // CTA 0 takes no transposed plane
      mbar_arrive_expect(base + L::RES_FULL, L::RES_BYTES);
#pragma unroll
      for (int c = 0; c < L::BOXES; ++c)
        tma_load_3d(base + L::RES_AT + c * L::RES_BOX, res, base + L::RES_FULL, c * BOX, blk.q0,
                    blk.bh);
      for (int j = 0; j < blk.n_tiles; ++j) {
        const int st = j % L::STAGES;
        if (j >= L::STAGES) mbar_wait(base + L::TILE_EMPTY + 8 * st, ((j / L::STAGES) & 1) ^ 1);
        const int kb = blk.kb0 + j * BT;
        const uint32_t full = base + L::TILE_FULL + 8 * st;
        const uint32_t at = base + L::STAGE_AT + st * L::STAGE;
        mbar_arrive_expect(full, bytes);
#pragma unroll
        for (int c = 0; c < L::BOXES; ++c) {
          tma_load_3d(at + L::NH + c * L::N_BOX, nh, full, c * BOX, kb, blk.kv_head);
          tma_load_3d(at + L::NL + c * L::N_BOX, nl, full, c * BOX, kb, blk.kv_head);
        }
        if (rank) {
#pragma unroll
          for (int c = 0; c < L::TBOXES; ++c) {
            tma_load_3d(at + L::TH + c * L::T_BOX, &kthmap, full, kb + c * L::TW, 0, blk.kv_head);
            tma_load_3d(at + L::TL + c * L::T_BOX, &ktlmap, full, kb + c * L::TW, 0, blk.kv_head);
          }
        }
      }
    }
    cluster_sync();
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1;                  // this consumer takes tiles c, c + 2, ...
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int row0 = blk.q0 + 16 * warp + g;   // this thread's rows: row0 and row0 + 8
    const uint32_t peer = cluster_addr(base, rank ^ 1u);
    // L log2 e (CTA 0) or D (CTA 1) of this thread's rows; 0 past Sq.
    float lr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      const size_t at = (size_t)blk.bh * sq + r;
      lr[h] = r >= sq ? 0.0f : rank ? delta[at] : lse[at] * LOG2E;
    }
    float acc[D / 2];   // dQ (CTA 1): this consumer's tiles
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    const int qpos0 = blk.q0 + skv - sq;   // key position of the block's first row
    mbar_wait(base + L::RES_FULL, 0);
    uint32_t rh[L::HELD][4], rl[L::HELD][4];   // Q's or dO's A fragments (HOLD)
    if constexpr (L::HOLD) {
#pragma unroll
      for (int ks = 0; ks < L::HELD; ++ks)
        res_frag<D>(rh[ks], rl[ks], base + L::RES_AT, ks, warp, g, t);
    }
    for (int j = c; j < blk.n_tiles; j += CONSUMERS) {
      const int jj = j / CONSUMERS;
      const int st = j % L::STAGES, buf = PBUF * c + jj % PBUF;
      const uint32_t use = jj / PBUF;   // this buffer's uses before this one
      const uint32_t at = base + L::STAGE_AT + st * L::STAGE;
      mbar_wait(base + L::TILE_FULL + 8 * st, (j / L::STAGES) & 1);
      const int kb = blk.kb0 + j * BT;
      float x[BT / 2] = {}, x2[BT / 2] = {};   // S (CTA 0) or dP (CTA 1), [64 rows, BT keys]
      first_product<D>(x, x2, rh, rl, base + L::RES_AT, at + L::NH, at + L::NL, warp, g, t);
      const bool edge = kb + BT - 1 > qpos0 || kb + BT > skv ||
                        (window > 0 && kb <= qpos0 + ROWS - 1 - window);
      const uint32_t slot = L::INBOX_AT + buf * L::INBOX_TILE + tid * 16;
      if (rank == 0) {
        mbar_arrive(base + L::TILE_EMPTY + 8 * st);   // its last read of the stage
        if (use > 0) mbar_wait_cluster(base + L::P_EMPTY + 8 * buf, (use - 1) & 1);
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[e] = ex2(fmaf(x[4 * n + e] + x2[4 * n + e], scale_log2, -lr[e >> 1]));
            if (edge && !sees(kb + 8 * n + 2 * t + (e & 1), row0 + 8 * (e >> 1), sq, skv, window))
              p[e] = 0.0f;
          }
          st_cluster_f32x4(peer + slot + n * 128 * 16, p[0], p[1], p[2], p[3]);
        }
        mbar_arrive_cluster(peer + L::P_FULL + 8 * buf);
      } else {
        mbar_wait_cluster(base + L::P_FULL + 8 * buf, use & 1);
        const float4* in = reinterpret_cast<const float4*>(smem_raw + (base - raw) + slot);
        uint32_t zh[NK][4], zl[NK][4];
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const float4 p4 = in[n * 128];
          const float p[4] = {p4.x, p4.y, p4.z, p4.w};
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ds[e] = p[e] * ((x[4 * n + e] + x2[4 * n + e]) - lr[e >> 1]);
            if (edge && !sees(kb + 8 * n + 2 * t + (e & 1), row0 + 8 * (e >> 1), sq, skv, window))
              ds[e] = 0.0f;
          }
          split_frag(ds, zh[n], zl[n]);
        }
        mbar_arrive_cluster(peer + L::P_EMPTY + 8 * buf);
        second_product<D, D, L::DCH>(acc, zh, zl, at + L::TH, at + L::TL);   // dQ += dS K
        mbar_arrive(base + L::TILE_EMPTY + 8 * st);
      }
    }
    if (rank) {
      combine<D>(acc, stages, c, tid);
      if (c == 0)
        store_rows<D>(dq + (size_t)blk.bh * sq * D, acc, blk.q0, sq, D, warp, g, t, scale);
    }
    cluster_sync();
  }
}

// -- the pre-pass ---------------------------------------------------------------

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


// Floats of the scratch array `delta` at offset `at`, rounded up to 64 (256
// bytes: every plane starts aligned for TMA).
constexpr long long pad64(long long n) { return (n + 63) / 64 * 64; }

// The layout of the scratch: D [batch, hq, sq], then the pre-pass's planes
// of Q, dO (natural hi, lo; transposed hi, lo each), of K and V (natural)
// and of K (transposed).
struct Scratch {
  long long delta, qh, ql, doh, dol, qth, qtl, doth, dotl, kh, kl, vh, vl, kth, ktl, total;
};

inline Scratch scratch_layout(int batch, int hq, int hkv, int sq, int skv, int d) {
  const long long bhq = (long long)batch * hq, bhkv = (long long)batch * hkv;
  const long long qn = pad64(bhq * sq * d), qt = pad64(bhq * d * ((sq + 7) / 8 * 8));
  const long long kn = pad64(bhkv * skv * d), kt = pad64(bhkv * d * ((skv + 7) / 8 * 8));
  Scratch s;
  long long at = 0;
  s.delta = at; at += pad64(bhq * sq);
  s.qh = at; at += qn;
  s.ql = at; at += qn;
  s.doh = at; at += qn;
  s.dol = at; at += qn;
  s.qth = at; at += qt;
  s.qtl = at; at += qt;
  s.doth = at; at += qt;
  s.dotl = at; at += qt;
  s.kh = at; at += kn;
  s.kl = at; at += kn;
  s.vh = at; at += kn;
  s.vl = at; at += kn;
  s.kth = at; at += kt;
  s.ktl = at; at += kt;
  s.total = at;
  return s;
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* o, const float* dout,
           const float* lse, float* scratch, float* dq, float* dk, float* dv, int batch, int hq,
           int hkv, int sq, int skv, int window, float scale, cudaStream_t stream) {
  using L = F32Layout<D>;
  const Scratch sc = scratch_layout(batch, hq, hkv, sq, skv, D);
  float* delta = scratch + sc.delta;
  const int bhq = batch * hq, bhkv = batch * hkv;
  const int sq8 = (sq + 7) / 8 * 8, skv8 = (skv + 7) / 8 * 8;
  auto P = [&](long long at) { return scratch + at; };

  // The pre-pass: Q and dO natural and transposed, K natural and
  // transposed, V natural.
  SplitJobs jobs{};
  const float* srcs[4] = {q, dout, k, v};
  const long long nat[4][2] = {{sc.qh, sc.ql}, {sc.doh, sc.dol}, {sc.kh, sc.kl}, {sc.vh, sc.vl}};
  const long long tr[4][2] = {{sc.qth, sc.qtl}, {sc.doth, sc.dotl}, {sc.kth, sc.ktl}, {-1, -1}};
  int blocks = 0;
  for (int i = 0; i < 4; ++i) {
    SplitJob& jb = jobs.job[i];
    const bool kv = i >= 2;
    jb.src = srcs[i];
    jb.hi = P(nat[i][0]);
    jb.lo = P(nat[i][1]);
    jb.thi = tr[i][0] < 0 ? nullptr : P(tr[i][0]);
    jb.tlo = tr[i][1] < 0 ? nullptr : P(tr[i][1]);
    jb.heads = kv ? bhkv : bhq;
    jb.rows = kv ? skv : sq;
    jb.rows8 = kv ? skv8 : sq8;
    jb.first_block = blocks;
    blocks += split_blocks(jb, D);
  }

  // Eighteen maps, encoded for this call.
  CUtensorMap kv_k, kv_v, qh, ql, doh, dol, qth, qtl, doth, dotl;
  CUtensorMap q_q, q_do, kh, kl, vh, vl, kth, ktl;
  const int tw = L::TW, tsw = L::TSWIZZLE, bt = L::BT;
  int err = f32_rows_map(&kv_k, k, bhkv, skv, D, BOX, ROWS, 128);
  if (!err) err = f32_rows_map(&kv_v, v, bhkv, skv, D, BOX, ROWS, 128);
  if (!err) err = f32_rows_map(&qh, P(sc.qh), bhq, sq, D, BOX, bt, 128);
  if (!err) err = f32_rows_map(&ql, P(sc.ql), bhq, sq, D, BOX, bt, 128);
  if (!err) err = f32_rows_map(&doh, P(sc.doh), bhq, sq, D, BOX, bt, 128);
  if (!err) err = f32_rows_map(&dol, P(sc.dol), bhq, sq, D, BOX, bt, 128);
  if (!err) err = f32_rows_map(&qth, P(sc.qth), bhq, D, sq8, tw, D, tsw);
  if (!err) err = f32_rows_map(&qtl, P(sc.qtl), bhq, D, sq8, tw, D, tsw);
  if (!err) err = f32_rows_map(&doth, P(sc.doth), bhq, D, sq8, tw, D, tsw);
  if (!err) err = f32_rows_map(&dotl, P(sc.dotl), bhq, D, sq8, tw, D, tsw);
  if (!err) err = f32_rows_map(&q_q, q, bhq, sq, D, BOX, ROWS, 128);
  if (!err) err = f32_rows_map(&q_do, dout, bhq, sq, D, BOX, ROWS, 128);
  if (!err) err = f32_rows_map(&kh, P(sc.kh), bhkv, skv, D, BOX, bt, 128);
  if (!err) err = f32_rows_map(&kl, P(sc.kl), bhkv, skv, D, BOX, bt, 128);
  if (!err) err = f32_rows_map(&vh, P(sc.vh), bhkv, skv, D, BOX, bt, 128);
  if (!err) err = f32_rows_map(&vl, P(sc.vl), bhkv, skv, D, BOX, bt, 128);
  if (!err) err = f32_rows_map(&kth, P(sc.kth), bhkv, D, skv8, tw, D, tsw);
  if (!err) err = f32_rows_map(&ktl, P(sc.ktl), bhkv, D, skv8, tw, D, tsw);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_attention_bwd_dkdv_f32_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_attention_bwd_dq_f32_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);

  tf32_split_kernel<D><<<blocks, dim3(32, 8), 0, stream>>>(jobs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rows = (long long)bhq * sq;
  flash_attention_bwd_delta_kernel<D>
      <<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(o, dout, delta, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const float sl2 = scale * LOG2E;
  // Two CTAs (a cluster) a block; blocks in the order of kv_block_at and
  // q_block_at.
  const int kv_blocks = bhkv * ((skv + ROWS - 1) / ROWS);
  flash_attention_bwd_dkdv_f32_kernel<D><<<2 * kv_blocks, THREADS, L::SMEM, stream>>>(
      kv_k, kv_v, qh, ql, doh, dol, qth, qtl, doth, dotl, lse, delta, dk, dv, bhkv, hq, hkv, sq,
      skv, window, sl2, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int q_blocks = bhq * ((sq + ROWS - 1) / ROWS);
  flash_attention_bwd_dq_f32_kernel<D><<<2 * q_blocks, THREADS, L::SMEM, stream>>>(
      q_q, q_do, kh, kl, vh, vl, kth, ktl, lse, delta, dq, bhq, hq, hkv, sq, skv, window, sl2,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of the scratch array `delta` that flash_attention_bwd_f32 needs
// for these sizes: the D pass's [batch, hq, sq] and the pre-pass's planes.
extern "C" long long flash_attention_bwd_f32_scratch(int batch, int hq, int hkv, int sq, int skv,
                                                      int d) {
  return scratch_layout(batch, hq, hkv, sq, skv, d).total;
}

// q, o, dout, dq [batch, hq, sq, d]; k, v, dk, dv [batch, hkv, skv, d]:
// contiguous float32, 16-byte aligned; lse [batch, hq, sq] float32 as the
// forward wrote it; delta scratch of flash_attention_bwd_f32_scratch(...)
// floats, 256-byte aligned. hq a multiple of hkv, d one of 32, 64, 80, 128,
// 240, window <= 0 for none. Launches four kernels on `stream` and returns
// the cudaError_t of the launches (or of encoding their tensor maps).
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
  float* S = static_cast<float*>(delta);
  float* dQ = static_cast<float*>(dq);
  float* dK = static_cast<float*>(dk);
  float* dV = static_cast<float*>(dv);
  switch (d) {
    case 32: return launch<32>(Q, K, V, O, dO, L, S, dQ, dK, dV, batch, hq, hkv, sq, skv, window,
                               scale, s);
    case 64: return launch<64>(Q, K, V, O, dO, L, S, dQ, dK, dV, batch, hq, hkv, sq, skv, window,
                               scale, s);
    case 80: return launch<80>(Q, K, V, O, dO, L, S, dQ, dK, dV, batch, hq, hkv, sq, skv, window,
                               scale, s);
    case 128: return launch<128>(Q, K, V, O, dO, L, S, dQ, dK, dV, batch, hq, hkv, sq, skv,
                                 window, scale, s);
    case 240: return launch<240>(Q, K, V, O, dO, L, S, dQ, dK, dV, batch, hq, hkv, sq, skv,
                                 window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
