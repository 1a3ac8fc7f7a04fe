// Causal (optionally windowed) online-softmax attention with grouped kv heads,
// for float32 q, k, v, on Hopper's tensor cores, accurate to float32:
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
// sequence axes to 128. Here a block of query rows of one (batch, q head)
// walks the kv tiles in order with m, l and the output accumulator in
// registers; it maps its q head to its kv head itself (no repeated kv),
// masks ragged Sq and Skv itself (no padded copies), and walks only the kv
// tiles that hold a key some row of it may see: from the window start of its
// first row to the diagonal of its last. Skipping fully masked tiles changes
// no result.
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
// the serving shape. So the small passes of S go into an accumulator of
// their own, added to the large one after the last k-step, and each kv
// tile's P V into a fresh one, added to O in f32 after the online rescale.
// The scale and the mask are applied to S after the product, never to a
// split operand. The exponential is ex2.approx of s * (scale * log2 e) - m,
// one FMA per score, ~2^-22 relative: inside the 1e-5 limit. The row sum l
// is taken over the unsplit f32 P. Q, K and V keep tf32.cuh's rule for
// non-finite values (all of a non-finite x goes into lo), so a NaN or ±Inf
// that a row sees reaches its product. P is split without the finiteness
// test: it lies in [0, 1] or is NaN (a NaN or +Inf score), and the split
// turns the canonical NaN into -0; the NaN reaches the output through l
// instead, since a row's output is its accumulator times 1 / l, and l is 0
// only for a fully masked row, which is written as 0.
//
// What bounds it on the H100: operations. At the main paths' shape (the f32
// Qwen3-4B prefill and training step: 2 x 32 q heads, 8 kv heads, 2048
// tokens, D = 80) the causal work is 4 * 2 * 32 * 80 * 2048 * 2049 / 2 =
// 42.97 GFLOP over ~63 MB of f32 q, k, v and output; three TF32 passes are
// 128.9 GFLOP, 0.2604 ms at the 495 TFLOP/s dense TF32 peak, which only
// wgmma reaches (Ampere's warp-level m16n8k8 product, which the kernel this
// file held before ran, stops at 317-320 TFLOP/s on this card:
// tools/mma_tf32_ceiling.py).
//
// What the design does about it (FlashAttention-3's shape, after the bf16
// forward of flash_attention_tc.cu and the f32 backward of
// flash_attention_bwd.cu):
// - TF32 wgmma takes B only K-major (the transpose flags exist for 16-bit
//   types alone). K is K-major for S = Q K^T as stored; for O += P V the
//   contraction runs over keys, so V is read transposed, [D, keys].
// - A pre-pass (tf32_split_kernel of tf32.cuh, one launch before the
//   kernel) splits K and V once per call, not once per block and tile: K's
//   hi and lo planes in its own layout [B Hkv, Skv, D], V's transposed
//   [B Hkv, D, Skv8] with each group of 8 keys in the order 0 2 4 6 1 3 5 7.
//   That order lets the S accumulator's C fragment serve as P's A fragment
//   with no shuffle: lane (g, t) holds keys 2t and 2t + 1 of each 8, used
//   as mma indices t and t + 4. The planes live in the scratch the wrapper
//   allocates (flash_attention_f32_scratch floats); TMA lands them ready.
// - A CTA is a producer warpgroup (setmaxnreg 24; its warp 0 walks the
//   blocks and tiles in step, lane 0 issues every TMA copy: Q once a
//   block, then per tile K's two planes on one full barrier and V's two on
//   another, into a ring of STAGES stages) and two consumer warpgroups of 64
//   query rows (setmaxnreg 240). Every product is a TF32 wgmma with A in
//   registers (wgmma_tf32). S: D / 8 k-steps of three wgmma.m64nBKVk8, the
//   two small ones into their own accumulator. P V: BKV / 8 k-steps of three
//   wgmma.m64nDCHk8 into a fresh accumulator of DCH columns at a time.
// - Q is read once a block: at D <= 80 (HOLD) each consumer splits its rows
//   into A fragments once and keeps them in registers (D a thread), which
//   frees Q's buffer for the next block's at once; at D = 128 and 240 the
//   raw Q stays in shared memory and is split at use, KCH k-steps at a time.
// - The online softmax runs on the accumulator fragments, row max and sum
//   reduced across each quad by shuffles. Per-element masks only on tiles
//   that cross a consumer's diagonal, its window edge or the end of the
//   keys; a tile no row of a consumer may see costs it a wait.
// - One CTA an SM. Blocks are ordered in groups of heads whose K and V
//   planes fit 16 MB together (L2 holds 50 MB), each group's query blocks
//   longest first; a CTA takes the next block no CTA has taken from a
//   counter in device memory (`work_counters`, as in flash_attention_tc.cu),
//   and the copies of its next block overlap the products of the one before.
// - Tiles per head dim in Tiling<D>: BKV keys a tile, STAGES, DCH, HOLD and
//   SPLIT. At D = 240 shared memory decides: raw Q of 128 rows is 128 KB, so
//   a block is 64 rows (SPLIT), both consumers hold the same rows and take
//   its 16-key tiles in turn, each with its own m, l and O, and consumer 0
//   merges consumer 1's into its own at the end (through Q's buffer, which
//   both are done with): m = max(m0, m1), l = l0 a0 + l1 a1 and
//   O = O0 a0 + O1 a1 with a_i = 2^(m_i - m).
// No atomics touch a result: each output element is written once, by one
// thread, after sums in a fixed order, so two runs give the same bits.
//
// Registers and times. `-Xptxas -v` reports 168 registers (the launch bound)
// for every instance; in the SASS the consumers reach R234 at D = 80 and
// R237 at D = 240, where 368 / 500 bytes of spill stores / loads sit in the
// loops (tools/sass_spills.py); no other instance spills. Device time of a
// call, pre-pass included, in turns with the warp-level m16n8k8 kernel this
// file held before (NVIDIA H100 80GB HBM3, 700.00 W;
// tools/flash_fwd_turns.py --dtype float32, CUDA graphs of 20 calls): the
// main paths' q [2,32,2048,80] kv 8
// 0.370 ms without the log-sum-exp and 0.368-0.371 with it, against
// 0.803-0.810, 1.42x the 0.2604 ms bound (70 % of the TF32 peak over the
// three passes) and 1/16 of SDPA's f32 5.96 ms; q [8,32,2048,80] 1.42-1.50
// against 3.11-3.18; gemma3-12b q [2,16,2048,240] kv 8 1.34-1.35 against
// 2.73-2.76 (3.4x its 0.3906 bound: 16-key tiles make every S product a
// wgmma.m64n16k8, and the spills) and with window 1024 1.06-1.08 against
// 2.12-2.15. Built and measured slower at q [2,32,2048,80]: blocks handed out
// round-robin (1.25x), one block a CTA (1.09x), 32-key tiles in four stages
// at D = 80 (1.15x), P V in two accumulators of 40 columns at D = 80 (1.06x).
// Not separated yet: what holds the last 1.42x at D = 80 (the softmax and
// the splits between each consumer's products, one CTA an SM). The pre-pass
// adds a launch, and the host 3-7 us a call (five tensor maps per call).

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

constexpr int CONSUMERS = 2;             // consumer warpgroups of 64 query rows
constexpr int THREADS = 128 * (1 + CONSUMERS);   // and a producer warpgroup
constexpr int BOX = 32;                  // f32 columns of one 128-byte swizzled box
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int KCH = 4;                   // k-steps of Q split at a time (HOLD 0)
constexpr size_t L2_KV_BYTES = 16u << 20;   // K and V plane bytes a group of heads reads
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Per head dim: BKV keys a tile, STAGES stages of the ring, DCH columns of a
// fresh P V accumulator, HOLD (Q's A fragments split once a block and kept in
// registers; else split at use, KCH k-steps at a time) and SPLIT (a block of
// 64 rows whose tiles the two consumers take in turn; else 128 rows, 64 a
// consumer, both reading every tile).
template <int D> struct Tiling;
template <> struct Tiling<32> { static constexpr int BKV = 64, STAGES = 4, DCH = 32, HOLD = 1, SPLIT = 0; };
template <> struct Tiling<64> { static constexpr int BKV = 64, STAGES = 3, DCH = 64, HOLD = 1, SPLIT = 0; };
template <> struct Tiling<80> { static constexpr int BKV = 64, STAGES = 2, DCH = 80, HOLD = 1, SPLIT = 0; };
template <> struct Tiling<128> { static constexpr int BKV = 32, STAGES = 2, DCH = 64, HOLD = 0, SPLIT = 0; };
template <> struct Tiling<240> { static constexpr int BKV = 16, STAGES = 2, DCH = 48, HOLD = 0, SPLIT = 1; };

// Shared memory: raw Q [BOXES][BQ][32], then STAGES stages each of K's hi
// and lo planes [BOXES][BKV][32] and V's transposed hi and lo planes
// [TBOXES][D][TW], then the barriers; every box on its swizzle's boundary.
template <int D>
struct Layout {
  using T = Tiling<D>;
  static constexpr int BKV = T::BKV, STAGES = T::STAGES, DCH = T::DCH;
  static constexpr bool HOLD = T::HOLD, SPLIT = T::SPLIT;
  static constexpr int BQ = SPLIT ? 64 : 64 * CONSUMERS;   // query rows a block
  static constexpr int HELD = HOLD ? D / 8 : 1;             // k-steps of Q's fragments held
  static constexpr int BOXES = (D + BOX - 1) / BOX;
  static constexpr int TW = BKV < BOX ? BKV : BOX;          // keys a transposed box row
  static constexpr int TSWIZZLE = 4 * TW;                   // its swizzle, 64 or 128 bytes
  static constexpr int TBOXES = BKV / TW;
  static constexpr uint32_t Q_BOX = BQ * 128, Q_BYTES = BOXES * Q_BOX;
  static constexpr uint32_t K_BOX = BKV * 128, K_BYTES = BOXES * K_BOX;
  static constexpr uint32_t V_BOX = D * TW * 4, V_BYTES = TBOXES * V_BOX;
  static constexpr uint32_t STAGE = 2 * K_BYTES + 2 * V_BYTES;
  static constexpr uint32_t KH = 0, KL = K_BYTES, VH = 2 * K_BYTES, VL = VH + V_BYTES;
  static constexpr uint32_t Q_AT = 0, STAGE_AT = Q_BYTES;
  static constexpr uint32_t BAR_AT = STAGE_AT + STAGES * STAGE;
  // Barriers: Q full and Q empty, then per stage K full, V full and empty.
  static constexpr uint32_t Q_FULL = BAR_AT, Q_EMPTY = BAR_AT + 8;
  static constexpr uint32_t K_FULL = BAR_AT + 16, V_FULL = K_FULL + 8 * STAGES;
  static constexpr uint32_t EMPTY = V_FULL + 8 * STAGES;
  static constexpr uint32_t NEXT = EMPTY + 8 * STAGES;   // the block the producer loads next
  static constexpr uint32_t BYTES = NEXT + 8;
  static constexpr size_t SMEM = BYTES + 1024;   // slack to align the start to 1024
  static_assert(SMEM <= 232448, "a block's shared memory");
  static_assert(D % 8 == 0 && D % DCH == 0 && DCH % 8 == 0 && BKV % 16 == 0, "tiles");
  static_assert(STAGE % 1024 == 0 && Q_BYTES % 1024 == 0 && V_BOX % 512 == 0,
                "swizzle atoms stay aligned");
  // SPLIT: consumer 1's O, m and l pass to consumer 0 through Q's buffer.
  static_assert(!SPLIT || Q_BYTES >= 128 * (D / 2 + 4) * 4, "the merge fits Q's buffer");
};

// The work counters of a launch: the next block of the grid's order to hand
// out, and the CTAs that have found none left; the last of those sets both
// back to 0 for the next launch in the slot. Launches take the slots in
// turn, so two launches that run at once on a device (on two streams) use
// two slots unless SLOTS others were launched between them.
constexpr int SLOTS = 64;
__device__ unsigned int work_counters[SLOTS][2];
std::atomic<unsigned> launch_count{0};   // launches so far, on any device

// One block of the grid's order: its head (b * hq + h), first query row, kv
// head, and the key tiles [kb0, kb0 + n_tiles * BKV) some row of it may see
// (from the window start of its first row to the diagonal of its last).
// Blocks come in groups of `group` heads, each group's query blocks longest
// first and its heads side by side, so the K and V planes of a group's heads
// stay in L2 while all its query blocks read them.
struct Block {
  int bh, q0, kv_head, kb0, n_tiles;
};

template <int D>
__device__ __forceinline__ Block block_at(int x, int group, int bhs, int hq, int hkv, int sq,
                                          int skv, int window) {
  constexpr int BQ = Layout<D>::BQ, BKV = Layout<D>::BKV;
  const int nqb = (sq + BQ - 1) / BQ;
  const int g0 = x / (group * nqb) * group;
  const int gs = min(group, bhs - g0);
  const int in_group = x - g0 * nqb;
  Block blk;
  blk.bh = g0 + in_group % gs;
  blk.q0 = (nqb - 1 - in_group / gs) * BQ;
  const int b = blk.bh / hq;
  blk.kv_head = b * hkv + (blk.bh - b * hq) / (hq / hkv);
  const int off = skv - sq;
  const int k_hi = min(skv, min(blk.q0 + BQ, sq) + off) - 1;
  const int k_lo = window > 0 ? max(0, blk.q0 + off - window + 1) : 0;
  blk.kb0 = (k_lo / BKV) * BKV;
  blk.n_tiles = k_hi >= blk.kb0 ? (k_hi - blk.kb0) / BKV + 1 : 0;
  return blk;
}

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// The hi and lo A fragments of k-step ks of this consumer's rows of raw Q at
// `q_rows` (128-byte swizzled boxes of 32 columns, BQ rows each): thread
// (warp w, lane 4g + t) reads rows 16 w + g and + 8, columns 8 ks + t and
// + 4, in tf32.cuh's split.
template <int D>
__device__ __forceinline__ void q_frag(uint32_t (&ah)[4], uint32_t (&al)[4], uint32_t q_rows,
                                       int ks, int warp, int g, int t) {
  const uint32_t box = q_rows + (16 * warp + g) * 128 + 4 * t + (ks / 4) * Layout<D>::Q_BOX;
  const uint32_t lo_col = box + (((2 * (ks % 4)) ^ g) << 4);       // column 8 ks + t
  const uint32_t hi_col = box + (((2 * (ks % 4) + 1) ^ g) << 4);   // column 8 ks + t + 4
  split(ld_shared_f32(lo_col), ah[0], al[0]);
  split(ld_shared_f32(lo_col + 1024), ah[1], al[1]);   // row + 8
  split(ld_shared_f32(hi_col), ah[2], al[2]);
  split(ld_shared_f32(hi_col + 1024), ah[3], al[3]);
}

// s2 += Q_lo K_hi + Q_hi K_lo and s += Q_hi K_hi for k-step ks of the K
// planes at `kh` and `kl`; `ks > 0` accumulates.
template <int D>
__device__ __forceinline__ void s_kstep(float (&s)[Layout<D>::BKV / 2],
                                        float (&s2)[Layout<D>::BKV / 2], const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], uint32_t kh, uint32_t kl, int ks) {
  constexpr int BKV = Layout<D>::BKV;
  const uint32_t at = (ks / 4) * Layout<D>::K_BOX + (ks % 4) * 32;
  const uint64_t bh = wgmma_desc(kh + at, 16, 1024), bl = wgmma_desc(kl + at, 16, 1024);
  wgmma_tf32<BKV>(s2, al, bh, ks > 0);
  wgmma_tf32<BKV>(s2, ah, bl, 1);
  wgmma_tf32<BKV>(s, ah, bh, ks > 0);
}

// s (64 x BKV) = Q K^T in three TF32 passes, the two small ones into s2, then
// added: Q's fragments held (qh, ql: HOLD) or split here from `q_rows`, KCH
// k-steps at a time.
template <int D>
__device__ __forceinline__ void s_product(float (&s)[Layout<D>::BKV / 2],
                                          const uint32_t (&qh)[Layout<D>::HELD][4],
                                          const uint32_t (&ql)[Layout<D>::HELD][4],
                                          uint32_t q_rows, uint32_t kh, uint32_t kl, int warp,
                                          int g, int t) {
  using L = Layout<D>;
  constexpr int KS = D / 8, N = L::BKV / 2;
  float s2[N] = {};
  if constexpr (L::HOLD) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) s_kstep<D>(s, s2, qh[ks], ql[ks], kh, kl, ks);
    wgmma_commit();
  } else {
#pragma unroll
    for (int c0 = 0; c0 < KS; c0 += KCH) {
      uint32_t ah[KCH][4], al[KCH][4];
#pragma unroll
      for (int i = 0; i < KCH; ++i)
        if (c0 + i < KS) q_frag<D>(ah[i], al[i], q_rows, c0 + i, warp, g, t);
      wgmma_hold(ah);
      wgmma_hold(al);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < KCH; ++i)
        if (c0 + i < KS) s_kstep<D>(s, s2, ah[i], al[i], kh, kl, c0 + i);
      wgmma_commit();
      wgmma_wait<1>();   // the group before is done: its fragments' registers are free
    }
  }
  wgmma_wait<0>();
  wgmma_hold(s);
  wgmma_hold(s2);
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] += s2[i];
}

// o (64 x D) += P V in three TF32 passes, DCH columns at a time, each into a
// fresh accumulator added to o in f32: P the hi and lo A fragments ph, pl of
// BKV / 8 k-steps, V the D rows of the transposed planes at `vh` and `vl`.
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2],
                                           const uint32_t (&ph)[Layout<D>::BKV / 8][4],
                                           const uint32_t (&pl)[Layout<D>::BKV / 8][4],
                                           uint32_t vh, uint32_t vl) {
  using L = Layout<D>;
  constexpr int DCH = L::DCH, TW = L::TW;
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += DCH) {
    float f[DCH / 2];
#pragma unroll
    for (int i = 0; i < DCH / 2; ++i) f[i] = 0.0f;
    wgmma_hold(f);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::BKV / 8; ++kk) {
      const uint32_t at = (8 * kk / TW) * L::V_BOX + c0 * TW * 4 + (kk % (TW / 8)) * 32;
      uint64_t bh, bl;
      if constexpr (L::TSWIZZLE == 128) {
        bh = wgmma_desc(vh + at, 16, 1024);
        bl = wgmma_desc(vl + at, 16, 1024);
      } else {
        bh = wgmma_desc64(vh + at, 512);
        bl = wgmma_desc64(vl + at, 512);
      }
      wgmma_tf32<DCH>(f, pl[kk], bh, 1);
      wgmma_tf32<DCH>(f, ph[kk], bl, 1);
      wgmma_tf32<DCH>(f, ph[kk], bh, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(f);
#pragma unroll
    for (int i = 0; i < DCH / 2; ++i) o[c0 / 2 + i] += f[i];
  }
}

// The online softmax of one tile's scores `s` (keys kb ...), in place: masks
// (MASK) where the tile crosses a row's diagonal, window or the end of the
// keys, the new running max m, the factor `alpha` that rescales what came
// before, and P = 2^(s scale log2 e - m) in s, its sum added to l. Element i
// of s is row g + 8 ((i >> 1) & 1), key kb + 8 (i / 4) + 2 t + (i & 1).
template <int BKV, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[BKV / 2], float (&alpha)[2],
                                             float (&m)[2], float (&l)[2], int kb,
                                             const int (&qpos)[2], int t, int skv, int window,
                                             float scale_log2) {
  if constexpr (MASK) {
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const int kpos = kb + (i / 4) * 8 + 2 * t + (i & 1);
      const int qp = qpos[(i >> 1) & 1];
      if (!(kpos <= qp && kpos < skv && (window <= 0 || kpos > qp - window))) s[i] = -INFINITY;
    }
  }
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {   // row g: elements 0, 1; row g + 8: 2, 3
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n) mx = fmaxf(mx, fmaxf(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    const float m_new = fmaxf(m[r], mx * scale_log2);
    m_use[r] = m_new == -INFINITY ? 0.0f : m_new;   // row still fully masked
    alpha[r] = ex2(m[r] - m_use[r]);                // 0 while the running max is -inf
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) {
    s[i] = ex2(fmaf(s[i], scale_log2, -m_use[(i >> 1) & 1]));
    l[(i >> 1) & 1] += s[i];
  }
}

// The consumer warpgroup `c` (0 or 1) on a block whose Q has landed: its rows
// (64 of a 128-row block, or with SPLIT all 64 of the block, taking tiles c,
// c + 2, ...), whose tiles are the ring's `it`-th on.
template <int D>
__device__ __forceinline__ void consume_block(float* __restrict__ out, float* __restrict__ lse,
                                              uint32_t base, float* q_buf, int c,
                                              const Block& blk, int it, int sq, int skv,
                                              int window, float scale_log2) {
  using L = Layout<D>;
  constexpr int BKV = L::BKV, STAGES = L::STAGES, NK = BKV / 8;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;         // fragment row (and row + 8)
  const int t = lane & 3;          // fragment column pair
  const int kb0 = blk.kb0, n_tiles = blk.n_tiles;
  const int r0 = blk.q0 + (L::SPLIT ? 0 : 64 * c);   // this consumer's first row
  const int qpos0 = r0 + skv - sq;  // and its key position
  const int qpos[2] = {qpos0 + 16 * warp + g, qpos0 + 16 * warp + g + 8};
  const bool live = r0 < sq;        // rows past Sq need no products
  const uint32_t q_rows = base + L::Q_AT + (L::SPLIT ? 0 : c * 64 * 128);
  // Tile j of the block sits in stage (it + j) % STAGES of the ring.
  const auto stage = [&](int j) { return (it + j) % STAGES; };
  const auto phase = [&](int j) { return (uint32_t)(((it + j) / STAGES) & 1); };
  const auto k_full = [&](int j) { return base + L::K_FULL + 8 * stage(j); };
  const auto v_full = [&](int j) { return base + L::V_FULL + 8 * stage(j); };
  const auto empty = [&](int j) { return base + L::EMPTY + 8 * stage(j); };
  const auto at = [&](int j) { return base + L::STAGE_AT + stage(j) * L::STAGE; };
  const auto edge = [&](int kb) {
    return kb + BKV - 1 > qpos0 || kb + BKV > skv || (window > 0 && kb <= qpos0 + 63 - window);
  };

  // The tiles [j_lo, j_hi) this consumer's rows may see.
  int j_lo = 0, j_hi = 0;
  if (live && n_tiles > 0) {
    const int k_last = qpos0 + 63;
    const int k_first = window > 0 ? qpos0 - window + 1 : 0;
    j_hi = k_last >= kb0 ? min(n_tiles, (k_last - kb0) / BKV + 1) : 0;
    j_lo = k_first > kb0 ? (k_first - kb0) / BKV : 0;
    if (j_lo >= j_hi) j_lo = j_hi = 0;
  }

  uint32_t qh[L::HELD][4], ql[L::HELD][4];   // Q's A fragments (HOLD)
  if constexpr (L::HOLD) {
#pragma unroll
    for (int ks = 0; ks < L::HELD; ++ks) q_frag<D>(qh[ks], ql[ks], q_rows, ks, warp, g, t);
    mbar_arrive(base + L::Q_EMPTY);   // Q's buffer is free for the next block
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};   // running max of rows g, g + 8 (log2 units)
  float l[2] = {0.0f, 0.0f};             // this lane's share of the running sums

  // The last tile whose S product reads Q (HOLD 0 releases Q's buffer there).
  int j_last = -1;
  for (int j = j_lo; j < j_hi; ++j)
    if (!L::SPLIT || j % CONSUMERS == c) j_last = j;

  for (int j = L::SPLIT ? c : 0; j < n_tiles; j += L::SPLIT ? CONSUMERS : 1) {
    if (j < j_lo || j >= j_hi) {   // no row of this consumer may see it: wait and release
      mbar_wait(k_full(j), phase(j));
      mbar_wait(v_full(j), phase(j));
      mbar_arrive(empty(j));
      continue;
    }
    const uint32_t st = at(j);
    float s[BKV / 2] = {};
    mbar_wait(k_full(j), phase(j));
    s_product<D>(s, qh, ql, q_rows, st + L::KH, st + L::KL, warp, g, t);
    if (!L::HOLD && !L::SPLIT && j == j_last) mbar_arrive(base + L::Q_EMPTY);
    const int kb = kb0 + j * BKV;
    float alpha[2];
    if (edge(kb))
      softmax_tile<BKV, true>(s, alpha, m, l, kb, qpos, t, skv, window, scale_log2);
    else
      softmax_tile<BKV, false>(s, alpha, m, l, kb, qpos, t, skv, window, scale_log2);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n] *= alpha[0];
      o[4 * n + 1] *= alpha[0];
      o[4 * n + 2] *= alpha[1];
      o[4 * n + 3] *= alpha[1];
    }
    // P's A fragments: accumulator element e of n-tile n (key 2t + (e & 1))
    // is element (e >> 1) | ((e & 1) << 1) of k-step n's A fragment.
    uint32_t ph[NK][4], pl[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int a = (e >> 1) | ((e & 1) << 1);
        ph[n][a] = to_tf32(s[4 * n + e]);
        pl[n][a] = to_tf32(s[4 * n + e] - __uint_as_float(ph[n][a]));
      }
    wgmma_hold(ph);
    wgmma_hold(pl);
    mbar_wait(v_full(j), phase(j));
    pv_product<D>(o, ph, pl, st + L::VH, st + L::VL);
    mbar_arrive(empty(j));
  }
  if (!L::HOLD && !L::SPLIT && j_last < 0) mbar_arrive(base + L::Q_EMPTY);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
  }
  if constexpr (L::SPLIT) {
    // Consumer 1's O, m and l into consumer 0's, through Q's buffer, once
    // both are done with Q; then consumer 0 releases it.
    named_sync(1, 128 * CONSUMERS);
    if (c == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) q_buf[i * 128 + tid] = o[i];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        q_buf[(D / 2 + r) * 128 + tid] = m[r];
        q_buf[(D / 2 + 2 + r) * 128 + tid] = l[r];
      }
      fence_proxy_async();   // before the next block's Q lands here by TMA
    }
    named_sync(1, 128 * CONSUMERS);
    if (c == 1) return;
    float a0[2], a1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = q_buf[(D / 2 + r) * 128 + tid], l1 = q_buf[(D / 2 + 2 + r) * 128 + tid];
      const float mx = fmaxf(m[r], m1);
      const float mu = mx == -INFINITY ? 0.0f : mx;
      a0[r] = ex2(m[r] - mu);
      a1[r] = ex2(m1 - mu);
      m[r] = mx;
      l[r] = l[r] * a0[r] + l1 * a1[r];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      const int r = (i >> 1) & 1;
      o[i] = o[i] * a0[r] + q_buf[i * 128 + tid] * a1[r];
    }
    mbar_arrive(base + L::Q_EMPTY);
  }
  if (!live) return;

  // Normalise and store: l is 0 only for a fully masked row (written as 0),
  // and NaN where the row met a NaN score. With `lse`, the row's log-sum-exp
  // m + log l in natural units (-inf for a fully masked row), for the
  // backward pass (flash_attention_bwd.cu).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = l[r] == 0.0f ? 0.0f : 1.0f / l[r];
    const int row = r0 + 16 * warp + 8 * r + g;
    if (row >= sq) continue;
    if (lse != nullptr && t == 0)
      lse[(size_t)blk.bh * sq + row] = l[r] == 0.0f ? -INFINITY : (m[r] + log2f(l[r])) * LN2;
    float* dst = out + ((size_t)blk.bh * sq + row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(dst + n * 8) =
          make_float2(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
  }
}

// One CTA an SM: each starts on block blockIdx.x and then takes the next
// block of the grid's order that no CTA has taken (`work_counters[slot]`).
// The producer hands each block to the consumers through shared memory,
// published by the Q barrier; -1 ends the walk.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_f32_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap khmap,
                           const __grid_constant__ CUtensorMap klmap,
                           const __grid_constant__ CUtensorMap vhmap,
                           const __grid_constant__ CUtensorMap vlmap, float* __restrict__ out,
                           float* __restrict__ lse, int bhs, int hq, int hkv, int sq, int skv,
                           int window, float scale_log2, int group, int slot) {
  using L = Layout<D>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* q_buf = reinterpret_cast<float*>(smem_raw + (base - raw) + L::Q_AT);
  const int blocks = bhs * ((sq + L::BQ - 1) / L::BQ);

  if (threadIdx.x == 0) {
    // Q's buffer is released by every consumer thread, or with SPLIT by
    // consumer 0 after the merge; a stage by every consumer thread that
    // reads it (with SPLIT, the one consumer that takes its tile).
    mbar_init(base + L::Q_FULL, 1);
    mbar_init(base + L::Q_EMPTY, L::SPLIT ? 128 : 128 * CONSUMERS);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(base + L::K_FULL + 8 * st, 1);
      mbar_init(base + L::V_FULL + 8 * st, 1);
      mbar_init(base + L::EMPTY + 8 * st, L::SPLIT ? 128 : 128 * CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // The warpgroup, read from lane 0 so that the compiler sees it is the
  // same across each warp.
  const int wg = __shfl_sync(FULL, threadIdx.x / 128, 0);
  if (wg == 0) {
    // The producer: warp 0 walks the blocks and tiles in step (its values
    // the same in every lane), and its lane 0 issues every copy and takes
    // every block from the counter.
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      const bool lead = threadIdx.x == 0;
      unsigned int* counters = work_counters[slot];
      if (lead) {
        tma_prefetch(&qmap);
        tma_prefetch(&khmap);
        tma_prefetch(&klmap);
        tma_prefetch(&vhmap);
        tma_prefetch(&vlmap);
      }
      int it = 0;                   // tiles through the ring so far
      int x = blockIdx.x;
      for (int i = 0;; ++i) {
        if (i > 0) mbar_wait(base + L::Q_EMPTY, (i - 1) & 1);   // the last block is done with Q
        if (x >= blocks) {
          if (lead) {
            st_shared_s32(base + L::NEXT, -1);
            mbar_arrive(base + L::Q_FULL);
          }
          break;
        }
        const Block blk = block_at<D>(x, group, bhs, hq, hkv, sq, skv, window);
        if (lead) {
          st_shared_s32(base + L::NEXT, x);
          mbar_arrive_expect(base + L::Q_FULL, L::Q_BYTES);
#pragma unroll
          for (int c = 0; c < L::BOXES; ++c)
            tma_load_3d(base + L::Q_AT + c * L::Q_BOX, &qmap, base + L::Q_FULL, c * BOX, blk.q0,
                        blk.bh);
        }
        for (int j = 0; j < blk.n_tiles; ++j, ++it) {
          const int st = it % STAGES;
          if (it >= STAGES)    // the consumers are done with the tile STAGES back
            mbar_wait(base + L::EMPTY + 8 * st, ((it / STAGES) & 1) ^ 1);
          if (lead) {
            const int kb = blk.kb0 + j * L::BKV;
            const uint32_t k_full = base + L::K_FULL + 8 * st, v_full = base + L::V_FULL + 8 * st;
            const uint32_t at = base + L::STAGE_AT + st * L::STAGE;
            mbar_arrive_expect(k_full, 2 * L::K_BYTES);
#pragma unroll
            for (int c = 0; c < L::BOXES; ++c) {
              tma_load_3d(at + L::KH + c * L::K_BOX, &khmap, k_full, c * BOX, kb, blk.kv_head);
              tma_load_3d(at + L::KL + c * L::K_BOX, &klmap, k_full, c * BOX, kb, blk.kv_head);
            }
            mbar_arrive_expect(v_full, 2 * L::V_BYTES);
#pragma unroll
            for (int c = 0; c < L::TBOXES; ++c) {
              tma_load_3d(at + L::VH + c * L::V_BOX, &vhmap, v_full, kb + c * L::TW, 0,
                          blk.kv_head);
              tma_load_3d(at + L::VL + c * L::V_BOX, &vlmap, v_full, kb + c * L::TW, 0,
                          blk.kv_head);
            }
          }
        }
        const unsigned taken = lead ? atomicAdd(&counters[0], 1u) : 0u;
        x = gridDim.x + (int)__shfl_sync(FULL, taken, 0);
      }
      if (lead && atomicAdd(&counters[1], 1u) == gridDim.x - 1) {   // every CTA found none left
        atomicExch(&counters[0], 0u);
        atomicExch(&counters[1], 0u);
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    int it = 0;
    for (int i = 0;; ++i) {
      mbar_wait(base + L::Q_FULL, i & 1);       // the block's index, and its Q, have landed
      const int x = ld_shared_s32(base + L::NEXT);
      if (x < 0) break;
      const Block blk = block_at<D>(x, group, bhs, hq, hkv, sq, skv, window);
      consume_block<D>(out, lse, base, q_buf, wg - 1, blk, it, sq, skv, window, scale_log2);
      it += blk.n_tiles;
    }
  }
}

// Floats of the scratch array at offset `at`, rounded up to 64 (256 bytes:
// every plane starts aligned for TMA).
constexpr long long pad64(long long n) { return (n + 63) / 64 * 64; }

// The layout of the scratch: K's natural planes (hi, lo) and V's transposed
// planes (hi, lo).
struct Scratch {
  long long kh, kl, vth, vtl, total;
};

inline Scratch scratch_layout(int batch, int hkv, int skv, int d) {
  const long long bhkv = (long long)batch * hkv;
  const long long kn = pad64(bhkv * skv * d), vt = pad64(bhkv * d * ((skv + 7) / 8 * 8));
  Scratch s;
  s.kh = 0;
  s.kl = kn;
  s.vth = 2 * kn;
  s.vtl = 2 * kn + vt;
  s.total = 2 * kn + 2 * vt;
  return s;
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* out, float* lse,
           float* scratch, int batch, int hq, int hkv, int sq, int skv, int window,
           float scale_log2, cudaStream_t stream) {
  using L = Layout<D>;
  const Scratch sc = scratch_layout(batch, hkv, skv, D);
  const int bhq = batch * hq, bhkv = batch * hkv, skv8 = (skv + 7) / 8 * 8;
  const bool keys = skv > 0;
  cudaError_t e = cudaSuccess;
  if (keys) {   // the pre-pass: K natural, V transposed
    SplitJobs jobs{};
    jobs.job[0] = {k, scratch + sc.kh, scratch + sc.kl, nullptr, nullptr, bhkv, skv, skv8, 0};
    const int k_blocks = split_blocks(jobs.job[0], D);
    jobs.job[1] = {v, nullptr, nullptr, scratch + sc.vth, scratch + sc.vtl, bhkv, skv, skv8,
                   k_blocks};
    jobs.job[2].first_block = jobs.job[3].first_block = INT_MAX;
    tf32_split_kernel<D><<<k_blocks + split_blocks(jobs.job[1], D), dim3(32, 8), 0, stream>>>(
        jobs);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // Five maps, encoded for this call. Without keys no tile is loaded, and the
  // K and V maps only need to be valid: they take q's.
  CUtensorMap qmap, khmap, klmap, vhmap, vlmap;
  int err = f32_rows_map(&qmap, q, bhq, sq, D, BOX, L::BQ, 128);
  if (!err) err = keys ? f32_rows_map(&khmap, scratch + sc.kh, bhkv, skv, D, BOX, L::BKV, 128)
                       : f32_rows_map(&khmap, q, bhq, sq, D, BOX, L::BKV, 128);
  if (!err) err = keys ? f32_rows_map(&klmap, scratch + sc.kl, bhkv, skv, D, BOX, L::BKV, 128)
                       : f32_rows_map(&klmap, q, bhq, sq, D, BOX, L::BKV, 128);
  if (!err) err = keys ? f32_rows_map(&vhmap, scratch + sc.vth, bhkv, D, skv8, L::TW, D,
                                      L::TSWIZZLE)
                       : f32_rows_map(&vhmap, q, bhq, sq, D, BOX, L::BKV, 128);
  if (!err) err = keys ? f32_rows_map(&vlmap, scratch + sc.vtl, bhkv, D, skv8, L::TW, D,
                                      L::TSWIZZLE)
                       : f32_rows_map(&vlmap, q, bhq, sq, D, BOX, L::BKV, 128);
  if (err) return err;
  // Heads a group holds: whole kv groups whose K and V planes take at most
  // L2_KV_BYTES, or all of them.
  const int rep = hq / hkv;
  const size_t kv_bytes = (size_t)16 * (skv > 0 ? skv : 1) * D;   // four planes of a kv head
  const size_t fit = L2_KV_BYTES / kv_bytes;
  const int group = (fit < 1 ? 1 : fit < (size_t)bhkv ? (int)fit : bhkv) * rep;
  // One CTA an SM, each walking its share of the blocks.
  int device = 0, sms = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_attention_f32_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = bhq * ((sq + L::BQ - 1) / L::BQ);
  const dim3 grid(blocks < sms ? blocks : sms);
  const int slot = (int)(launch_count++ % SLOTS);
  flash_attention_f32_kernel<D><<<grid, THREADS, L::SMEM, stream>>>(
      qmap, khmap, klmap, vhmap, vlmap, out, lse, bhq, hq, hkv, sq, skv, window, scale_log2,
      group, slot);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of the scratch array that flash_attention_f32 needs for these
// sizes: K's hi and lo planes and V's transposed hi and lo planes.
extern "C" long long flash_attention_f32_scratch(int batch, int hkv, int skv, int d) {
  return skv > 0 ? scratch_layout(batch, hkv, skv, d).total : 0;
}

// q, out [batch, hq, sq, d]; k, v [batch, hkv, skv, d]: contiguous float32,
// 16-byte aligned, with hq a multiple of hkv and d one of 32, 64, 80, 128,
// 240. window <= 0 means no window. lse, if not null, is [batch, hq, sq] and
// gets each row's log-sum-exp of its scaled scores. scratch holds
// flash_attention_f32_scratch(...) floats, 256-byte aligned. Launches the
// pre-pass and the kernel on `stream` and returns the cudaError_t of the
// launches (or of encoding their tensor maps). bfloat16 inputs take
// flash_attention_tc.cu.
extern "C" int flash_attention_f32(const float* q, const float* k, const float* v, float* out,
                                   float* lse, float* scratch, int batch, int hq, int hkv,
                                   int sq, int skv, int d, int window, float scale,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * LOG2E;
  switch (d) {
    case 32:
      return launch<32>(q, k, v, out, lse, scratch, batch, hq, hkv, sq, skv, window, sl2, s);
    case 64:
      return launch<64>(q, k, v, out, lse, scratch, batch, hq, hkv, sq, skv, window, sl2, s);
    case 80:
      return launch<80>(q, k, v, out, lse, scratch, batch, hq, hkv, sq, skv, window, sl2, s);
    case 128:
      return launch<128>(q, k, v, out, lse, scratch, batch, hq, hkv, sq, skv, window, sl2, s);
    case 240:
      return launch<240>(q, k, v, out, lse, scratch, batch, hq, hkv, sq, skv, window, sl2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
