// The backward pass of causal (optionally windowed) attention with grouped kv
// heads, for bfloat16 inputs, on Hopper's tensor cores: from q, k, v, the
// forward's output O and row log-sum-exp L, and the output's gradient dO, the
// gradients dQ, dK and dV. The contract is that of flash_attention_bwd.cu,
// which keeps the float32 inputs: q, O, dO [B, Hq, Sq, D] and k, v
// [B, Hkv, Skv, D] with Hq a multiple of Hkv, q head h reading kv head
// h / (Hq / Hkv); query i sits at key position i + Skv - Sq and sees the keys
// at positions <= its own, and with a window only those > its own minus the
// window. With S = Q K^T * scale over the keys a row sees:
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
// FlashAttention-2 and -3; dS is formed from P before rounding.
// D = rowsum(dO * O) is a separate f32 pass over bf16 O and dO.
//
// What bounds it on the H100: operations. At the training shape (2 x 32 q
// heads, 2048 tokens, D = 80) the five products the gradient needs (S, dP,
// dQ, dK, dV) over the causal pairs are 107.4 GFLOP, against ~105 MB of bf16
// inputs and outputs: 0.109 ms at the bf16 tensor-core peak of 989 TFLOP/s,
// which only wgmma reaches. This layout computes seven (S and dP in both
// kernels), 150.4 GFLOP: 0.152 ms at that peak.
//
// What the design does about it. Three launches on one stream, no atomics,
// so that each output element is written once, after sums in a fixed order,
// and two runs give the same bits: a pass for D (eight lanes a row), a dK/dV
// kernel and a dQ kernel. Recomputing S and dP in the dQ kernel (seven
// products instead of five) is the price of needing no atomics. Both big
// kernels take the shape of the forward (flash_attention_tc.cu): a CTA of
// three warpgroups, one CTA an SM, walking blocks it takes from a counter in
// device memory, longest first. Warpgroup 0 is the producer: it gives up its
// registers (setmaxnreg.dec to 24), its warp 0 walks the blocks and tiles in
// step and that warp's lane 0 issues every copy by TMA from 3-D tensor maps
// [B * H, S, D] encoded on the host for each call, so a tile that runs past S
// arrives zero-filled and a store past S is clipped. Warpgroups 1 and 2 are
// the consumers (setmaxnreg.inc to 240), and every product is a wgmma with
// f32 accumulators in registers: `wgmma_ss` with both operands K-major in
// shared memory as TMA writes them, or `wgmma_rs_t` whose A operand is an
// accumulator rounded pairwise to bf16 in registers (the conversion the
// forward makes for P) and whose B is read MN-major through the transpose
// flag. No mma.sync is left.
// - dK/dV: a block is KEYS keys of one (batch, kv head); K and V land once
//   and stay. The producer streams, through a ring of STAGES stages with full
//   and empty barriers, the Q and dO tiles of BQ rows of each q head of the
//   group, only the tiles whose rows see some key of the block, and each
//   tile's L (times log2 e) and D by its warp's plain loads. Each consumer
//   owns 64 keys: per tile S^T = K Q^T and dP^T = V dO^T (wgmma_ss, A = its
//   rows of K or V), then in the accumulators, whose rows are keys and whose
//   columns are q rows, P^T = exp2(S^T scale log2 e - L) and
//   dS^T = P^T (dP^T - D), then dV += P^T dO and dK += dS^T Q (wgmma_rs_t,
//   B = dO or Q). A consumer runs no product on a tile none of whose pairs
//   its keys see (it waits for the tile and releases it). The GQA sum stays
//   in the accumulators.
// - dQ: a block is 128 q rows of one (batch, q head), 64 a consumer; Q and dO
//   land once; K and V tiles of BKV keys stream through the ring, only those
//   some row of the block may see. Per tile S = Q K^T and dP = dO V^T
//   (wgmma_ss), dS in registers, dQ += dS K (wgmma_rs_t, K MN-major).
// - Masks per element only on tiles that cross a consumer's diagonal, its
//   window edge, or the end of the keys or (dK/dV) the rows; interior tiles
//   skip them. Rows past Sq and keys past Skv load as zeros (L = D = 0); a
//   row that sees no key (L = -inf, where Sq > Skv) lies only on tiles that
//   cross the diagonal, where its P and dS are set to 0 by selection, never
//   computed as exp2(x - (-inf)).
// - Epilogues by TMA: dK and dV go into the consumer's own rows of the K and
//   V buffers (free once its last product has read them), dQ into a buffer
//   of its own (D <= 128) or into the consumer's rows of Q (D = 240, where
//   shared memory holds no third buffer). The K and V of a CTA's next block
//   (its Q and dO, for dQ) load once those stores have read the rows, then
//   its tiles. (Loading the next block's first tiles before that, into the
//   stages the last block left, was built and ran 0-7 % slower: PERF.md.)
// - Schedules: dK/dV takes key blocks first to last (under the causal mask
//   the first are seen by the most rows), heads side by side; dQ takes q
//   blocks last to first.
// - D = 240 (gemma3-12b: 3840 / 16 heads). A warpgroup cannot hold both f32
//   dK and dV of 64 keys at D = 240 (240 registers a thread), so the dK/dV
//   kernel splits its consumers by output over one block of 64 keys:
//   warpgroup 1 computes S^T and P^T and owns dV, warpgroup 2 computes dP^T
//   and owns dK; P^T (f32, masked, before rounding) goes through shared
//   memory in accumulator lane order, double-buffered, one named barrier a
//   tile, and dS^T is formed from it, so no product is computed twice.
//   dQ takes 48-key tiles, the forward's at D = 240.
// The head dims against the 128-byte swizzle are the forward's: D = 32 fills
// half of one 64-column box, D = 80 and 240 end in a partial box that TMA
// zero-fills; the products take D / 16 k-steps, each inside one box, and an
// N extent of exactly D.
//
// Registers and times. `-Xptxas -v` reports 168 registers (the launch bound)
// and no spill for every instance of both kernels; in the SASS the
// consumers reach, with the registers setmaxnreg moves to them, R135, R161,
// R177, R223 and R199 in the dK/dV kernel at D = 32, 64, 80, 128 and 240,
// and R105, R121, R129, R153 and R191 in the dQ kernel. At the training
// shapes (NVIDIA H100 80GB HBM3, 700.00 W; tools/flash_bwd_turns.py, device
// time of a call in turns with the mma.sync kernels this file held before):
// Qwen3-4B q [2,32,2048,80] 0.328-0.330 ms against 0.648-0.656 (dK/dV
// 0.176 ms at 49 % of the bf16 peak over its four products, dQ 0.135 at
// 48 % over its three, the D pass 0.020), 2.2x the seven-product bound and
// 0.66x SDPA's backward; OLMoE [2,16,2048,128] 0.227-0.230 against
// 0.516-0.528; Hymba [2,25,2048,64] window 1024 0.190-0.193 against
// 0.361-0.365; Whisper [8,16,448,64] 0.060 against 0.087; gemma3-12b
// [2,16,2048,240] window 1024 0.394-0.395 against 0.892-0.899, global
// 0.465-0.472 against 1.101-1.120. Built and measured slower there (PERF.md):
// blocks by a fixed round-robin (1.10-1.26x), one block a CTA (1.00-1.10x),
// two stages at D = 80 and 128 (1.02-1.04x), 128-row q tiles at D = 64
// (Whisper 1.11x, Hymba 0.98x), 128-key dQ tiles at D = 64 and 80
// (0.99-1.01x). Not built: pingpong between the consumers, S and dP shared
// between the two kernels (five products, ROADMAP), the D pass folded into a
// producer, L and D by TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int CONSUMERS = 2;             // consumer warpgroups of 64 keys or 64 q rows
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int DQ_ROWS = 64 * CONSUMERS;  // dQ kernel: q rows a block
constexpr int BOX = 64;                  // bf16 columns of one swizzled box (128 bytes)
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

// dK/dV kernel: keys a block, q rows a tile, stages of the ring.
template <int D> struct DkdvTiling;
template <> struct DkdvTiling<32> { static constexpr int KEYS = 128, BQ = 64, STAGES = 4; };
template <> struct DkdvTiling<64> { static constexpr int KEYS = 128, BQ = 64, STAGES = 4; };
template <> struct DkdvTiling<80> { static constexpr int KEYS = 128, BQ = 64, STAGES = 3; };
template <> struct DkdvTiling<128> { static constexpr int KEYS = 128, BQ = 64, STAGES = 3; };
template <> struct DkdvTiling<240> { static constexpr int KEYS = 64, BQ = 64, STAGES = 2; };

// dQ kernel: keys a tile, stages of the ring.
template <int D> struct DqTiling;
template <> struct DqTiling<32> { static constexpr int BKV = 64, STAGES = 4; };
template <> struct DqTiling<64> { static constexpr int BKV = 64, STAGES = 4; };
template <> struct DqTiling<80> { static constexpr int BKV = 64, STAGES = 3; };
template <> struct DqTiling<128> { static constexpr int BKV = 64, STAGES = 3; };
template <> struct DqTiling<240> { static constexpr int BKV = 48, STAGES = 2; };

// dK/dV shared memory: K and V of the block [BOXES][KEYS][64], STAGES Q and
// STAGES dO tiles [BOXES][BQ][64], STAGES rows of L log2 e and of D, at
// D = 240 two P^T tiles [64 keys x BQ] f32, then the barriers.
template <int D>
struct DkdvLayout {
  static constexpr int KEYS = DkdvTiling<D>::KEYS, BQ = DkdvTiling<D>::BQ;
  static constexpr int STAGES = DkdvTiling<D>::STAGES;
  static constexpr bool SPLIT = D > 128;   // consumers split by output (the note above)
  static constexpr int BOXES = (D + BOX - 1) / BOX;
  static constexpr uint32_t KV_BOX = KEYS * 128, Q_BOX = BQ * 128;
  static constexpr uint32_t KV_BYTES = BOXES * KV_BOX, Q_BYTES = BOXES * Q_BOX;
  static constexpr uint32_t K_AT = 0, V_AT = KV_BYTES, Q_AT = 2 * KV_BYTES;
  static constexpr uint32_t DO_AT = Q_AT + STAGES * Q_BYTES;
  static constexpr uint32_t L_AT = DO_AT + STAGES * Q_BYTES;
  static constexpr uint32_t D_AT = L_AT + STAGES * BQ * 4;
  static constexpr uint32_t P_AT = D_AT + STAGES * BQ * 4;
  static constexpr uint32_t P_TILE = 64 * BQ * 4;
  static constexpr uint32_t BAR_AT = P_AT + (SPLIT ? 2 * P_TILE : 0);
  // Barriers: K and V full and empty, then per stage full and empty.
  static constexpr uint32_t KV_FULL = BAR_AT, KV_EMPTY = BAR_AT + 8;
  static constexpr uint32_t TILE_FULL = BAR_AT + 16, TILE_EMPTY = TILE_FULL + 8 * STAGES;
  static constexpr uint32_t NEXT = TILE_EMPTY + 8 * STAGES;   // the block the consumers take next
  static constexpr uint32_t BYTES = NEXT + 8;
  static constexpr size_t SMEM = BYTES + 1024;   // slack to align the start to 1024
  static_assert(SMEM <= 232448, "a block's shared memory");
  static_assert(KEYS == (SPLIT ? 64 : 64 * CONSUMERS), "64 keys a consumer, or a shared 64");
};

// dQ shared memory: Q and dO of the block [BOXES][128][64], dQ staged for
// its store (a buffer of its own up to D = 128, else Q's), STAGES K and
// STAGES V tiles [BOXES][BKV][64], then the barriers.
template <int D>
struct DqLayout {
  static constexpr int BKV = DqTiling<D>::BKV, STAGES = DqTiling<D>::STAGES;
  static constexpr bool OWN_STAGE = D <= 128;
  static constexpr int BOXES = (D + BOX - 1) / BOX;
  static constexpr uint32_t Q_BOX = DQ_ROWS * 128, KV_BOX = BKV * 128;
  static constexpr uint32_t Q_BYTES = BOXES * Q_BOX, KV_BYTES = BOXES * KV_BOX;
  static constexpr uint32_t Q_AT = 0, DO_AT = Q_BYTES, DQ_AT = OWN_STAGE ? 2 * Q_BYTES : Q_AT;
  static constexpr uint32_t K_AT = (OWN_STAGE ? 3 : 2) * Q_BYTES;
  static constexpr uint32_t V_AT = K_AT + STAGES * KV_BYTES;
  static constexpr uint32_t BAR_AT = V_AT + STAGES * KV_BYTES;
  // Barriers: Q and dO full and empty, then per stage full and empty.
  static constexpr uint32_t Q_FULL = BAR_AT, Q_EMPTY = BAR_AT + 8;
  static constexpr uint32_t TILE_FULL = BAR_AT + 16, TILE_EMPTY = TILE_FULL + 8 * STAGES;
  static constexpr uint32_t NEXT = TILE_EMPTY + 8 * STAGES;
  static constexpr uint32_t BYTES = NEXT + 8;
  static constexpr size_t SMEM = BYTES + 1024;
  static_assert(SMEM <= 232448, "a block's shared memory");
};

// The work counters of a launch: the next block of the grid's order to hand
// out, and the CTAs that have found none left; the last of those sets both
// back to 0 for the next launch in the slot. Launches take the slots in
// turn (flash_attention_tc.cu keeps its own).
constexpr int SLOTS = 64;
__device__ unsigned int work_counters[SLOTS][2];
std::atomic<unsigned> launch_count{0};

// Rows [i_lo, i_hi] that see some key of [k_first, k_last]: from the first
// key's diagonal to the window's end of the last key (none if i_lo > i_hi).
__device__ __forceinline__ void rows_seeing(int k_first, int k_last, int sq, int skv, int window,
                                            int& i_lo, int& i_hi) {
  const int off = skv - sq;
  i_lo = max(0, k_first - off);
  i_hi = window > 0 ? (int)min((long long)sq - 1, (long long)k_last + window - 1 - off) : sq - 1;
}

// One block of the dK/dV kernel's order: kv head `kv_head` (b * hkv + h),
// keys [k0, k0 + KEYS), and the q tiles qt0 ... qt0 + n_qt - 1 of each q head
// of the group whose rows see some key of it. Key blocks first to last,
// the kv heads side by side.
struct KvBlock {
  int kv_head, k0, qt0, n_qt;
};

template <int D>
__device__ __forceinline__ KvBlock kv_block_at(int x, int kv_heads, int sq, int skv, int window) {
  using T = DkdvTiling<D>;
  KvBlock blk;
  blk.kv_head = x % kv_heads;
  blk.k0 = x / kv_heads * T::KEYS;
  int i_lo, i_hi;
  rows_seeing(blk.k0, min(blk.k0 + T::KEYS, skv) - 1, sq, skv, window, i_lo, i_hi);
  blk.qt0 = i_lo / T::BQ;
  blk.n_qt = i_hi >= i_lo ? i_hi / T::BQ - blk.qt0 + 1 : 0;
  return blk;
}

// One block of the dQ kernel's order: head bh (b * hq + h), rows
// [q0, q0 + 128), its kv head, and the key tiles [kb0, kb0 + n_tiles * BKV)
// some row of it may see. Query blocks last to first, the heads side by side.
struct QBlock {
  int bh, q0, kv_head, kb0, n_tiles;
};

template <int D>
__device__ __forceinline__ QBlock q_block_at(int x, int bhs, int hq, int hkv, int sq, int skv,
                                             int window) {
  constexpr int BKV = DqTiling<D>::BKV;
  const int nqb = (sq + DQ_ROWS - 1) / DQ_ROWS;
  QBlock blk;
  blk.bh = x % bhs;
  blk.q0 = (nqb - 1 - x / bhs) * DQ_ROWS;
  const int b = blk.bh / hq;
  blk.kv_head = b * hkv + (blk.bh - b * hq) / (hq / hkv);
  const int off = skv - sq;
  const int k_hi = min(skv, min(blk.q0 + DQ_ROWS, sq) + off) - 1;
  const int k_lo = window > 0 ? max(0, blk.q0 + off - window + 1) : 0;
  blk.kb0 = k_lo / BKV * BKV;
  blk.n_tiles = k_hi >= blk.kb0 ? (k_hi - blk.kb0) / BKV + 1 : 0;
  return blk;
}

// Two f32 as a bf16 pair, lo in the low half (the element with the lower
// index in a fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A 64 x N accumulator's thread values, scaled, as bf16 into rows `row` and
// row + 8 of a tile of swizzled boxes at `at` (`box` bytes a box): columns
// 8 n + 2 t, + 1 (the wgmma layout, hopper.cuh).
template <int N>
__device__ __forceinline__ void stage_rows(uint32_t at, uint32_t box, int row, int t,
                                           const float (&acc)[N / 2], float mult) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    const uint32_t a = at + (n / 8) * box + row * 128 + (((n % 8) ^ (row % 8)) << 4) + 4 * t;
    st_shared_u32(a, pack_bf16(acc[4 * n] * mult, acc[4 * n + 1] * mult));
    st_shared_u32(a + 8 * 128, pack_bf16(acc[4 * n + 2] * mult, acc[4 * n + 3] * mult));
  }
}

// acc (64 x N) = A B over D / 16 k-steps of 16 columns, each inside one box:
// A the 64 rows at `a` of boxes `a_box` bytes apart, B the N rows at `b` of
// boxes `b_box` apart, both K-major. Issued, not committed.
template <int D, int N>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], uint32_t a, uint32_t a_box,
                                         uint32_t b, uint32_t b_box) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t col = (ks % 4) * 32;   // bytes into the box's rows
    wgmma_ss<N>(acc, wgmma_desc(a + (ks / 4) * a_box + col, 16, 1024),
                wgmma_desc(b + (ks / 4) * b_box + col, 16, 1024), ks > 0);
  }
}

// acc (64 x D) += A B over K / 16 k-steps of 16 rows: A the fragments `af`,
// B the K rows at `b` of boxes `b_box` bytes apart, MN-major. Issued, not
// committed.
template <int D, int K>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2], const uint32_t (&af)[K / 16][4],
                                         uint32_t b, uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs_t<D>(acc, af[kk], wgmma_desc(b + kk * 16 * 128, b_box, 1024), 1);
}

// -- dK/dV --------------------------------------------------------------------

// Whether (key, row) is a pair the row sees (and both exist).
__device__ __forceinline__ bool sees(int key, int row, int sq, int skv, int off, int window) {
  const int qp = row + off;
  return row < sq && key < skv && key <= qp && (window <= 0 || key > qp - window);
}

// The transposed tile's P^T and dS^T from the S^T and dP^T accumulators of a
// consumer, whose thread holds keys `key` and key + 8 and, in n-tile n, q
// rows q0 + 8 n + 2 t, + 1; `lt` and `dt` are the tile's rows of L log2 e and
// D. Each rounded to bf16 as the A fragments of the k-steps of 16 rows that
// follow (n-tiles 2 kk and 2 kk + 1 make k-step kk); MASK sets the pairs a
// row may not see to 0.
template <int BQ, bool MASK>
__device__ __forceinline__ void p_ds_t(const float (&s)[BQ / 2], const float (&dp)[BQ / 2],
                                       uint32_t (&pa)[BQ / 16][4], uint32_t (&dsa)[BQ / 16][4],
                                       const float* lt, const float* dt, int key, int q0, int t,
                                       int sq, int skv, int off, int window, float scale_log2) {
#pragma unroll
  for (int n = 0; n < BQ / 8; ++n) {
    const float2 l = *reinterpret_cast<const float2*>(lt + 8 * n + 2 * t);
    const float2 d = *reinterpret_cast<const float2*>(dt + 8 * n + 2 * t);
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = ex2(fmaf(s[4 * n + e], scale_log2, -((e & 1) ? l.y : l.x)));
      ds[e] = p[e] * (dp[4 * n + e] - ((e & 1) ? d.y : d.x));
      if (MASK && !sees(key + 8 * (e >> 1), q0 + 8 * n + 2 * t + (e & 1), sq, skv, off, window))
        p[e] = ds[e] = 0.0f;
    }
    pa[n >> 1][2 * (n & 1)] = pack_bf16(p[0], p[1]);
    pa[n >> 1][2 * (n & 1) + 1] = pack_bf16(p[2], p[3]);
    dsa[n >> 1][2 * (n & 1)] = pack_bf16(ds[0], ds[1]);
    dsa[n >> 1][2 * (n & 1) + 1] = pack_bf16(ds[2], ds[3]);
  }
}

// The dK/dV producer, on warp 0 in step (lane 0 issues every copy and takes
// every block from the counter). For each block, once the consumers' stores
// have read the last block's K and V rows: the block's index, K and V, then
// its tiles. A tile is the Q and dO rows of one q head of the group, by TMA,
// and those rows' L log2 e and D (0 past Sq) by the warp's plain loads.
template <int D>
__device__ __forceinline__ void dkdv_produce(const CUtensorMap* qmap, const CUtensorMap* domap,
                                             const CUtensorMap* kmap, const CUtensorMap* vmap,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta, uint32_t base,
                                             float* lrows, float* drows, int kv_heads, int hq,
                                             int hkv, int sq, int skv, int window, int slot) {
  using L = DkdvLayout<D>;
  constexpr int BQ = L::BQ, STAGES = L::STAGES;
  const int lane = threadIdx.x & 31;
  const bool lead = lane == 0;
  const int group = hq / hkv;
  const int blocks = kv_heads * ((skv + L::KEYS - 1) / L::KEYS);
  unsigned int* counters = work_counters[slot];
  if (lead) {
    tma_prefetch(qmap);
    tma_prefetch(domap);
    tma_prefetch(kmap);
    tma_prefetch(vmap);
  }
  int it = 0;                   // tiles through the ring so far
  int x = blockIdx.x;
  for (int i = 0;; ++i) {
    if (i > 0) mbar_wait(base + L::KV_EMPTY, (i - 1) & 1);   // the last block's stores have read K, V
    if (x >= blocks) {
      if (lead) {
        st_shared_s32(base + L::NEXT, -1);
        mbar_arrive(base + L::KV_FULL);
      }
      break;
    }
    const KvBlock blk = kv_block_at<D>(x, kv_heads, sq, skv, window);
    const int b = blk.kv_head / hkv;
    const int head0 = b * hq + (blk.kv_head - b * hkv) * group;   // the group's first q head
    if (lead) {
      st_shared_s32(base + L::NEXT, x);
      mbar_arrive_expect(base + L::KV_FULL, 2 * L::KV_BYTES);
#pragma unroll
      for (int c = 0; c < L::BOXES; ++c) {
        tma_load_3d(base + L::K_AT + c * L::KV_BOX, kmap, base + L::KV_FULL, c * BOX, blk.k0,
                    blk.kv_head);
        tma_load_3d(base + L::V_AT + c * L::KV_BOX, vmap, base + L::KV_FULL, c * BOX, blk.k0,
                    blk.kv_head);
      }
    }
    for (int j = 0; j < group * blk.n_qt; ++j, ++it) {
      const int st = it % STAGES;
      if (it >= STAGES)    // both consumers are done with the tile STAGES back
        mbar_wait(base + L::TILE_EMPTY + 8 * st, ((it / STAGES) & 1) ^ 1);
      const int hg = j / blk.n_qt;
      const int q0 = (blk.qt0 + j - hg * blk.n_qt) * BQ;
      const int bh = head0 + hg;
#pragma unroll
      for (int r = lane; r < BQ; r += 32) {
        const bool in = q0 + r < sq;
        const size_t at = (size_t)bh * sq + q0 + r;
        lrows[st * BQ + r] = in ? lse[at] * LOG2E : 0.0f;
        drows[st * BQ + r] = in ? delta[at] : 0.0f;
      }
      __syncwarp();
      if (lead) {
        const uint32_t full = base + L::TILE_FULL + 8 * st;
        mbar_arrive_expect(full, 2 * L::Q_BYTES);
#pragma unroll
        for (int c = 0; c < L::BOXES; ++c) {
          tma_load_3d(base + L::Q_AT + st * L::Q_BYTES + c * L::Q_BOX, qmap, full, c * BOX, q0,
                      bh);
          tma_load_3d(base + L::DO_AT + st * L::Q_BYTES + c * L::Q_BOX, domap, full, c * BOX, q0,
                      bh);
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

// The q tiles [j_lo, j_hi) of each head of the block whose rows see some of
// the keys [kw, kw + 64).
template <int D>
__device__ __forceinline__ void kv_tiles_seen(const KvBlock& blk, int kw, int sq, int skv,
                                              int window, int& j_lo, int& j_hi) {
  constexpr int BQ = DkdvTiling<D>::BQ;
  j_lo = j_hi = 0;
  if (kw >= skv || blk.n_qt == 0) return;
  int i_lo, i_hi;
  rows_seeing(kw, min(kw + 63, skv - 1), sq, skv, window, i_lo, i_hi);
  if (i_lo > i_hi) return;
  j_lo = i_lo / BQ - blk.qt0;
  j_hi = i_hi / BQ - blk.qt0 + 1;
}

// Whether a tile of rows [q0, q0 + BQ) needs masks for the keys
// [kw, kw + 64): it crosses their diagonal, the window edge, or the end of
// the keys or of the rows.
template <int BQ>
__device__ __forceinline__ bool kv_edge(int kw, int q0, int sq, int skv, int window) {
  const int off = skv - sq;
  return kw + 63 > q0 + off || kw + 64 > skv || q0 + BQ > sq ||
         (window > 0 && kw <= q0 + BQ - 1 + off - window);
}

// The consumer warpgroup `cw` (0 or 1) of a dK/dV block whose K and V have
// landed, for D <= 128: keys blk.k0 + 64 cw ... + 63, its tiles the ring's
// `it`-th on. Ends with dK (scaled) and dV stored from its rows of the K and
// V buffers, and the K/V empty barrier passed.
template <int D>
__device__ __forceinline__ void dkdv_consume(const CUtensorMap* dkmap, const CUtensorMap* dvmap,
                                             uint32_t base, const float* lrows,
                                             const float* drows, int cw, const KvBlock& blk,
                                             int it, int group, int sq, int skv, int window,
                                             float scale_log2, float scale) {
  using L = DkdvLayout<D>;
  constexpr int BQ = L::BQ, STAGES = L::STAGES;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int off = skv - sq;
  const int n_qt = blk.n_qt, n_it = group * n_qt;
  const int kw = blk.k0 + 64 * cw;                       // this warpgroup's first key
  const uint32_t k_wg = base + L::K_AT + cw * 64 * 128;  // its rows of each K box
  const uint32_t v_wg = base + L::V_AT + cw * 64 * 128;
  int j_lo, j_hi;
  kv_tiles_seen<D>(blk, kw, sq, skv, window, j_lo, j_hi);

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;

  for (int j = 0; j < n_it; ++j) {
    const int st = (it + j) % STAGES;
    const uint32_t full = base + L::TILE_FULL + 8 * st, empty = base + L::TILE_EMPTY + 8 * st;
    mbar_wait(full, ((it + j) / STAGES) & 1);
    const int qt = j % n_qt;
    if (qt < j_lo || qt >= j_hi) {   // no key of this warpgroup is seen by the tile's rows
      mbar_arrive(empty);
      continue;
    }
    const uint32_t q_at = base + L::Q_AT + st * L::Q_BYTES;
    const uint32_t do_at = base + L::DO_AT + st * L::Q_BYTES;
    float s[BQ / 2], dp[BQ / 2];
    wgmma_fence();
    issue_ss<D, BQ>(s, k_wg, L::KV_BOX, q_at, L::Q_BOX);     // S^T = K Q^T
    issue_ss<D, BQ>(dp, v_wg, L::KV_BOX, do_at, L::Q_BOX);   // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(s);
    wgmma_hold(dp);
    const int q0 = (blk.qt0 + qt) * BQ;
    const int key = kw + 16 * warp + g;
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
    if (kv_edge<BQ>(kw, q0, sq, skv, window))
      p_ds_t<BQ, true>(s, dp, pa, dsa, lrows + st * BQ, drows + st * BQ, key, q0, t, sq, skv, off,
                       window, scale_log2);
    else
      p_ds_t<BQ, false>(s, dp, pa, dsa, lrows + st * BQ, drows + st * BQ, key, q0, t, sq, skv,
                        off, window, scale_log2);
    wgmma_hold(dk);
    wgmma_hold(dv);
    wgmma_hold(pa);
    wgmma_hold(dsa);
    wgmma_fence();
    issue_rs<D, BQ>(dv, pa, do_at, L::Q_BOX);    // dV += P^T dO
    issue_rs<D, BQ>(dk, dsa, q_at, L::Q_BOX);    // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(dk);
    wgmma_hold(dv);
    mbar_arrive(empty);
  }

  // dK and dV into this warpgroup's rows of the K and V buffers once all its
  // products have read them, then one TMA store a box, clipped past Skv and D.
  named_sync(1 + cw, 128);
  const int row = 64 * cw + 16 * warp + g;
  stage_rows<D>(base + L::K_AT, L::KV_BOX, row, t, dk, scale);
  stage_rows<D>(base + L::V_AT, L::KV_BOX, row, t, dv, 1.0f);
  fence_proxy_async();
  named_sync(1 + cw, 128);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < L::BOXES; ++c) {
      tma_store_3d(dkmap, k_wg + c * L::KV_BOX, c * BOX, kw, blk.kv_head);
      tma_store_3d(dvmap, v_wg + c * L::KV_BOX, c * BOX, kw, blk.kv_head);
    }
    tma_store_commit();
    tma_store_wait_read();
  }
  named_sync(1 + cw, 128);
  mbar_arrive(base + L::KV_EMPTY);
}

// The same at D = 240, consumers split by output over one block of 64 keys:
// warpgroup 1 (cw 0) computes S^T and P^T, stages P^T (f32, masked) in shared
// memory for warpgroup 2 and adds P^T dO into dV; warpgroup 2 (cw 1) computes
// dP^T, forms dS^T from the staged P^T one named barrier later (the two
// accumulators hold the same (key, row) pairs in the same lanes) and adds
// dS^T Q into dK. dV is staged in the K buffer, dK in V's.
template <int D>
__device__ __forceinline__ void dkdv_consume_split(const CUtensorMap* dkmap,
                                                   const CUtensorMap* dvmap, uint32_t base,
                                                   const float* lrows, const float* drows,
                                                   float* ptiles, int cw, const KvBlock& blk,
                                                   int it, int group, int sq, int skv, int window,
                                                   float scale_log2, float scale) {
  using L = DkdvLayout<D>;
  constexpr int BQ = L::BQ, STAGES = L::STAGES, NQ = BQ / 8;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int off = skv - sq;
  const int n_qt = blk.n_qt, n_it = group * n_qt;
  const int kw = blk.k0;
  const uint32_t a_at = base + (cw == 0 ? L::K_AT : L::V_AT);   // A of S^T or dP^T
  int j_lo, j_hi;
  kv_tiles_seen<D>(blk, kw, sq, skv, window, j_lo, j_hi);

  float acc[D / 2];   // dV (cw 0) or dK (cw 1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

  int seen = 0;       // tiles run so far: the P^T buffer is seen % 2
  for (int j = 0; j < n_it; ++j) {
    const int st = (it + j) % STAGES;
    const uint32_t full = base + L::TILE_FULL + 8 * st, empty = base + L::TILE_EMPTY + 8 * st;
    mbar_wait(full, ((it + j) / STAGES) & 1);
    const int qt = j % n_qt;
    if (qt < j_lo || qt >= j_hi) {
      mbar_arrive(empty);
      continue;
    }
    const uint32_t q_at = base + L::Q_AT + st * L::Q_BYTES;
    const uint32_t do_at = base + L::DO_AT + st * L::Q_BYTES;
    float x[BQ / 2];
    wgmma_fence();
    issue_ss<D, BQ>(x, a_at, L::KV_BOX, cw == 0 ? q_at : do_at, L::Q_BOX);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(x);
    const int q0 = (blk.qt0 + qt) * BQ;
    const int key = kw + 16 * warp + g;
    const bool edge = kv_edge<BQ>(kw, q0, sq, skv, window);
    const float* lt = lrows + st * BQ;
    const float* dt = drows + st * BQ;
    float4* pt = reinterpret_cast<float4*>(ptiles) + (seen & 1) * (64 * BQ / 4) +
                 warp * NQ * 32 + lane;   // this lane's P^T, n-tile 0
    uint32_t af[BQ / 16][4];
    if (cw == 0) {
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const float2 l = *reinterpret_cast<const float2*>(lt + 8 * n + 2 * t);
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = ex2(fmaf(x[4 * n + e], scale_log2, -((e & 1) ? l.y : l.x)));
          if (edge && !sees(key + 8 * (e >> 1), q0 + 8 * n + 2 * t + (e & 1), sq, skv, off,
                            window))
            p[e] = 0.0f;
        }
        pt[n * 32] = make_float4(p[0], p[1], p[2], p[3]);
        af[n >> 1][2 * (n & 1)] = pack_bf16(p[0], p[1]);
        af[n >> 1][2 * (n & 1) + 1] = pack_bf16(p[2], p[3]);
      }
      named_sync(3, 256);   // P^T is in
    } else {
      named_sync(3, 256);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const float4 p4 = pt[n * 32];
        const float p[4] = {p4.x, p4.y, p4.z, p4.w};
        const float2 d = *reinterpret_cast<const float2*>(dt + 8 * n + 2 * t);
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ds[e] = p[e] * (x[4 * n + e] - ((e & 1) ? d.y : d.x));
          if (edge && !sees(key + 8 * (e >> 1), q0 + 8 * n + 2 * t + (e & 1), sq, skv, off,
                            window))
            ds[e] = 0.0f;
        }
        af[n >> 1][2 * (n & 1)] = pack_bf16(ds[0], ds[1]);
        af[n >> 1][2 * (n & 1) + 1] = pack_bf16(ds[2], ds[3]);
      }
    }
    ++seen;
    wgmma_hold(acc);
    wgmma_hold(af);
    wgmma_fence();
    issue_rs<D, BQ>(acc, af, cw == 0 ? do_at : q_at, L::Q_BOX);   // dV += P^T dO, dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(acc);
    mbar_arrive(empty);
  }

  named_sync(1 + cw, 128);
  stage_rows<D>(a_at, L::KV_BOX, 16 * warp + g, t, acc, cw == 0 ? 1.0f : scale);
  fence_proxy_async();
  named_sync(1 + cw, 128);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < L::BOXES; ++c)
      tma_store_3d(cw == 0 ? dvmap : dkmap, a_at + c * L::KV_BOX, c * BOX, kw, blk.kv_head);
    tma_store_commit();
    tma_store_wait_read();
  }
  named_sync(1 + cw, 128);
  mbar_arrive(base + L::KV_EMPTY);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                                   const __grid_constant__ CUtensorMap domap,
                                   const __grid_constant__ CUtensorMap kmap,
                                   const __grid_constant__ CUtensorMap vmap,
                                   const __grid_constant__ CUtensorMap dkmap,
                                   const __grid_constant__ CUtensorMap dvmap,
                                   const float* __restrict__ lse, const float* __restrict__ delta,
                                   int kv_heads, int hq, int hkv, int sq, int skv, int window,
                                   float scale_log2, float scale, int slot) {
  using L = DkdvLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  float* lrows = reinterpret_cast<float*>(sbase + L::L_AT);
  float* drows = reinterpret_cast<float*>(sbase + L::D_AT);

  if (threadIdx.x == 0) {
    mbar_init(base + L::KV_FULL, 1);
    mbar_init(base + L::KV_EMPTY, 128 * CONSUMERS);
    for (int st = 0; st < L::STAGES; ++st) {
      mbar_init(base + L::TILE_FULL + 8 * st, 1);
      mbar_init(base + L::TILE_EMPTY + 8 * st, 128 * CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = __shfl_sync(FULL, threadIdx.x / 128, 0);
  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < 32)
      dkdv_produce<D>(&qmap, &domap, &kmap, &vmap, lse, delta, base, lrows, drows, kv_heads, hq,
                      hkv, sq, skv, window, slot);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int group = hq / hkv;
    int it = 0;
    for (int i = 0;; ++i) {
      mbar_wait(base + L::KV_FULL, i & 1);   // the block's index, K and V have landed
      const int x = ld_shared_s32(base + L::NEXT);
      if (x < 0) break;
      const KvBlock blk = kv_block_at<D>(x, kv_heads, sq, skv, window);
      if constexpr (L::SPLIT)
        dkdv_consume_split<D>(&dkmap, &dvmap, base, lrows, drows,
                              reinterpret_cast<float*>(sbase + L::P_AT), wg - 1, blk, it, group,
                              sq, skv, window, scale_log2, scale);
      else
        dkdv_consume<D>(&dkmap, &dvmap, base, lrows, drows, wg - 1, blk, it, group, sq, skv,
                        window, scale_log2, scale);
      it += group * blk.n_qt;
    }
  }
}

// -- dQ -----------------------------------------------------------------------

// The dQ producer, as the dK/dV one with the roles of the operands swapped:
// for each block, once the consumers are done with the last block's Q and dO
// rows, the block's index, Q and dO, then its K and V tiles.
template <int D>
__device__ __forceinline__ void dq_produce(const CUtensorMap* qmap, const CUtensorMap* domap,
                                           const CUtensorMap* kmap, const CUtensorMap* vmap,
                                           uint32_t base, int bhs, int hq, int hkv, int sq,
                                           int skv, int window, int slot) {
  using L = DqLayout<D>;
  constexpr int BKV = L::BKV, STAGES = L::STAGES;
  const bool lead = (threadIdx.x & 31) == 0;
  const int blocks = bhs * ((sq + DQ_ROWS - 1) / DQ_ROWS);
  unsigned int* counters = work_counters[slot];
  if (lead) {
    tma_prefetch(qmap);
    tma_prefetch(domap);
    tma_prefetch(kmap);
    tma_prefetch(vmap);
  }
  int it = 0;
  int x = blockIdx.x;
  for (int i = 0;; ++i) {
    if (i > 0) mbar_wait(base + L::Q_EMPTY, (i - 1) & 1);   // the last block is done with Q, dO
    if (x >= blocks) {
      if (lead) {
        st_shared_s32(base + L::NEXT, -1);
        mbar_arrive(base + L::Q_FULL);
      }
      break;
    }
    const QBlock blk = q_block_at<D>(x, bhs, hq, hkv, sq, skv, window);
    if (lead) {
      st_shared_s32(base + L::NEXT, x);
      mbar_arrive_expect(base + L::Q_FULL, 2 * L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < L::BOXES; ++c) {
        tma_load_3d(base + L::Q_AT + c * L::Q_BOX, qmap, base + L::Q_FULL, c * BOX, blk.q0,
                    blk.bh);
        tma_load_3d(base + L::DO_AT + c * L::Q_BOX, domap, base + L::Q_FULL, c * BOX, blk.q0,
                    blk.bh);
      }
    }
    for (int j = 0; j < blk.n_tiles; ++j, ++it) {
      const int st = it % STAGES;
      if (it >= STAGES) mbar_wait(base + L::TILE_EMPTY + 8 * st, ((it / STAGES) & 1) ^ 1);
      if (lead) {
        const int kb = blk.kb0 + j * BKV;
        const uint32_t full = base + L::TILE_FULL + 8 * st;
        mbar_arrive_expect(full, 2 * L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < L::BOXES; ++c) {
          tma_load_3d(base + L::K_AT + st * L::KV_BYTES + c * L::KV_BOX, kmap, full, c * BOX, kb,
                      blk.kv_head);
          tma_load_3d(base + L::V_AT + st * L::KV_BYTES + c * L::KV_BOX, vmap, full, c * BOX, kb,
                      blk.kv_head);
        }
      }
    }
    const unsigned taken = lead ? atomicAdd(&counters[0], 1u) : 0u;
    x = gridDim.x + (int)__shfl_sync(FULL, taken, 0);
  }
  if (lead && atomicAdd(&counters[1], 1u) == gridDim.x - 1) {
    atomicExch(&counters[0], 0u);
    atomicExch(&counters[1], 0u);
  }
}

// dS of one tile from the S and dP accumulators of a consumer, whose thread
// holds rows at key positions qpos[0] and qpos[1] (their L log2 e in lr, D in
// dr) and, in n-tile n, keys kb + 8 n + 2 t, + 1; rounded to bf16 as the A
// fragments of the k-steps of 16 keys of dS K. MASK sets the pairs a row may
// not see to 0.
template <int BKV, bool MASK>
__device__ __forceinline__ void ds_rows(const float (&s)[BKV / 2], const float (&dp)[BKV / 2],
                                        uint32_t (&dsa)[BKV / 16][4], const float (&lr)[2],
                                        const float (&dr)[2], int kb, const int (&qpos)[2], int t,
                                        int skv, int window, float scale_log2) {
#pragma unroll
  for (int n = 0; n < BKV / 8; ++n) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float p = ex2(fmaf(s[4 * n + e], scale_log2, -lr[r]));
      ds[e] = p * (dp[4 * n + e] - dr[r]);
      if (MASK) {
        const int key = kb + 8 * n + 2 * t + (e & 1);
        if (!(key <= qpos[r] && key < skv && (window <= 0 || key > qpos[r] - window)))
          ds[e] = 0.0f;
      }
    }
    dsa[n >> 1][2 * (n & 1)] = pack_bf16(ds[0], ds[1]);
    dsa[n >> 1][2 * (n & 1) + 1] = pack_bf16(ds[2], ds[3]);
  }
}

// The consumer warpgroup `cw` of a dQ block whose Q and dO have landed: rows
// q0 + 64 cw ... + 63, its tiles the ring's `it`-th on. Ends with dQ
// (scaled) stored by TMA, and the Q empty barrier passed once this
// warpgroup is done with its rows of Q and dO (and, where dQ is staged in
// Q, once the store has read them).
template <int D>
__device__ __forceinline__ void dq_consume(const CUtensorMap* dqmap, const float* __restrict__ lse,
                                           const float* __restrict__ delta, uint32_t base, int cw,
                                           const QBlock& blk, int it, int sq, int skv, int window,
                                           float scale_log2, float scale) {
  using L = DqLayout<D>;
  constexpr int BKV = L::BKV, STAGES = L::STAGES;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int kb0 = blk.kb0, n_tiles = blk.n_tiles;
  const int r0 = blk.q0 + 64 * cw;       // this warpgroup's first row
  const int qpos0 = r0 + skv - sq;       // and its key position
  const int qpos[2] = {qpos0 + 16 * warp + g, qpos0 + 16 * warp + g + 8};
  const bool live = r0 < sq;             // rows past Sq need no products
  const uint32_t q_wg = base + L::Q_AT + cw * 64 * 128;
  const uint32_t do_wg = base + L::DO_AT + cw * 64 * 128;
  const auto full = [&](int j) { return base + L::TILE_FULL + 8 * ((it + j) % STAGES); };
  const auto empty = [&](int j) { return base + L::TILE_EMPTY + 8 * ((it + j) % STAGES); };
  const auto phase = [&](int j) { return (uint32_t)(((it + j) / STAGES) & 1); };
  const auto pass = [&](int j) {
    mbar_wait(full(j), phase(j));
    mbar_arrive(empty(j));
  };

  // The tiles [j_lo, j_hi) this warpgroup's rows may see.
  int j_lo = 0, j_hi = 0;
  if (live && n_tiles > 0) {
    const int k_last = qpos0 + 63;
    const int k_first = window > 0 ? qpos0 - window + 1 : 0;
    j_hi = k_last >= kb0 ? min(n_tiles, (k_last - kb0) / BKV + 1) : 0;
    j_lo = k_first > kb0 ? (k_first - kb0) / BKV : 0;
    if (j_lo >= j_hi) j_lo = j_hi = 0;
  }
  // L log2 e and D of this thread's two rows; 0 past Sq.
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 16 * warp + g + 8 * r;
    const size_t at = (size_t)blk.bh * sq + row;
    lr[r] = row < sq ? lse[at] * LOG2E : 0.0f;
    dr[r] = row < sq ? delta[at] : 0.0f;
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;

  for (int j = 0; j < j_lo; ++j) pass(j);
  for (int j = j_lo; j < j_hi; ++j) {
    const int st = (it + j) % STAGES;
    const uint32_t k_at = base + L::K_AT + st * L::KV_BYTES;
    const uint32_t v_at = base + L::V_AT + st * L::KV_BYTES;
    float s[BKV / 2], dp[BKV / 2];
    mbar_wait(full(j), phase(j));
    wgmma_fence();
    issue_ss<D, BKV>(s, q_wg, L::Q_BOX, k_at, L::KV_BOX);     // S = Q K^T
    issue_ss<D, BKV>(dp, do_wg, L::Q_BOX, v_at, L::KV_BOX);   // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(s);
    wgmma_hold(dp);
    if (L::OWN_STAGE && j == j_hi - 1) mbar_arrive(base + L::Q_EMPTY);   // its last read of Q, dO
    const int kb = kb0 + j * BKV;
    uint32_t dsa[BKV / 16][4];
    if (kb + BKV - 1 > qpos0 || kb + BKV > skv || (window > 0 && kb <= qpos0 + 63 - window))
      ds_rows<BKV, true>(s, dp, dsa, lr, dr, kb, qpos, t, skv, window, scale_log2);
    else
      ds_rows<BKV, false>(s, dp, dsa, lr, dr, kb, qpos, t, skv, window, scale_log2);
    wgmma_hold(dq);
    wgmma_hold(dsa);
    wgmma_fence();
    issue_rs<D, BKV>(dq, dsa, k_at, L::KV_BOX);   // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(dq);
    mbar_arrive(empty(j));
  }
  if (L::OWN_STAGE && j_lo == j_hi) mbar_arrive(base + L::Q_EMPTY);   // no product read Q
  for (int j = j_hi; j < n_tiles; ++j) pass(j);

  if (!live) {
    if (!L::OWN_STAGE) mbar_arrive(base + L::Q_EMPTY);
    return;
  }
  // dQ into this warpgroup's rows of the staging buffer, once the store of
  // its last block has read them (own buffer) or its products are done with
  // Q (staged in Q); then one TMA store a box, clipped past Sq and D.
  if (L::OWN_STAGE && tid == 0) tma_store_wait_read();
  named_sync(1 + cw, 128);
  stage_rows<D>(base + L::DQ_AT, L::Q_BOX, 64 * cw + 16 * warp + g, t, dq, scale);
  fence_proxy_async();
  named_sync(1 + cw, 128);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < L::BOXES; ++c)
      tma_store_3d(dqmap, base + L::DQ_AT + c * L::Q_BOX + cw * 64 * 128, c * BOX, r0, blk.bh);
    tma_store_commit();
    if (!L::OWN_STAGE) tma_store_wait_read();
  }
  if (!L::OWN_STAGE) {
    named_sync(1 + cw, 128);
    mbar_arrive(base + L::Q_EMPTY);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                                 const __grid_constant__ CUtensorMap domap,
                                 const __grid_constant__ CUtensorMap kmap,
                                 const __grid_constant__ CUtensorMap vmap,
                                 const __grid_constant__ CUtensorMap dqmap,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 int bhs, int hq, int hkv, int sq, int skv, int window,
                                 float scale_log2, float scale, int slot) {
  using L = DqLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;

  if (threadIdx.x == 0) {
    mbar_init(base + L::Q_FULL, 1);
    mbar_init(base + L::Q_EMPTY, 128 * CONSUMERS);
    for (int st = 0; st < L::STAGES; ++st) {
      mbar_init(base + L::TILE_FULL + 8 * st, 1);
      mbar_init(base + L::TILE_EMPTY + 8 * st, 128 * CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = __shfl_sync(FULL, threadIdx.x / 128, 0);
  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < 32)
      dq_produce<D>(&qmap, &domap, &kmap, &vmap, base, bhs, hq, hkv, sq, skv, window, slot);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    int it = 0;
    for (int i = 0;; ++i) {
      mbar_wait(base + L::Q_FULL, i & 1);    // the block's index, Q and dO have landed
      const int x = ld_shared_s32(base + L::NEXT);
      if (x < 0) break;
      const QBlock blk = q_block_at<D>(x, bhs, hq, hkv, sq, skv, window);
      dq_consume<D>(&dqmap, lse, delta, base, wg - 1, blk, it, sq, skv, window, scale_log2,
                    scale);
      it += blk.n_tiles;
    }
    if ((threadIdx.x & 127) == 0) tma_store_wait_read();   // the last store has read its rows
  }
}

// -- D = rowsum(dO * O) ----------------------------------------------------------

// In f32, eight lanes a row, each reading 16 bytes of O and of dO at a time
// (a row's 128-byte lines whole), summed in a fixed order.
template <int D>
__global__ void __launch_bounds__(256)
flash_attention_bwd_delta_tc_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                    float* __restrict__ delta, long long rows) {
  const long long row = (long long)blockIdx.x * 32 + (threadIdx.x >> 3);
  const int sub = threadIdx.x & 7;
  float acc = 0.0f;
  if (row < rows) {
    const uint4* o16 = reinterpret_cast<const uint4*>(o + row * D);
    const uint4* d16 = reinterpret_cast<const uint4*>(dout + row * D);
    for (int c = sub; c < D / 8; c += 8) {
      const uint4 x = o16[c], y = d16[c];
      const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = __bfloat1622float2(x2[i]), b = __bfloat1622float2(y2[i]);
        acc = fmaf(b.x, a.x, acc);
        acc = fmaf(b.y, a.y, acc);
      }
    }
  }
#pragma unroll
  for (int s = 4; s > 0; s >>= 1) acc += __shfl_xor_sync(FULL, acc, s);
  if (row < rows && sub == 0) delta[row] = acc;
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
           const float* lse, float* delta, bf16* dq, bf16* dk, bf16* dv, int batch, int hq,
           int hkv, int sq, int skv, int window, float scale, cudaStream_t stream) {
  using KL = DkdvLayout<D>;
  using QL = DqLayout<D>;
  // Eleven maps, encoded for this call: each kernel's own boxes of Q, dO, K
  // and V, and the 64-row boxes its stores write.
  CUtensorMap kv_q, kv_do, kv_k, kv_v, kv_dk, kv_dv, q_q, q_do, q_k, q_v, q_dq;
  const int bhq = batch * hq, bhkv = batch * hkv;
  int err = bf16_rows_map(&kv_q, q, bhq, sq, D, KL::BQ);
  if (!err) err = bf16_rows_map(&kv_do, dout, bhq, sq, D, KL::BQ);
  if (!err) err = bf16_rows_map(&kv_k, k, bhkv, skv, D, KL::KEYS);
  if (!err) err = bf16_rows_map(&kv_v, v, bhkv, skv, D, KL::KEYS);
  if (!err) err = bf16_rows_map(&kv_dk, dk, bhkv, skv, D, 64);
  if (!err) err = bf16_rows_map(&kv_dv, dv, bhkv, skv, D, 64);
  if (!err) err = bf16_rows_map(&q_q, q, bhq, sq, D, DQ_ROWS);
  if (!err) err = bf16_rows_map(&q_do, dout, bhq, sq, D, DQ_ROWS);
  if (!err) err = bf16_rows_map(&q_k, k, bhkv, skv, D, QL::BKV);
  if (!err) err = bf16_rows_map(&q_v, v, bhkv, skv, D, QL::BKV);
  if (!err) err = bf16_rows_map(&q_dq, dq, bhq, sq, D, 64);
  if (err) return err;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_attention_bwd_dkdv_tc_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)KL::SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_attention_bwd_dq_tc_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)QL::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);

  const long long rows = (long long)bhq * sq;
  flash_attention_bwd_delta_tc_kernel<D>
      <<<(unsigned)((rows + 31) / 32), 256, 0, stream>>>(o, dout, delta, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const float sl2 = scale * LOG2E;
  // One CTA an SM each, walking its share of the blocks.
  const int kv_blocks = bhkv * ((skv + KL::KEYS - 1) / KL::KEYS);
  flash_attention_bwd_dkdv_tc_kernel<D>
      <<<kv_blocks < sms ? kv_blocks : sms, THREADS, KL::SMEM, stream>>>(
          kv_q, kv_do, kv_k, kv_v, kv_dk, kv_dv, lse, delta, bhkv, hq, hkv, sq, skv, window, sl2,
          scale, (int)(launch_count++ % SLOTS));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int q_blocks = bhq * ((sq + DQ_ROWS - 1) / DQ_ROWS);
  flash_attention_bwd_dq_tc_kernel<D>
      <<<q_blocks < sms ? q_blocks : sms, THREADS, QL::SMEM, stream>>>(
          q_q, q_do, q_k, q_v, q_dq, lse, delta, bhq, hq, hkv, sq, skv, window, sl2, scale,
          (int)(launch_count++ % SLOTS));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq [batch, hq, sq, d]; k, v, dk, dv [batch, hkv, skv, d]:
// contiguous bfloat16, 16-byte aligned; lse and delta [batch, hq, sq]
// float32 (lse as the forward wrote it; delta is scratch). hq a multiple of
// hkv, d one of 32, 64, 80, 128, 240, window <= 0 for none. Launches three kernels
// on `stream` and returns the cudaError_t of the launches (or of encoding
// their tensor maps).
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
