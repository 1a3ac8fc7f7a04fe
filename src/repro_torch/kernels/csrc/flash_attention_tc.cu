// Causal (optionally windowed) online-softmax attention with grouped kv heads,
// for bfloat16 q, k, v, on Hopper's tensor cores:
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
// the sums; the one new rounding is P to bf16 before P V, as in FlashAttention-2
// and -3, and the row sum l is taken over the rounded P, so the output is a
// convex combination of V rows.
//
// What bounds it on the H100: operations. At the serving main path's shape
// (8 x 32 heads, 2048 tokens, D = 80) the causal work is ~172 GFLOP over
// ~126 MB, ~1400 FLOP per byte, far above the card's ~295: the bound is the
// bf16 tensor-core peak, which only wgmma reaches. The kernel it replaces ran
// mma.sync with cp.async (Ampere's route) at 3.8-4.5x its bound.
//
// What the design does about it (FlashAttention-3's shape on Hopper): a block
// of three warpgroups owns 128 query rows of one (batch, q head) at a time.
// Warpgroup 0 is the producer: it gives up its registers (setmaxnreg.dec to
// 24), its warp 0 walks the blocks and tiles in step and that warp's lane 0
// issues every copy by TMA, from 3-D tensor maps
// [B * H, S, D] encoded on the host for each call, so a tile that runs past S
// arrives zero-filled instead of reading the next head's rows, and the store
// of O clips the same way. Q lands once a block; K and V tiles of BKV keys
// land in a ring of STAGES stages, K_j and V_j as separate transactions on
// their own full barriers, so S = Q K^T starts before V_j has landed, and a
// stage returns to the producer through its empty barrier once both consumer
// warpgroups' P V products that read it have retired. Warpgroups 1 and 2 are
// the consumers, 64 query rows each, their registers raised to 240
// (setmaxnreg.inc): S = Q K^T is D / 16 wgmma.m64nBKVk16 with Q and K both
// K-major in shared memory; the masks and the online softmax run on the S
// accumulator, whose layout per warp is mma.sync's m16n8 one repeated over
// BKV / 8, in log2 units with the scale folded into one FMA per score; P is
// rounded to bf16 in registers as the A operand of O += P V, BKV / 16
// wgmma.m64nDk16 with V MN-major in shared memory (the transpose flag), so P
// never touches shared memory. Masks are applied per element only on tiles
// that cross a warpgroup's diagonal, its window edge or the end of the keys;
// tiles no row of the block may see are never loaded, and a warpgroup runs
// no product on a tile none of its rows may see. The output is normalised by
// l, staged in a buffer of its own and stored by TMA while the next block's
// products run.
//
// The schedule. The grid is one CTA an SM. Blocks are ordered in groups of
// heads whose K and V fit 16 MB together (L2 holds 50 MB), each group's query
// blocks longest first; a CTA starts on one and then takes the next no CTA
// has taken from a counter in device memory, so the long causal blocks
// spread over the SMs as they come free (a fixed round-robin hands the
// busiest SM 27 % more key tiles than the mean at OLMoE's prefill), and the
// copies of a CTA's next block overlap the products and the store of the
// one before.
//
// The registers. The launch bound gives every thread 168; setmaxnreg moves
// the producer's to the consumers, whose code ptxas then allocates past 168
// (up to 194 registers at D = 128 and 180 at D = 240, no spill), which is
// what lets D = 240 hold its 120-register O beside 48-key tiles. The
// producer's loop runs on a whole warp in step, its values the same in every
// lane (uniform registers), so the warpgroup fits the 24 it keeps.
// Within a warpgroup the products of a tile run one after the other: S, the
// softmax, P V. The two consumers interleave on the tensor cores. The
// FlashAttention-3 overlap inside a warpgroup (S_{j+1} issued before the
// softmax of tile j) was built and measured slower at every shape, with the
// registers to hold it too: ptxas serialised its products (C7513; PERF.md,
// Findings).
//
// The head dims against the 128-byte swizzle. Every tile is a stack of boxes
// 64 columns wide (hopper.cuh), so D = 32 takes one box and D = 80 and 240
// end in a partial box, whose columns past D the TMA fills with zeros. No
// product reads those columns: S takes D / 16 k-steps (5 at D = 80, 15 at
// D = 240), each inside one box, and P V's N-extent is exactly D. They cost
// shared memory only, which the per-D tiling below allows for. A second,
// narrower swizzle for the last box would save that memory at the cost of a
// second descriptor and product per k-step; it was not built. The tiling:
// D <= 64 takes 64 keys a tile (128 ran Whisper's 224-token prompt 17 %
// slower, more of each causal tile masked; PERF.md), D = 80 and 128 take
// 128 in 2 stages (Q, the output buffer and the ring: 192 KB), and D = 240,
// whose O accumulator alone is 120 registers a thread, takes 48 in 2 stages
// (224 KB: 64 keys do not fit beside the output buffer).
//
// For training, a second kernel (flash_attention_tc_lse_kernel, chosen by a
// non-null `lse`) also keeps each row's sum of P before rounding and writes
// the row's log-sum-exp m + log l, which the backward pass
// (flash_attention_bwd_tc.cu) recomputes P from. The serving path passes null.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr int BQ = 128;                  // query rows per block: two consumer warpgroups of 64
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int BOX = 64;                  // bf16 columns of one swizzled box (128 bytes)
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr size_t L2_KV_BYTES = 16u << 20;   // K and V bytes a group of heads reads (L2: 50 MB)
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Keys per K / V tile and stages of the ring, by head dim.
template <int D> struct Tiling;
template <> struct Tiling<32> { static constexpr int BKV = 64, STAGES = 4; };
template <> struct Tiling<64> { static constexpr int BKV = 64, STAGES = 4; };
template <> struct Tiling<80> { static constexpr int BKV = 128, STAGES = 2; };
template <> struct Tiling<128> { static constexpr int BKV = 128, STAGES = 2; };
template <> struct Tiling<240> { static constexpr int BKV = 48, STAGES = 2; };

// Shared memory: Q [BOXES][BQ][64], the output staged for its store in the
// same layout, then STAGES K tiles and STAGES V tiles [BOXES][BKV][64], then
// the barriers; every box 1024-byte aligned.
template <int D>
struct Layout {
  static constexpr int BKV = Tiling<D>::BKV, STAGES = Tiling<D>::STAGES;
  static constexpr int BOXES = (D + BOX - 1) / BOX;
  static constexpr uint32_t Q_BOX = BQ * 128, KV_BOX = BKV * 128;
  static constexpr uint32_t Q_BYTES = BOXES * Q_BOX, KV_BYTES = BOXES * KV_BOX;
  static constexpr uint32_t O_AT = Q_BYTES, K_AT = 2 * Q_BYTES;
  static constexpr uint32_t V_AT = K_AT + STAGES * KV_BYTES;
  static constexpr uint32_t BAR_AT = V_AT + STAGES * KV_BYTES;
  // Barriers: Q full and Q empty, then per stage K full, V full and empty.
  static constexpr uint32_t Q_FULL = BAR_AT, Q_EMPTY = BAR_AT + 8;
  static constexpr uint32_t K_FULL = BAR_AT + 16, V_FULL = K_FULL + 8 * STAGES;
  static constexpr uint32_t EMPTY = V_FULL + 8 * STAGES;
  static constexpr uint32_t NEXT = EMPTY + 8 * STAGES;   // the block the producer loads next
  static constexpr uint32_t BYTES = NEXT + 8;
  static constexpr size_t SMEM = BYTES + 1024;   // slack to align the start to 1024
  static_assert(SMEM <= 232448, "a block's shared memory");
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
// first and its heads side by side, so the K and V of a group's heads stay
// in L2 while all its query blocks read them.
struct Block {
  int bh, q0, kv_head, kb0, n_tiles;
};

template <int BKV>
__device__ __forceinline__ Block block_at(int x, int group, int bhs, int hq, int hkv, int sq,
                                          int skv, int window) {
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

// Two f32 as a bf16 pair (lo in the low half, the element with the lower
// index in a fragment); `sum` gains the two rounded values.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi, float& sum) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  const float2 r = __bfloat1622float2(v);
  sum += r.x + r.y;
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S = Q K^T for one tile: D / 16 k-steps of 16 columns, each inside one box
// of Q (this warpgroup's 64 rows) and of the K stage. Issued, not waited for.
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[Layout<D>::BKV / 2], uint32_t q_wg,
                                        uint32_t k_at) {
  using L = Layout<D>;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t col = (ks % 4) * 32;   // bytes into the box's rows
    wgmma_ss<L::BKV>(s, wgmma_desc(q_wg + (ks / 4) * L::Q_BOX + col, 16, 1024),
                     wgmma_desc(k_at + (ks / 4) * L::KV_BOX + col, 16, 1024), ks > 0);
  }
  wgmma_commit();
}

// O += P V for one tile: BKV / 16 k-steps of 16 keys (rows of the V stage's
// boxes). Issued, not waited for.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[Layout<D>::BKV / 16][4],
                                         uint32_t v_at) {
  using L = Layout<D>;
#pragma unroll
  for (int kk = 0; kk < L::BKV / 16; ++kk)
    wgmma_rs_t<D>(o, pa[kk], wgmma_desc(v_at + kk * 16 * 128, L::KV_BOX, 1024), 1);
  wgmma_commit();
}

// The running state of a lane's two rows, g and g + 8 of its warp's 16.
struct Rows {
  float m[2] = {-INFINITY, -INFINITY};  // running max (log2 units)
  float l[2] = {0.0f, 0.0f};            // this lane's share of the running sum of rounded P
  float le[2] = {0.0f, 0.0f};           // the same over P before rounding (LSE only)
};

// The online softmax of one tile's scores `s` (keys kb ...): masks (MASK)
// where the tile crosses a row's diagonal, window or the end of the keys,
// the new running max, the factor `alpha` that rescales what came before,
// and P rounded to bf16 as the A fragments of BKV / 16 k-steps of 16 keys
// (n-tiles 2 kk and 2 kk + 1 give a0, a1 and a2, a3).
template <int BKV, bool LSE, bool MASK>
__device__ __forceinline__ void softmax_tile(const float (&s)[BKV / 2], uint32_t (&pa)[BKV / 16][4],
                                             float (&alpha)[2], Rows& rows, int kb,
                                             const int (&qpos)[2], int t, int skv, int window,
                                             float scale_log2) {
  // Score i of this lane, -inf where masked (the scores are only read, so
  // the accumulator is left as the product wrote it).
  const auto score = [&](int i) {
    if constexpr (!MASK) return s[i];
    const int kpos = kb + (i / 4) * 8 + 2 * t + (i & 1);
    const int qp = qpos[(i >> 1) & 1];
    const bool keep = kpos <= qp && kpos < skv && (window <= 0 || kpos > qp - window);
    return keep ? s[i] : -INFINITY;
  };
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {   // row g: elements 0, 1; row g + 8: 2, 3
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n)
      mx = fmaxf(mx, fmaxf(score(4 * n + 2 * r), score(4 * n + 2 * r + 1)));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    const float m_new = fmaxf(rows.m[r], mx * scale_log2);
    m_use[r] = m_new == -INFINITY ? 0.0f : m_new;   // row still fully masked
    alpha[r] = ex2(rows.m[r] - m_use[r]);           // 0 while the running max is -inf
    rows.m[r] = m_new;
  }
  float psum[2] = {0.0f, 0.0f};
  float pex[2] = {0.0f, 0.0f};
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = 4 * (2 * kk + h);
      const float p0 = ex2(fmaf(score(n), scale_log2, -m_use[0]));
      const float p1 = ex2(fmaf(score(n + 1), scale_log2, -m_use[0]));
      const float p2 = ex2(fmaf(score(n + 2), scale_log2, -m_use[1]));
      const float p3 = ex2(fmaf(score(n + 3), scale_log2, -m_use[1]));
      if (LSE) {
        pex[0] += p0 + p1;
        pex[1] += p2 + p3;
      }
      pa[kk][2 * h] = pack_bf16(p0, p1, psum[0]);
      pa[kk][2 * h + 1] = pack_bf16(p2, p3, psum[1]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rows.l[r] = rows.l[r] * alpha[r] + psum[r];
    if (LSE) rows.le[r] = rows.le[r] * alpha[r] + pex[r];
  }
}

// The consumer warpgroup `cw` (0 or 1) on a block whose Q has landed, rows
// q0 + 64 cw ... + 63 of it, whose tiles are the ring's `it`-th on.
template <int D, bool LSE>
__device__ __forceinline__ void consume_block(const CUtensorMap* omap, float* __restrict__ lse,
                                              uint32_t base, int cw, const Block& blk, int it,
                                              int sq, int skv, int window, float scale_log2) {
  using L = Layout<D>;
  constexpr int BKV = L::BKV, STAGES = L::STAGES;
  constexpr int NO = D / 8;        // n-tiles of 8 columns in O
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;         // fragment row (and row + 8)
  const int t = lane & 3;          // fragment column pair
  const int kb0 = blk.kb0, n_tiles = blk.n_tiles;
  const int r0 = blk.q0 + 64 * cw; // this warpgroup's first row
  const int qpos0 = r0 + skv - sq; // and its key position (query i sits at key i + Skv - Sq)
  const int qpos[2] = {qpos0 + 16 * warp + g, qpos0 + 16 * warp + g + 8};
  const bool live = r0 < sq;       // rows past Sq need no products
  const uint32_t q_wg = base + cw * 64 * 128;   // this warpgroup's rows of each Q box
  // Tile j of the block sits in stage (it + j) % STAGES of the ring.
  const auto stage = [&](int j) { return (it + j) % STAGES; };
  const auto phase = [&](int j) { return (uint32_t)(((it + j) / STAGES) & 1); };
  const auto k_full = [&](int j) { return base + L::K_FULL + 8 * stage(j); };
  const auto v_full = [&](int j) { return base + L::V_FULL + 8 * stage(j); };
  const auto empty = [&](int j) { return base + L::EMPTY + 8 * stage(j); };
  // A tile crosses this warpgroup's diagonal, the window edge of its last
  // row, or the end of the keys: its scores need masks.
  const auto edge = [&](int kb) {
    return kb + BKV - 1 > qpos0 || kb + BKV > skv || (window > 0 && kb <= qpos0 + 63 - window);
  };
  // A tile that no row of this warpgroup may see (past its last row's
  // diagonal, before its first row's window) is only waited for and
  // released: the stage is free only once both its copies have landed.
  const auto pass = [&](int j) {
    mbar_wait(k_full(j), phase(j));
    mbar_wait(v_full(j), phase(j));
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

  float o[D / 2];
#pragma unroll
  for (int k = 0; k < D / 2; ++k) o[k] = 0.0f;
  Rows rows;

  for (int j = 0; j < j_lo; ++j) pass(j);
  for (int j = j_lo; j < j_hi; ++j) {
    float s[BKV / 2];
    uint32_t pa[BKV / 16][4];
    float alpha[2];
    mbar_wait(k_full(j), phase(j));
    wgmma_fence();
    issue_s<D>(s, q_wg, base + L::K_AT + stage(j) * L::KV_BYTES);
    wgmma_wait<0>();
    wgmma_hold(s);
    if (j == j_hi - 1) mbar_arrive(base + L::Q_EMPTY);   // its last read of Q has retired
    const int kb = kb0 + j * BKV;
    if (edge(kb))
      softmax_tile<BKV, LSE, true>(s, pa, alpha, rows, kb, qpos, t, skv, window, scale_log2);
    else
      softmax_tile<BKV, LSE, false>(s, pa, alpha, rows, kb, qpos, t, skv, window, scale_log2);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[4 * n] *= alpha[0];
      o[4 * n + 1] *= alpha[0];
      o[4 * n + 2] *= alpha[1];
      o[4 * n + 3] *= alpha[1];
    }
    mbar_wait(v_full(j), phase(j));
    wgmma_hold(o);
    wgmma_hold(pa);
    wgmma_fence();
    issue_pv<D>(o, pa, base + L::V_AT + stage(j) * L::KV_BYTES);
    wgmma_wait<0>();
    wgmma_hold(o);
    mbar_arrive(empty(j));
  }
  if (j_lo == j_hi) mbar_arrive(base + L::Q_EMPTY);    // no product of this warpgroup read Q
  for (int j = j_hi; j < n_tiles; ++j) pass(j);

  // Normalise; keep the log-sum-exp of the rows in [0, Sq).
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = rows.l[r];
    l += __shfl_xor_sync(FULL, l, 1);
    l += __shfl_xor_sync(FULL, l, 2);
    inv[r] = l > 0.0f ? 1.0f / l : 0.0f;           // fully masked row -> 0
    if (LSE) {    // L = m + log l in natural units, over P before rounding; -inf if fully masked
      float le = rows.le[r];
      le += __shfl_xor_sync(FULL, le, 1);
      le += __shfl_xor_sync(FULL, le, 2);
      const int row = r0 + 16 * warp + g + 8 * r;
      if (t == 0 && row < sq)
        lse[(size_t)blk.bh * sq + row] = le == 0.0f ? -INFINITY : (rows.m[r] + log2f(le)) * LN2;
    }
  }
  if (!live) return;

  // O into this warpgroup's rows of the output boxes, in the swizzled layout
  // of Q, once the store of its previous block has read them; then one TMA
  // store per box, which clips rows past Sq and columns past D.
  if (tid == 0) tma_store_wait_read();
  named_sync(1 + cw, 128);
  const int row = 64 * cw + 16 * warp + g;   // row of the block; row + 8 swizzles alike
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const uint32_t at = base + L::O_AT + (n / 8) * L::Q_BOX + row * 128 +
                        (((n % 8) ^ (row % 8)) << 4) + 4 * t;
    float unused = 0.0f;
    st_shared_u32(at, pack_bf16(o[4 * n] * inv[0], o[4 * n + 1] * inv[0], unused));
    st_shared_u32(at + 8 * 128, pack_bf16(o[4 * n + 2] * inv[1], o[4 * n + 3] * inv[1], unused));
  }
  fence_proxy_async();
  named_sync(1 + cw, 128);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < L::BOXES; ++c)
      tma_store_3d(omap, base + L::O_AT + c * L::Q_BOX + cw * 64 * 128, c * BOX, r0, blk.bh);
    tma_store_commit();
  }
}

// The body of both kernels below; LSE also writes each row's log-sum-exp.
// One CTA an SM: each starts on block blockIdx.x and then takes the next
// block of the grid's order that no CTA has taken (`work_counters[slot]`),
// so the blocks, longest first, spread over the SMs as they come free, and
// the copies of a CTA's next block overlap the products and the store of
// the one before. The producer hands each block to the consumers through
// shared memory, published by the Q barrier; -1 ends the walk.
template <int D, bool LSE>
__device__ __forceinline__ void attend(const CUtensorMap* qmap, const CUtensorMap* kmap,
                                       const CUtensorMap* vmap, const CUtensorMap* omap,
                                       float* __restrict__ lse, int bhs, int hq, int hkv, int sq,
                                       int skv, int window, float scale_log2, int group,
                                       int slot) {
  using L = Layout<D>;
  constexpr int BKV = L::BKV, STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const int blocks = bhs * ((sq + BQ - 1) / BQ);

  if (threadIdx.x == 0) {
    mbar_init(base + L::Q_FULL, 1);
    mbar_init(base + L::Q_EMPTY, 128 * CONSUMERS);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(base + L::K_FULL + 8 * st, 1);
      mbar_init(base + L::V_FULL + 8 * st, 1);
      mbar_init(base + L::EMPTY + 8 * st, 128 * CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // The warpgroup, read from lane 0 so that the compiler sees it is the
  // same across each warp.
  const int wg = __shfl_sync(FULL, threadIdx.x / 128, 0);
  if (wg == 0) {
    // The producer: warp 0 walks the blocks and tiles in step (its values
    // the same in every lane, kept in uniform registers), and its lane 0
    // issues every copy and takes every block from the counter.
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      const bool lead = threadIdx.x == 0;
      unsigned int* counters = work_counters[slot];
      if (lead) {
        tma_prefetch(qmap);
        tma_prefetch(kmap);
        tma_prefetch(vmap);
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
        const Block blk = block_at<BKV>(x, group, bhs, hq, hkv, sq, skv, window);
        if (lead) {
          st_shared_s32(base + L::NEXT, x);
          mbar_arrive_expect(base + L::Q_FULL, L::Q_BYTES);
#pragma unroll
          for (int c = 0; c < L::BOXES; ++c)
            tma_load_3d(base + c * L::Q_BOX, qmap, base + L::Q_FULL, c * BOX, blk.q0, blk.bh);
        }
        for (int j = 0; j < blk.n_tiles; ++j, ++it) {
          const int st = it % STAGES;
          if (it >= STAGES)    // both consumers are done with the tile STAGES back
            mbar_wait(base + L::EMPTY + 8 * st, ((it / STAGES) & 1) ^ 1);
          if (lead) {
            const int kb = blk.kb0 + j * BKV;
            const uint32_t k_full = base + L::K_FULL + 8 * st, v_full = base + L::V_FULL + 8 * st;
            mbar_arrive_expect(k_full, L::KV_BYTES);
#pragma unroll
            for (int c = 0; c < L::BOXES; ++c)
              tma_load_3d(base + L::K_AT + st * L::KV_BYTES + c * L::KV_BOX, kmap, k_full,
                          c * BOX, kb, blk.kv_head);
            mbar_arrive_expect(v_full, L::KV_BYTES);
#pragma unroll
            for (int c = 0; c < L::BOXES; ++c)
              tma_load_3d(base + L::V_AT + st * L::KV_BYTES + c * L::KV_BOX, vmap, v_full,
                          c * BOX, kb, blk.kv_head);
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
      const Block blk = block_at<BKV>(x, group, bhs, hq, hkv, sq, skv, window);
      consume_block<D, LSE>(omap, lse, base, wg - 1, blk, it, sq, skv, window, scale_log2);
      it += blk.n_tiles;
    }
    if ((threadIdx.x & 127) == 0) tma_store_wait_read();   // the last store has read its rows
  }
}

// The serving path's kernel.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap omap, int bhs, int hq, int hkv,
                          int sq, int skv, int window, float scale_log2, int group, int slot) {
  attend<D, false>(&qmap, &kmap, &vmap, &omap, nullptr, bhs, hq, hkv, sq, skv, window,
                   scale_log2, group, slot);
}

// The training path's, which keeps each row's log-sum-exp.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_tc_lse_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const __grid_constant__ CUtensorMap omap, float* __restrict__ lse,
                              int bhs, int hq, int hkv, int sq, int skv, int window,
                              float scale_log2, int group, int slot) {
  attend<D, true>(&qmap, &kmap, &vmap, &omap, lse, bhs, hq, hkv, sq, skv, window, scale_log2,
                  group, slot);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int batch, int hq,
           int hkv, int sq, int skv, int window, float scale_log2, cudaStream_t stream) {
  using L = Layout<D>;
  // Four maps, encoded for this call. Without keys no tile is loaded, and the
  // K and V maps only need to be valid: they take q's.
  CUtensorMap qmap, kmap, vmap, omap;
  const bool keys = skv > 0;
  int err = bf16_rows_map(&qmap, q, batch * hq, sq, D, BQ);
  if (!err) err = bf16_rows_map(&kmap, keys ? k : q, keys ? batch * hkv : batch * hq,
                                keys ? skv : sq, D, L::BKV);
  if (!err) err = bf16_rows_map(&vmap, keys ? v : q, keys ? batch * hkv : batch * hq,
                                keys ? skv : sq, D, L::BKV);
  if (!err) err = bf16_rows_map(&omap, out, batch * hq, sq, D, 64);
  if (err) return err;
  // Heads a group holds: whole kv groups whose K and V take at most
  // L2_KV_BYTES, or all of them.
  const int rep = hq / hkv;
  const size_t kv_bytes = (size_t)4 * (skv > 0 ? skv : 1) * D;   // K and V of one kv head
  const size_t fit = L2_KV_BYTES / kv_bytes;
  const int group = (fit < 1 ? 1 : fit < (size_t)batch * hkv ? (int)fit : batch * hkv) * rep;
  // One CTA an SM, each walking its share of the blocks.
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = batch * hq * ((sq + BQ - 1) / BQ);
  const dim3 grid(blocks < sms ? blocks : sms);
  const int slot = (int)(launch_count++ % SLOTS);
  if (lse) {
    const auto kernel = flash_attention_tc_lse_kernel<D>;
    const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
    if (set != cudaSuccess) return static_cast<int>(set);
    kernel<<<grid, THREADS, L::SMEM, stream>>>(qmap, kmap, vmap, omap, lse, batch * hq, hq, hkv,
                                               sq, skv, window, scale_log2, group, slot);
  } else {
    const auto kernel = flash_attention_tc_kernel<D>;
    const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
    if (set != cudaSuccess) return static_cast<int>(set);
    kernel<<<grid, THREADS, L::SMEM, stream>>>(qmap, kmap, vmap, omap, batch * hq, hq, hkv, sq,
                                               skv, window, scale_log2, group, slot);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out [batch, hq, sq, d]; k, v [batch, hkv, skv, d]: contiguous bfloat16,
// 16-byte aligned, with hq a multiple of hkv and d one of 32, 64, 80, 128, 240.
// window <= 0 means no window. lse, if not null, is [batch, hq, sq] float32
// and gets each row's log-sum-exp of its scaled scores (-inf for a fully
// masked row), for the backward pass. Launches on `stream` and returns the
// cudaError_t of the launch (or of encoding its tensor maps).
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
