// Fused masked similarity top-k: for every query row r of q[b] (one edge
// server b), the k candidates j of h[b] maximising <q[b, r], h[b, j]> among
// those owned by another client (cid[b, j] != qcid[b, r]) and allowed as
// targets (mask[b, j] > 0). In the square call the query rows are the
// candidates (q = h, qcid = cid). In the general call they are another set,
// as in the TPU kernel, which takes `rows` apart from the candidate slab `h`:
// the ring top-k (core/ring_topk.py) scores its shard of query rows against
// each visiting slab of candidates, at a `col_offset` that makes the slab's
// indices global, and folds the result into its running list, which the
// merge kernel takes as one more chunk.
//
// Replaces the TPU kernel `sim_topk` / `_sim_topk_kernel` (with its merge
// `topk_merge`) in src/repro/kernels/sim_topk.py, wrapper in
// src/repro/kernels/ops.py. The Pallas kernel computes one gram tile on the
// MXU per grid step and folds it into a running top-k in VMEM by k argmax
// passes, walking the candidate axis in order.
//
// What bounds it on the H100: float32 operations, 2*n^2*c per server plus a
// compare per score; the inputs are a few MB and stay in L2. At the main
// path's shape (N = 3 servers, n = 12246 flat slots, c = 15 classes) the full
// gram is ~13.5 GFLOP, 0.201 ms at the 67 TFLOP/s CUDA-core peak; half of it
// pairs a row with its own client's candidates (2 clients per server), which
// the result never needs, so the work the data needs takes 0.101 ms. The
// n x n gram (1.8 GB for the three servers) must never reach device memory,
// and it does not. With one FMA issued per scheduler per cycle at best, what
// the kernel loses is issue slots spent on anything but FMAs (loads,
// compares, insertions into the running lists), FMA latency not covered by
// independent work, SMs left idle or unevenly loaded, and tiles scored for
// nothing.
//
// What the design does about it:
// - The candidate axis is split into `chunks` of `chunk_len` candidates (a
//   multiple of the 128-candidate tile), chosen per launch from the shape,
//   the SM count and the occupancy of the instance (sim_topk_plan): about
//   1.5 blocks per resident slot, so that both [3, 12246, 15] and
//   [1, 5484, 7] fill the 132 SMs. The grid is row tiles x chunks x servers.
//   Each block keeps a partial top-k per row for its chunk; a second kernel
//   folds the chunks' lists by (value desc, index asc), the rule of
//   topk_merge, so the result depends neither on the split nor on the order
//   in which blocks finish. Every chunk starts its lists empty, and a list
//   admits most of its first candidates, so more chunks cost more
//   insertions: the plan takes no more than it needs to fill the card.
// - A per-row bound shared by all chunks (atomicMax of each list's K-th
//   value, read back one tile later) lets a block reject scores that another
//   chunk's list already rules out.
// - Each thread owns R = 2 query rows and a sorted top-k in registers for
//   each. Two candidates read from shared memory (float4 broadcasts: every
//   lane reads the same address) are scored against both rows, each dot in
//   two partial sums (even and odd features): 8 independent FMA chains, all
//   summed before a single compare-and-branch per pair of candidates.
//   Features are zero-padded to CPAD = 8 or 16 (an instance per width), so
//   c = 7 (Cora) does not pay for 16.
// - Before staging anything, the block votes on every tile of its chunk
//   from the client ids and target flags alone: a tile is scored only if one
//   of its candidates is a target and, where the block's live rows all
//   belong to one client, another client's. At the main shape that drops
//   half of all tiles, and a block whose chunk is its rows' own client exits
//   at once.
// - Tiles are double-buffered: the features of the next useful tile arrive
//   by 4-byte cp.async (rows of c = 15 or 7 floats start off 16-byte
//   boundaries) while the current one is scored, copied from the tile's
//   count * c contiguous floats into the padded layout; client ids and
//   target flags are loaded into registers one tile ahead and stored after
//   scoring.
// - A score is admitted only if it beats the row's threshold (strict `>`),
//   so a candidate below it costs one compare; the client and target checks
//   run only then, and insertion is by selects. Candidates arrive in
//   ascending index within a chunk, so ties keep the smallest index; slots
//   never filled come out as (-inf, -1).
// - Scores of a row against two candidates with the same features are
//   bit-identical wherever the candidates lie, since each dot is summed in
//   one fixed order; exact ties are decided by index alone.
// - The merge takes a running list (vals, idx [batch, nq, k], global indices,
//   from an earlier call) as one more chunk, its indices shifted by
//   -col_offset into the slab's frame (an order-preserving shift), so a
//   fold over slabs gives the one call's result bit for bit, whatever the
//   order in which the slabs come. The fold costs one more list per row in
//   the merge and nothing in the scoring kernel: the running list does not
//   seed the shared bound.
//
// Why not the tensor cores: a 3xTF32 mma.sync product would reach f32
// accuracy, but spreads each row's scores over a quad of lanes, so every
// score would need a cross-lane exchange before the compare and insert that
// follow it, and c <= 16 fills at most two k-steps of 8: the split and the
// top-k bookkeeping would cost more issue slots than the FMAs they replace.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;          // threads per block
constexpr int R = 2;                  // query rows per thread
constexpr int ROWS = THREADS * R;     // query rows per block
constexpr int TC = THREADS;           // candidates per staged tile: one per thread for the flags
constexpr int STEP = 2;               // candidates scored together before a compare
constexpr int MIN_CHUNK = 2 * TC;     // shortest candidate chunk
constexpr int MAX_TILES = 128;        // longest chunk, in tiles (the block's tile bitmap)
constexpr int MAX_C = 16;             // widest feature row

// A mechanism taken out for timing by tools/sim_topk_ablation.py, one per
// build (-DSIM_TOPK_ABLATE=n): 1 admits no score (scoring alone), 2 shares no
// bound between chunks, 3 votes no tile out, 4 launches the merge alone.
// Every build of the port leaves it 0; builds 1 and 4 give wrong results.
#ifndef SIM_TOPK_ABLATE
#define SIM_TOPK_ABLATE 0
#endif
constexpr int ABLATE = SIM_TOPK_ABLATE;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// (s, j) precedes (v, i) in the order of topk_merge: larger value first,
// then smaller index.
__device__ __forceinline__ bool before(float s, int j, float v, int i) {
  return s > v || (s == v && j < i);
}

// Put (s, j) in the last slot of a sorted list and move it up past every
// entry it precedes, by selects. In the main kernel candidates arrive in
// ascending index, so the strict `>` alone keeps ties in index order; the
// merge compares indices too (TIES).
template <bool TIES, int K>
__device__ __forceinline__ void insert(float (&v)[K], int (&ix)[K], float s, int j) {
  v[K - 1] = s;
  ix[K - 1] = j;
#pragma unroll
  for (int t = K - 1; t > 0; --t) {
    const bool up = TIES ? before(v[t], ix[t], v[t - 1], ix[t - 1]) : v[t] > v[t - 1];
    const float a = v[t], b = v[t - 1];
    const int ia = ix[t], ib = ix[t - 1];
    v[t - 1] = up ? a : b;
    v[t] = up ? b : a;
    ix[t - 1] = up ? ia : ib;
    ix[t] = up ? ib : ia;
  }
}

// A float's order as a signed int (for atomicMax), and back. NaN is never
// encoded: no list holds one.
__device__ __forceinline__ int order_key(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float from_order_key(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// One block: query rows [row0, row0 + ROWS) of server blockIdx.z against the
// candidates of chunk blockIdx.y; writes each row's top-K of that chunk to
// part_v / part_i [batch, chunks, nq, K], with slab-local candidate indices.
// bound [batch, nq] holds, per row, the largest K-th value any chunk's list
// has reached, as order_key (INT_MIN before any, which decodes to a NaN that
// fmaxf passes over): a full list holds K allowed candidates, so no score
// below it can be among the row's k best, and a block admits none.
template <int K, int CPAD>
__global__ void __launch_bounds__(THREADS)
sim_topk_kernel(const float* __restrict__ q_rows, const int* __restrict__ qcid,
                const float* __restrict__ h, const int* __restrict__ cid,
                const float* __restrict__ mask, float* __restrict__ part_v,
                int* __restrict__ part_i, int* __restrict__ bound, int nq, int n, int c,
                int chunk_len) {
  constexpr int V = CPAD / 4;  // float4 per staged candidate
  __shared__ __align__(16) float hs[2][TC * CPAD];
  __shared__ int cs[2][TC];    // each staged candidate's client id
  __shared__ int ok[2][TC];    // ... and whether it may be a target at all
  __shared__ int first_client;
  __shared__ unsigned useful[MAX_TILES / 32];   // bit t: some row may take a candidate of tile t

  const size_t b = blockIdx.z;
  const float* H = h + b * (size_t)n * c;
  const int* C = cid + b * (size_t)n;
  const float* Mk = mask + b * (size_t)n;
  // The square call (the rows are h and cid themselves) reads its rows
  // through H and C: so built, the scoring loop is scheduled as it was
  // before the general form, 3 % faster at [3, 12246, 15] than through the
  // rows' own pointers (tools/sim_topk_ablation.py --against, in turns).
  const bool square = q_rows == h && qcid == cid && nq == n;
  const float* Q = square ? H : q_rows + b * (size_t)nq * c;
  const int* QC = square ? C : qcid + b * (size_t)nq;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  // This block's chunk: candidates [j_begin, j_end), in tiles of TC.
  const int chunk = blockIdx.y, chunks = gridDim.y;
  const int j_begin = min(n, chunk * chunk_len);
  const int j_end = min(n, j_begin + chunk_len);
  const int tiles = (j_end - j_begin + TC - 1) / TC;

  // Columns c..CPAD-1 of the staged rows are never copied to: zero them once.
  for (int e = tid; e < 2 * TC * CPAD; e += THREADS) (&hs[0][0])[e] = 0.0f;
  if (tid == 0) first_client = QC[row0];
  if (tid < MAX_TILES / 32) useful[tid] = 0u;

  float q[R][CPAD];
  int rc[R];
  bool live[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r * THREADS + tid;
    live[r] = row < nq;
#pragma unroll
    for (int t = 0; t < CPAD; ++t) q[r][t] = (live[r] && t < c) ? Q[(size_t)row * c + t] : 0.0f;
    rc[r] = live[r] ? QC[row] : 0;
  }
  float v[R][K];
  int ix[R][K];
  float thr[R];   // a score is admitted only above this: the list's K-th value,
                  // or just below the shared bound if that is higher
  int seen[R];    // the shared bound as the last atomic read it, folded in a tile later
  int* B = bound + b * (size_t)nq + row0 + tid;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int t = 0; t < K; ++t) {
      v[r][t] = -CUDART_INF_F;
      ix[r][t] = -1;
    }
    // What other chunks' blocks have published so far (L1 bypassed).
    seen[r] = live[r] ? __ldcg(B + r * THREADS) : order_key(-CUDART_INF_F);
    thr[r] = live[r] ? -CUDART_INF_F : CUDART_INF_F;
  }
  __syncthreads();   // the zeroed tiles, bitmap and first_client are visible
  bool same = true;
#pragma unroll
  for (int r = 0; r < R; ++r) same = same && (!live[r] || rc[r] == first_client);
  const bool one_client = __syncthreads_and(same);
  const int block_client = first_client;

  // Vote on every tile of the chunk before staging any: a tile is scored
  // only if one of its candidates is a target and, where the block's live
  // rows all belong to one client, another client's. A block with no such
  // tile writes empty lists at once.
#pragma unroll 4
  for (int t = 0; t < tiles; ++t) {
    const int j = j_begin + t * TC + tid;
    const bool take = j < j_end && (ABLATE == 3 ||
                                    (Mk[j] > 0.0f && (!one_client || C[j] != block_client)));
    if (__any_sync(0xffffffffu, take) && (tid & 31) == 0) atomicOr(&useful[t >> 5], 1u << (t & 31));
  }
  __syncthreads();
  // The first useful tile at or after t (tiles if none).
  auto next_tile = [&](int t) {
    for (int w = t >> 5; w < (tiles + 31) >> 5; ++w) {
      const unsigned bits = useful[w] & (w == t >> 5 ? ~0u << (t & 31) : ~0u);
      if (bits) return (w << 5) + __ffs(bits) - 1;
    }
    return tiles;
  };

  // This thread's share of a tile's features: elements e = tid + i * THREADS
  // of its count * c contiguous floats, element e at staged row e / c,
  // column e % c. The split of e is the same for every tile.
  const int step_row = THREADS / c, step_col = THREADS % c;
  auto copy_features = [&](int buf, int j0) {
    const int lim = min(TC, j_end - j0) * c;
    const float* src = H + (size_t)j0 * c;
    const uint32_t dst = smem_u32(&hs[buf][0]);
    int jr = tid / c, f = tid % c;
#pragma unroll
    for (int i = 0; i < MAX_C; ++i) {
      const int e = tid + i * THREADS;
      if (i < c && e < lim) cp_async4(dst + 4 * (jr * CPAD + f), src + e);
      jr += step_row;
      f += step_col;
      if (f >= c) {
        f -= c;
        ++jr;
      }
    }
  };
  // Flags of candidate j0 + tid: its client id, and whether it is a target.
  auto load_flags = [&](int j0, int& fc, int& fok) {
    const int j = j0 + tid;
    fc = j < j_end ? C[j] : 0;
    fok = j < j_end && Mk[j] > 0.0f;
  };

  int tile = next_tile(0);
  if (tile < tiles) {
    copy_features(0, j_begin + tile * TC);
    int fc, fok;
    load_flags(j_begin + tile * TC, fc, fok);
    cs[0][tid] = fc;
    ok[0][tid] = fok;
  }
  cp_async_commit();

  for (int cur = 0; tile < tiles; cur ^= 1) {
    const int nxt = cur ^ 1, tn = next_tile(tile + 1);
    const int j0 = j_begin + tile * TC;
    cp_async_wait_all();
    __syncthreads();   // the tile is staged for every thread; buffer nxt is free
    int fc = 0, fok = 0;
    if (tn < tiles) {
      copy_features(nxt, j_begin + tn * TC);
      load_flags(j_begin + tn * TC, fc, fok);
    }
    cp_async_commit();
    // Take in what other chunks' blocks had published by the last tile, and
    // publish this block's K-th values; the atomics' results are waited for
    // only at the next tile.
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!live[r]) continue;
      thr[r] = fmaxf(thr[r], nextafterf(from_order_key(seen[r]), -CUDART_INF_F));
      seen[r] = ABLATE == 2 ? order_key(v[r][K - 1])
                            : atomicMax(B + r * THREADS, order_key(v[r][K - 1]));
    }

    const float4* hv = reinterpret_cast<const float4*>(&hs[cur][0]);
    for (int jj = 0; jj < TC; jj += STEP) {
      // STEP candidates against every row, two partial sums each: 2 R STEP
      // independent chains, summed before any compare.
      float4 x[STEP][V];
#pragma unroll
      for (int e = 0; e < STEP; ++e)
#pragma unroll
        for (int u = 0; u < V; ++u) x[e][u] = hv[(jj + e) * V + u];
      float acc[STEP][R][2];
#pragma unroll
      for (int e = 0; e < STEP; ++e)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[e][r][0] = acc[e][r][1] = 0.0f;
#pragma unroll
      for (int u = 0; u < V; ++u)
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < STEP; ++e) {
            acc[e][r][0] = fmaf(q[r][4 * u], x[e][u].x, acc[e][r][0]);
            acc[e][r][1] = fmaf(q[r][4 * u + 1], x[e][u].y, acc[e][r][1]);
            acc[e][r][0] = fmaf(q[r][4 * u + 2], x[e][u].z, acc[e][r][0]);
            acc[e][r][1] = fmaf(q[r][4 * u + 3], x[e][u].w, acc[e][r][1]);
          }
      float sc[STEP][R];
      bool any = false;
#pragma unroll
      for (int e = 0; e < STEP; ++e)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          sc[e][r] = acc[e][r][0] + acc[e][r][1];
          any = any || sc[e][r] > thr[r];
        }
      // Rows in order, and each row's candidates in index order. (Under
      // ABLATE == 1, `n < 0` is never true, but keeps the scores computed.)
      if (any && (ABLATE != 1 || n < 0)) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < STEP; ++e) {
            if (sc[e][r] > thr[r] && ok[cur][jj + e] && cs[cur][jj + e] != rc[r]) {
              insert<false>(v[r], ix[r], sc[e][r], j0 + jj + e);
              thr[r] = fmaxf(thr[r], v[r][K - 1]);
            }
          }
      }
    }
    if (tn < tiles) {   // buffer nxt's flags were last read before this tile's barrier
      cs[nxt][tid] = fc;
      ok[nxt][tid] = fok;
    }
    tile = tn;
  }
  cp_async_wait_all();

  const size_t base = (b * chunks + chunk) * (size_t)nq;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!live[r]) continue;
    const size_t o = (base + row0 + r * THREADS + tid) * K;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      part_v[o + t] = v[r][t];
      part_i[o + t] = ix[r][t];
    }
  }
}

// One thread per query row: fold the chunks' sorted lists and the running
// list run_v / run_i [batch, nq, k] where given, by (value desc, index asc),
// and write the first k, indices shifted by col_offset, -1 where unfilled.
// The chunks' lists hold slab-local indices; the running list's global ones
// are taken in as local (i - col_offset, negative for an earlier slab's),
// the same order. An unfilled slot is one whose value is -inf: no list
// admits a -inf score.
template <int K>
__global__ void __launch_bounds__(THREADS)
sim_topk_merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                      const float* __restrict__ run_v, const int* __restrict__ run_i,
                      float* __restrict__ vals, int* __restrict__ idx, int nq, int k,
                      int chunks, int col_offset) {
  const size_t b = blockIdx.y;
  const int row = blockIdx.x * THREADS + threadIdx.x;
  if (row >= nq) return;
  float v[K];
  int ix[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    v[t] = -CUDART_INF_F;
    ix[t] = -1;
  }
  for (int s = 0; s < chunks; ++s) {
    const size_t o = ((b * chunks + s) * nq + row) * K;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const float x = part_v[o + t];
      const int i = part_i[o + t];
      // A list is sorted: once an entry is unfilled or does not beat the
      // last kept one, neither does any after it.
      if (i < 0 || !before(x, i, v[K - 1], ix[K - 1])) break;
      insert<true>(v, ix, x, i);
    }
  }
  const size_t out = (b * (size_t)nq + row) * k;
  if (run_v != nullptr) {
    // The running list, taken whole: nothing is assumed of its order.
    for (int t = 0; t < k; ++t) {
      const float x = run_v[out + t];
      const int i = run_i[out + t] - col_offset;
      if (x > -CUDART_INF_F && before(x, i, v[K - 1], ix[K - 1])) insert<true>(v, ix, x, i);
    }
  }
#pragma unroll
  for (int t = 0; t < K; ++t) {
    if (t < k) {
      vals[out + t] = v[t];
      idx[out + t] = v[t] > -CUDART_INF_F ? ix[t] + col_offset : -1;
    }
  }
}

template <int K_, int CPAD_>
struct Instance {
  static constexpr int K = K_, CPAD = CPAD_;
};

// Call f with the instance for top-k depth k and feature width c (both
// already checked to lie in 1..16): depth 4, 8 or 16, width 8 or 16.
template <class F>
int with_instance(int k, int c, F&& f) {
  const int depth = k <= 4 ? 4 : k <= 8 ? 8 : 16;
  switch (depth * 100 + (c <= 8 ? 8 : 16)) {
    case 408: return f(Instance<4, 8>());
    case 416: return f(Instance<4, 16>());
    case 808: return f(Instance<8, 8>());
    case 816: return f(Instance<8, 16>());
    case 1608: return f(Instance<16, 8>());
    default: return f(Instance<16, 16>());
  }
}

bool shape_ok(int batch, int nq, int n, int c, int k) {
  return batch >= 1 && nq >= 1 && n >= 1 && c >= 1 && c <= MAX_C && k >= 1 && k <= 16;
}

}  // namespace

// The split of the candidate axis for nq query rows against h [batch, n, c]
// and a top-k: plan[0] = chunks, plan[1] = chunk_len (candidates per chunk, a
// multiple of the 128-candidate tile), plan[2] = depth (entries per partial
// list, the instance's K >= k). The workspace sim_topk_rows_f32 takes is
// [batch, chunks, nq, depth] floats and as many ints. Returns a cudaError_t.
extern "C" int sim_topk_plan_rows(int batch, int nq, int n, int c, int k, int* plan) {
  if (!shape_ok(batch, nq, n, c, k)) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  return with_instance(k, c, [&](auto inst) {
    using I = decltype(inst);
    int per_sm = 0;
    const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sim_topk_kernel<I::K, I::CPAD>, THREADS, 0);
    if (occ != cudaSuccess) return static_cast<int>(occ);
    const long long base = (long long)((nq + ROWS - 1) / ROWS) * batch;
    const long long want = 3LL * sms * (per_sm > 0 ? per_sm : 1) / 2;
    long long chunks = (want + base - 1) / base;
    const long long most = (n + MIN_CHUNK - 1) / MIN_CHUNK;
    const long long least = (n + MAX_TILES * TC - 1) / (MAX_TILES * TC);
    chunks = chunks > most ? most : chunks;
    chunks = chunks < least ? least : chunks;
    const long long per = (n + chunks - 1) / chunks;
    const int len = (int)((per + TC - 1) / TC * TC);
    plan[0] = (n + len - 1) / len;
    plan[1] = len;
    plan[2] = I::K;
    return static_cast<int>(cudaSuccess);
  });
}

// The square call's plan (the rows are the n candidates), for sim_topk_f32.
extern "C" int sim_topk_plan(int batch, int n, int c, int k, int* plan) {
  return sim_topk_plan_rows(batch, n, n, c, k, plan);
}

// q [batch, nq, c] float32 and qcid [batch, nq] int32: the query rows; h
// [batch, n, c] float32, cid [batch, n] int32 and mask [batch, n] float32: the
// candidates; run_v / run_i [batch, nq, k] the running list to fold in
// (float32 / int32, global indices), or both null; part_v / part_i [batch,
// chunks, nq, depth] the workspace of sim_topk_plan_rows; bound [batch, nq]
// int32 filled with INT_MIN; vals [batch, nq, k] float32 and idx [batch, nq,
// k] int32 are written (never run_v / run_i themselves). All contiguous on the
// device; 1 <= k <= 16 (k may exceed n: the rest stays unfilled),
// 1 <= c <= 16, and chunks of chunk_len candidates (a multiple of 128, at
// most 128 tiles) must cover n. Launches both kernels on `stream` and
// returns the cudaError_t of the launches.
extern "C" int sim_topk_rows_f32(const float* q, const int* qcid, const float* h,
                                 const int* cid, const float* mask, const float* run_v,
                                 const int* run_i, float* part_v, int* part_i, int* bound,
                                 float* vals, int* idx, int batch, int nq, int n, int c, int k,
                                 int chunks, int chunk_len, int col_offset, void* stream) {
  if (!shape_ok(batch, nq, n, c, k) || chunks < 1 || chunk_len < TC || chunk_len % TC ||
      chunk_len > MAX_TILES * TC || (long long)chunks * chunk_len < n ||
      (run_v == nullptr) != (run_i == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_instance(k, c, [&](auto inst) {
    using I = decltype(inst);
    const dim3 grid((nq + ROWS - 1) / ROWS, chunks, batch);
    if (ABLATE != 4)
      sim_topk_kernel<I::K, I::CPAD><<<grid, THREADS, 0, s>>>(
          q, qcid, h, cid, mask, part_v, part_i, bound, nq, n, c, chunk_len);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 merge_grid((nq + THREADS - 1) / THREADS, batch);
    sim_topk_merge_kernel<I::K><<<merge_grid, THREADS, 0, s>>>(
        part_v, part_i, run_v, run_i, vals, idx, nq, k, chunks, col_offset);
    return static_cast<int>(cudaGetLastError());
  });
}

// The square call: every row of h [batch, n, c] against h itself, k <= n,
// with no running list; the workspace of sim_topk_plan.
extern "C" int sim_topk_f32(const float* h, const int* cid, const float* mask,
                            float* part_v, int* part_i, int* bound, float* vals, int* idx,
                            int batch, int n, int c, int k, int chunks, int chunk_len,
                            int col_offset, void* stream) {
  if (k > n) return static_cast<int>(cudaErrorInvalidValue);
  return sim_topk_rows_f32(h, cid, h, cid, mask, nullptr, nullptr, part_v, part_i, bound,
                           vals, idx, batch, n, n, c, k, chunks, chunk_len, col_offset,
                           stream);
}
