// Batched GraphSAGE neighbor mean: out[b] = (A[b] @ H[b]) / max(rowsum(A[b]), 1),
// in float32, as a gather over A's nonzeros.
//
// Replaces the TPU kernel `sage_aggregate` / `_sage_kernel` in
// src/repro/kernels/sage_aggregate.py (wrapper and custom VJP in
// src/repro/kernels/ops.py). The Pallas kernel is a dense product over a
// sequential (row, col, k) grid that carries the product and the row degree
// in VMEM scratch across k steps and divides on the last one. Here the same
// function is computed from A's nonzeros only, for every client in one call.
//
// What bounds it on the H100: bytes. On the FGL main paths A is a_norm, a
// normalised adjacency that is almost all zeros: SpreadFGL's Coauthor-CS
// batch (6 clients, n = 6123) holds 94,046 nonzeros over its six 6123^2
// adjacencies, at most 18 a row. The work those inputs need is to read A
// once (0.90 GB at layer 1), read H once (1.00 GB at d = 6805) and write the
// output once (1.00 GB): 2.90 GB, 0.87 ms at 3.35 TB/s. The products, 2
// operations per nonzero and column (1.3 GFLOP), take nothing. Layer 2
// (d = 32) is reading A: 0.27 ms.
//
// What the design does about it: three launches, each streaming what it must
// read once, with nothing of a dense n x n product left.
// - sage_index_kernel: one warp a row of A, read once with aligned float4
//   loads after a peeled head (n = 6123 and 914 are not multiples of 4, so
//   rows start off 16-byte boundaries; TMA and cp.async.bulk cannot take
//   them), four loads a lane in flight. It writes the row's degree (summed
//   in f32 over the row: lane partial sums, then a butterfly), its count of
//   entries with a != 0 (NaN and ±Inf count), and the first CAP of them as
//   (column, value) pairs in ascending column order (ballots and popcounts
//   place each lane's entries). It also zeroes the column flags.
// - sage_gather_kernel<V>: blocks walk (client, column stripe, 64 rows) with
//   the rows fastest, so every row of one client's stripe runs together and
//   the stripe of H they gather (n x 32V floats, 6.3 MB at V = 8) stays in
//   the 50 MB L2: H comes from HBM about once. A warp owns one output row of
//   the stripe, each lane V columns 32 apart (coalesced 4-byte loads: H's
//   rows are not 16-byte aligned either). It adds a * H[j, stripe] for the
//   row's entries in ascending j with fmaf, four rows of H in flight at a
//   time, divides once by max(deg, 1) and writes the output once. A row with
//   more than CAP entries walks its row of A instead, in ascending j: a dense
//   row is right, only slower. The warp also reads its own row of H's stripe
//   and flags every (client, column) that holds a NaN or ±Inf (a plain store
//   of 1, the same in any order): that is H read once, from L2 where the
//   gathers already brought it. So that a row waits on H alone, the warp
//   loads its rows' counts and degrees at once, one a lane, loads each row's
//   slot entries while the row before it is gathered, and tests its own H
//   only after the row's products.
// - sage_fixup_kernel: in a dense product a NaN or ±Inf in H[j, c] meets the
//   zeros of A and makes every output of column c NaN or ±Inf, which a
//   gather never sees. Each block reads the flags of 32 columns of a client
//   and exits if none is set (every call on finite inputs); otherwise each
//   flagged column is recomputed as the plain f32 dot of A's row and H's
//   column, read from global memory, which gives the IEEE result of the
//   plain version (such an output is NaN or ±Inf whatever the order of the
//   sum). A non-finite value in A needs nothing more: it is an entry of the
//   index, multiplied as the dense product multiplies it.
// No atomics and no float reductions across threads but the fixed-order
// butterflies: two calls give the same bits. Nothing is synchronised with
// the host. Scratch (the caller's, sage_aggregate_scratch_bytes): 8 * CAP + 8
// bytes a row and 4 a (client, column), 9.9 MB at layer 1 of Coauthor-CS.
//
// Why no tensor cores, TMA or wgmma: a row has fewer than 19 products to
// add at the main shapes, which is nothing to a tensor core, and the rows of
// A and H start 4-byte aligned, which TMA cannot address. The time is in
// moving bytes, and plain loads with enough of them in flight do that.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int CAP = 32;           // index slots a row: entries past it walk A's row
constexpr int WARPS = 8;          // warps a block, every kernel
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS_PER_WARP = 8;  // gather: rows a warp takes in its block's stripe
constexpr int GROUP = 4;          // gather: rows of H loaded before their products
constexpr int UNROLL = 4;         // index: float4 loads a lane has in flight
constexpr unsigned FULL = 0xffffffffu;

struct Scratch {
  int2* slots;   // [rows, CAP] (column, value bits)
  int* count;    // [rows]
  float* deg;    // [rows]
  int* flags;    // [batch, d] 1 where a column of H holds a NaN or ±Inf
};

inline size_t scratch_bytes(long long rows, long long flag_count) {
  return (size_t)rows * (CAP * sizeof(int2) + sizeof(int) + sizeof(float)) +
         (size_t)flag_count * sizeof(int);
}

inline Scratch carve(void* base, long long rows) {
  Scratch s;
  s.slots = static_cast<int2*>(base);
  s.count = reinterpret_cast<int*>(s.slots + (size_t)rows * CAP);
  s.deg = reinterpret_cast<float*>(s.count + rows);
  s.flags = reinterpret_cast<int*>(s.deg + rows);
  return s;
}

// The entries among a lane's four values x at columns col..col + 3 (the
// warp's lanes in column order), appended to the row's slots in ascending
// column order; cnt is the row's running count, the same in every lane.
__device__ __forceinline__ void take(float4 x, int col, int lane, int2* slot, int& cnt) {
  const bool nz[4] = {x.x != 0.0f, x.y != 0.0f, x.z != 0.0f, x.w != 0.0f};
  if (!__any_sync(FULL, nz[0] | nz[1] | nz[2] | nz[3])) return;
  const float v[4] = {x.x, x.y, x.z, x.w};
  const unsigned below = (1u << lane) - 1u;
  int pos = cnt, total = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned b = __ballot_sync(FULL, nz[k]);
    pos += __popc(b & below);
    total += __popc(b);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (nz[k]) {
      if (pos < CAP) slot[pos] = make_int2(col + k, __float_as_int(v[k]));
      ++pos;
    }
  }
  cnt += total;
}

__global__ void __launch_bounds__(THREADS)
sage_index_kernel(const float* __restrict__ adj, Scratch s, long long rows, int n,
                  long long flag_count) {
  for (long long k = (long long)blockIdx.x * THREADS + threadIdx.x; k < flag_count;
       k += (long long)gridDim.x * THREADS)
    s.flags[k] = 0;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* a = adj + (size_t)row * n;
  int2* slot = s.slots + (size_t)row * CAP;
  int head = (int)(((16u - (uint32_t)(reinterpret_cast<uintptr_t>(a) & 15u)) & 15u) >> 2);
  head = min(head, n);
  const int nvec = (n - head) >> 2;
  const int tail = head + 4 * nvec;
  int cnt = 0;
  float dg = 0.0f;

  float x = lane < head ? a[lane] : 0.0f;   // the head, one value a lane
  dg += x;
  take(make_float4(x, 0.0f, 0.0f, 0.0f), lane, lane, slot, cnt);
  const float4* body = reinterpret_cast<const float4*>(a + head);
  for (int base = 0; base < nvec; base += 32 * UNROLL) {
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * 32 + lane;
      v[u] = i < nvec ? __ldcs(body + i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      dg += v[u].x + v[u].y + v[u].z + v[u].w;
      take(v[u], head + 4 * (base + u * 32 + lane), lane, slot, cnt);
    }
  }
  x = tail + lane < n ? a[tail + lane] : 0.0f;   // the tail, up to 3 values
  dg += x;
  take(make_float4(x, 0.0f, 0.0f, 0.0f), tail + lane, lane, slot, cnt);

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dg += __shfl_xor_sync(FULL, dg, off);
  if (lane == 0) {
    s.count[row] = cnt;
    s.deg[row] = dg;
  }
}

// Lane's V columns c0 + 32 v of one client's stripe: out rows from the index.
template <int V>
__global__ void __launch_bounds__(THREADS, 3)
sage_gather_kernel(const float* __restrict__ adj, const float* __restrict__ h,
                   float* __restrict__ out, Scratch s, int n, int d, int stripes,
                   int row_blocks) {
  constexpr int W = 32 * V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rb = (int)(blockIdx.x % row_blocks);
  const int bs = (int)(blockIdx.x / row_blocks);
  const int stripe = bs % stripes, b = bs / stripes;
  const int c0 = stripe * W + lane;
  const float* H = h + (size_t)b * n * d + c0;
  bool ok[V];
#pragma unroll
  for (int v = 0; v < V; ++v) ok[v] = c0 + 32 * v < d;

  // The warp's rows are i0 + r * WARPS: lane r < ROWS_PER_WARP holds row r's
  // count and degree, and each row's first slot entries are loaded while
  // the row before it is gathered, so a row waits on H alone.
  const int i0 = rb * ROWS_PER_WARP * WARPS + warp;
  const size_t row0 = (size_t)b * n + i0;
  int my_cnt = 0;
  float my_deg = 0.0f;
  if (lane < ROWS_PER_WARP && i0 + lane * WARPS < n) {
    my_cnt = s.count[row0 + (size_t)lane * WARPS];
    my_deg = s.deg[row0 + (size_t)lane * WARPS];
  }
  auto entry = [&](int r, int cnt) {
    return lane < cnt && cnt <= CAP ? s.slots[(row0 + (size_t)r * WARPS) * CAP + lane]
                                    : make_int2(0, 0);
  };
  int cnt = __shfl_sync(FULL, my_cnt, 0);
  int2 e = entry(0, cnt);
  unsigned bad = 0;   // bit v: a NaN or ±Inf in column c0 + 32 v of a row's own H
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int i = i0 + r * WARPS;
    if (i >= n) break;
    const size_t row = row0 + (size_t)r * WARPS;
    float self[V];
#pragma unroll
    for (int v = 0; v < V; ++v) self[v] = ok[v] ? __ldg(H + (size_t)i * d + 32 * v) : 0.0f;
    const int next_cnt = __shfl_sync(FULL, my_cnt, (r + 1) & 31);   // 0 past the last row
    const int2 next = entry(r + 1, next_cnt);

    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    if (cnt <= CAP) {
      int k = 0;
      for (; k + GROUP <= cnt; k += GROUP) {
        float a[GROUP], x[GROUP][V];
#pragma unroll
        for (int u = 0; u < GROUP; ++u) {
          const int j = __shfl_sync(FULL, e.x, k + u);
          a[u] = __int_as_float(__shfl_sync(FULL, e.y, k + u));
          const float* hj = H + (size_t)j * d;
#pragma unroll
          for (int v = 0; v < V; ++v) x[u][v] = ok[v] ? __ldg(hj + 32 * v) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < GROUP; ++u)
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = fmaf(a[u], x[u][v], acc[v]);
      }
      for (; k < cnt; ++k) {
        const int j = __shfl_sync(FULL, e.x, k);
        const float a = __int_as_float(__shfl_sync(FULL, e.y, k));
        const float* hj = H + (size_t)j * d;
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (ok[v]) acc[v] = fmaf(a, __ldg(hj + 32 * v), acc[v]);
      }
    } else {
      // Past CAP entries: A's row, 32 columns at a time, entries in ascending j.
      const float* ar = adj + row * n;
      for (int j0 = 0; j0 < n; j0 += 32) {
        const float x = j0 + lane < n ? ar[j0 + lane] : 0.0f;
        unsigned m = __ballot_sync(FULL, x != 0.0f);
        while (m) {
          const int t = __ffs(m) - 1;
          m &= m - 1;
          const float a = __shfl_sync(FULL, x, t);
          const float* hj = H + (size_t)(j0 + t) * d;
#pragma unroll
          for (int v = 0; v < V; ++v)
            if (ok[v]) acc[v] = fmaf(a, __ldg(hj + 32 * v), acc[v]);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) bad |= (unsigned)!isfinite(self[v]) << v;
    const float dg = __shfl_sync(FULL, my_deg, r);
    const float den = dg < 1.0f ? 1.0f : dg;  // max(dg, 1), NaN kept
    float* o = out + row * d + c0;
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (ok[v]) o[32 * v] = acc[v] / den;
    cnt = next_cnt;
    e = next;
  }
  // Flag the columns (a plain store of 1: the same in any order).
  int* flags = s.flags + (size_t)b * d + c0;
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (bad >> v & 1u) flags[32 * v] = 1;
}

// Blocks of 32 columns of one client: the flagged ones recomputed densely.
__global__ void __launch_bounds__(THREADS)
sage_fixup_kernel(const float* __restrict__ adj, const float* __restrict__ h,
                  float* __restrict__ out, Scratch s, int n, int d, int col_blocks) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = (int)(blockIdx.x / col_blocks);
  const int c0 = (int)(blockIdx.x % col_blocks) * 32;
  unsigned m = __ballot_sync(FULL, c0 + lane < d && s.flags[(size_t)b * d + c0 + lane] != 0);
  if (m == 0) return;
  const float* A = adj + (size_t)b * n * n;
  const float* H = h + (size_t)b * n * d;
  while (m) {
    const int c = c0 + __ffs(m) - 1;
    m &= m - 1;
    for (int i = warp; i < n; i += WARPS) {
      const float* ar = A + (size_t)i * n;
      float acc = 0.0f;
      for (int j = lane; j < n; j += 32) acc = fmaf(ar[j], H[(size_t)j * d + c], acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(FULL, acc, off);
      if (lane == 0) {
        const float dg = s.deg[(size_t)b * n + i];
        out[((size_t)b * n + i) * d + c] = acc / (dg < 1.0f ? 1.0f : dg);
      }
    }
  }
}

template <int V>
cudaError_t gather(const float* adj, const float* h, float* out, Scratch s, int batch, int n,
                   int d, cudaStream_t stream) {
  const int stripes = (d + 32 * V - 1) / (32 * V);
  const int row_blocks = (n + ROWS_PER_WARP * WARPS - 1) / (ROWS_PER_WARP * WARPS);
  const unsigned blocks = (unsigned)batch * stripes * row_blocks;
  sage_gather_kernel<V><<<blocks, THREADS, 0, stream>>>(adj, h, out, s, n, d, stripes,
                                                        row_blocks);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the scratch that sage_aggregate_f32 takes for these sizes.
extern "C" long long sage_aggregate_scratch_bytes(int batch, int n, int d) {
  return (long long)scratch_bytes((long long)batch * n, (long long)batch * d);
}

// adj [batch, n, n], h [batch, n, d], out [batch, n, d]: contiguous float32 on
// the device; scratch: sage_aggregate_scratch_bytes(batch, n, d) bytes on the
// device, 8-byte aligned. Launches the index, gather and fix-up kernels on
// `stream` and returns the first cudaError_t among them.
extern "C" int sage_aggregate_f32(const float* adj, const float* h, float* out, void* scratch,
                                  int batch, int n, int d, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)batch * n;
  const Scratch s = carve(scratch, rows);
  const unsigned index_blocks = (unsigned)((rows + WARPS - 1) / WARPS);
  sage_index_kernel<<<index_blocks, THREADS, 0, st>>>(adj, s, rows, n, (long long)batch * d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d <= 32) err = gather<1>(adj, h, out, s, batch, n, d, st);
  else if (d <= 64) err = gather<2>(adj, h, out, s, batch, n, d, st);
  else if (d <= 128) err = gather<4>(adj, h, out, s, batch, n, d, st);
  else err = gather<8>(adj, h, out, s, batch, n, d, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int col_blocks = (d + 31) / 32;
  sage_fixup_kernel<<<(unsigned)batch * col_blocks, THREADS, 0, st>>>(adj, h, out, s, n, d,
                                                                    col_blocks);
  return static_cast<int>(cudaGetLastError());
}
