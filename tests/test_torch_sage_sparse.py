"""The schedule of the CUDA ``sage_aggregate`` kernels, walked in numpy on the CPU.

The kernels (``src/repro_torch/kernels/csrc/sage_aggregate.cu``) compute
``(A @ H) / max(rowsum(A), 1)`` from A's nonzeros in three launches:

- the index pass: a warp a row of A, a peeled head up to the first 16-byte
  boundary, float4 loads of the body (UNROLL a lane in flight, 32 lanes a
  chunk), the tail; the degree as lane partial sums and a butterfly; the
  entries (``a != 0``, NaN and ±Inf included) placed by ballots and
  popcounts into CAP slots a row in ascending column order, with the count;
- the gather: blocks of (client, column stripe of 32 V columns, WARPS x
  ROWS_PER_WARP rows), rows fastest; per row ``acc = fmaf(a, H[j], acc)``
  over its entries in ascending j (from the slots, or from A's row past
  CAP), divided once by ``max(deg, 1)``; each row's own H flags the
  (client, column) pairs that hold a NaN or ±Inf;
- the fix-up: every flagged column recomputed as a plain f32 dot of A's
  row and H's column (lane partial sums over j = lane, lane + 32, ..., then a
  butterfly), divided the same way.

Here each pass is walked in numpy with the kernel's constants read from the
``.cu`` source, on numpy-seeded inputs, and the result is held against the
plain version (``ref.sage_aggregate``), against the formula in float64 and,
on one input, against the JAX package's Pallas ``sage_aggregate`` run in
interpret mode, all within 1e-5 absolute plus 1e-5 relative (the CUDA
tests' tolerance), NaN where the plain version has NaN. The fused
multiply-add is emulated in float64 (the product of two f32 values is exact
there) and rounded to f32 once.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from test_torch_cuda_kernels import SAGE_NONFINITE, SAGE_NONFINITE_PAIRS

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
          / "sage_aggregate.cu").read_text()
TOL = 1e-5
F32 = np.float32


def _constexpr(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


CAP, WARPS, ROWS_PER_WARP, UNROLL = (_constexpr(x) for x in
                                     ("CAP", "WARPS", "ROWS_PER_WARP", "UNROLL"))
# The gather's instance by width: (largest d, V), then the widest V past them.
WIDTHS = [(int(d), int(v)) for d, v in re.findall(r"d <= (\d+)\) err = gather<(\d+)>", SOURCE)]
WIDEST = int(re.search(r"else err = gather<(\d+)>", SOURCE).group(1))
LANES = np.arange(32)


def _lanes_of(d: int) -> int:
    """V, the columns a lane takes in the gather instance the entry picks for d."""
    return next((v for top, v in WIDTHS if d <= top), WIDEST)


def _fma(a, x, acc):
    with np.errstate(invalid="ignore"):     # 0 x Inf is NaN, as on the card
        return (a.astype(np.float64) * x.astype(np.float64) + acc.astype(np.float64)).astype(F32)


def _butterfly(parts):
    """The xor butterfly over the last axis (32 lanes): lane 0's sum."""
    for off in (16, 8, 4, 2, 1):
        parts = parts + parts[..., LANES ^ off]
    return parts[..., 0]


def index_pass(a):
    """Slots [rows, CAP] (columns, values), counts and degrees of A [M, n, n],
    as the index kernel writes them (A's base 16-byte aligned)."""
    m, n, _ = a.shape
    rows = a.reshape(m * n, n)
    heads = np.minimum((4 - (np.arange(m * n) * n) % 4) % 4, n)
    cols = np.full((m * n, CAP), -1, np.int64)
    vals = np.zeros((m * n, CAP), F32)
    count = np.zeros(m * n, np.int64)
    deg = np.zeros(m * n, F32)
    for head in np.unique(heads):
        sel = np.flatnonzero(heads == head)
        x_rows = rows[sel]
        nvec = (n - head) // 4
        tail = head + 4 * nvec
        cnt = np.zeros(len(sel), np.int64)
        parts = np.zeros((len(sel), 32), F32)

        def take(x, col):
            """x [r, 32, 4]: each lane's four values at columns col[lane] + k."""
            nz = x != 0
            per_lane = nz.sum(-1)
            pos = (cnt[:, None, None] + (np.cumsum(per_lane, -1) - per_lane)[:, :, None]
                   + np.cumsum(nz, -1) - nz)
            r, lane, k = np.nonzero(nz & (pos < CAP))
            cols[sel[r], pos[r, lane, k]] = col[lane] + k
            vals[sel[r], pos[r, lane, k]] = x[r, lane, k]
            cnt[:] += per_lane.sum(-1)

        def scalar_chunk(first, k):
            x = np.zeros((len(sel), 32, 4), F32)
            x[:, :k, 0] = x_rows[:, first:first + k]
            return x, first + LANES

        x, col = scalar_chunk(0, head)
        parts += x[..., 0]
        take(x, col)
        for base in range(0, nvec, 32 * UNROLL):
            chunks = []
            for u in range(UNROLL):
                i = base + u * 32 + LANES
                x = np.zeros((len(sel), 32, 4), F32)
                ok = i < nvec
                x[:, ok] = x_rows[:, head + 4 * i[ok, None] + np.arange(4)]
                chunks.append((x, head + 4 * i))
            for x, col in chunks:
                parts += ((x[..., 0] + x[..., 1]) + x[..., 2]) + x[..., 3]
                take(x, col)
        x, col = scalar_chunk(tail, n - tail)
        parts += x[..., 0]
        take(x, col)
        count[sel] = cnt
        deg[sel] = _butterfly(parts)
    return cols, vals, count, deg


def _den(deg):
    return np.where(deg < 1, F32(1), deg)      # max(deg, 1), NaN kept


def gather(a, h, cols, vals, count, deg):
    """Every output row from its entries in ascending j, and the flags."""
    m, n, d = h.shape
    hr = h.reshape(m * n, d)
    base = np.repeat(np.arange(m) * n, n)
    acc = np.zeros((m * n, d), F32)
    for k in range(CAP):
        sel = np.flatnonzero((count <= CAP) & (count > k))
        acc[sel] = _fma(vals[sel, k, None], hr[base[sel] + cols[sel, k]], acc[sel])
    over = np.flatnonzero(count > CAP)
    if len(over):
        ar = a.reshape(m * n, n)[over]
        order = np.argsort(ar == 0, axis=1, kind="stable")   # entries first, ascending j
        for k in range(int(count[over].max())):
            live = count[over] > k
            j = order[live, k]
            acc[over[live]] = _fma(ar[live, j][:, None], hr[base[over[live]] + j],
                                   acc[over[live]])
    flags = ~np.isfinite(h).all(axis=1)                      # [M, d]
    with np.errstate(invalid="ignore"):
        return (acc / _den(deg)[:, None]).reshape(m, n, d), flags


def fixup(a, h, out, deg, flags):
    """Flagged columns as plain dots: lane partial sums over j = lane + 32 t."""
    m, n, d = h.shape
    out = out.copy()
    for b, c in zip(*np.nonzero(flags)):
        parts = np.zeros((n, 32), F32)
        for t in range(0, n, 32):
            j = t + LANES[t + LANES < n]
            parts[:, :len(j)] = _fma(a[b][:, j], h[b][j, c][None], parts[:, :len(j)])
        out[b, :, c] = _butterfly(parts) / _den(deg[b * n:(b + 1) * n])
    return out


def walk(a, h):
    cols, vals, count, deg = index_pass(a)
    # The slots hold each row's first CAP entries in ascending column order.
    for r in np.flatnonzero(count > 0)[:200]:
        nz = np.flatnonzero(a.reshape(-1, a.shape[-1])[r] != 0)
        assert len(nz) == count[r]
        np.testing.assert_array_equal(cols[r, :min(CAP, len(nz))], nz[:CAP])
    out, flags = gather(a, h, cols, vals, count, deg)
    return fixup(a, h, out, deg, flags)


def schedule_writes(m, n, d):
    """How many times the gather's blocks, warps and lanes write each output."""
    v = _lanes_of(d)
    stripes = -(-d // (32 * v))
    rows_a_block = ROWS_PER_WARP * WARPS
    row_blocks = -(-n // rows_a_block)
    block = np.arange(m * stripes * row_blocks)
    rb, bs = block % row_blocks, block // row_blocks
    stripe, b = bs % stripes, bs // stripes
    r, warp, lane, k = np.meshgrid(np.arange(ROWS_PER_WARP), np.arange(WARPS), LANES,
                                   np.arange(v), indexing="ij")
    i = (rb[:, None] * ROWS_PER_WARP + r.ravel()) * WARPS + warp.ravel()
    c = stripe[:, None] * 32 * v + lane.ravel() + 32 * k.ravel()
    ok = (i < n) & (c < d)
    writes = np.zeros((m, n, d), np.int64)
    np.add.at(writes, (np.broadcast_to(b[:, None], i.shape)[ok], i[ok], c[ok]), 1)
    return writes


def plain_f64(a, h):
    a64, h64 = a.astype(np.float64), h.astype(np.float64)
    with np.errstate(invalid="ignore"):
        return (a64 @ h64) / np.maximum(a64.sum(-1, keepdims=True), 1.0)


def _check(a, h):
    got = walk(a, h)
    want = ref.sage_aggregate(torch.from_numpy(a), torch.from_numpy(h))
    torch.testing.assert_close(torch.from_numpy(got), want, atol=TOL, rtol=TOL, equal_nan=True)
    torch.testing.assert_close(torch.from_numpy(got).double(), torch.from_numpy(plain_f64(a, h)),
                               atol=TOL, rtol=TOL, equal_nan=True)
    return got


def _sparse(rng, m, n, density):
    a = (rng.random((m, n, n)) < density).astype(F32) * rng.uniform(0.01, 2, (m, n, n)).astype(F32)
    return a / np.maximum(a.sum(-1, keepdims=True), 1).astype(F32)


def _cap_rows(rng, m, n):
    """Rows 0-5 of every client but the last with CAP - 1, CAP, CAP + 1, 0, 1
    and n entries, row r >= 6 with r % (CAP + 2); the last client empty."""
    a = np.zeros((m, n, n), F32)
    for b in range(m - 1):
        for r in range(n):
            k = (CAP - 1, CAP, CAP + 1, 0, 1, n)[r] if r < 6 else r % (CAP + 2)
            a[b, r, rng.permutation(n)[:k]] = rng.uniform(0.01, 2, k)
    return a


def test_constants_read_from_the_source():
    # The main path's fullest row (18 entries, 19 with GCN's self loop) fits
    # the slots; the gather's instances widen with d.
    assert CAP >= 19 and WARPS >= 1 and ROWS_PER_WARP >= 1 and UNROLL >= 1
    assert [v for _, v in WIDTHS] == sorted(v for _, v in WIDTHS) and WIDEST > WIDTHS[-1][1]


@pytest.mark.parametrize("m,n,d,density", [(2, 130, 129, 0.05), (1, 5, 1, 0.5),
                                           (3, 517, 77, 0.03), (2, 301, 33, 0.2),
                                           (1, 257, 300, 0.01), (2, 99, 64, 0.0)])
def test_walk_matches_plain_on_ragged_shapes(m, n, d, density):
    rng = np.random.default_rng(n + d)
    _check(_sparse(rng, m, n, density), rng.normal(size=(m, n, d)).astype(F32))


@pytest.mark.parametrize("d", [32, 77, 300])
def test_walk_at_the_index_capacity_and_an_empty_client(d):
    rng = np.random.default_rng(d)
    a = _cap_rows(rng, 3, 300)
    cols, vals, count, deg = index_pass(a)
    assert {CAP - 1, CAP, CAP + 1} <= set(count[:300].tolist()) and not count[600:].any()
    got = _check(a, rng.normal(size=(3, 300, d)).astype(F32))
    assert not got[2].any()


# Each of the CUDA tests' non-finite writes, and each pair, at n = 1001 (the
# h writes reach row 700) on a sparse adjacency that the index holds.
@pytest.mark.parametrize("writes", [(w,) for w in SAGE_NONFINITE] + SAGE_NONFINITE_PAIRS)
def test_walk_with_nonfinite_inputs(writes):
    rng = np.random.default_rng(len(writes))
    a = _sparse(rng, 2, 1001, 0.003)
    h = rng.normal(size=(2, 1001, 33)).astype(F32)
    for operand, bits, at in writes:
        (a if operand == "adj" else h).view(np.uint32)[at] = bits
    got = _check(a, h)
    assert not np.isfinite(got).all()


def test_walk_on_the_main_path_adjacency():
    """The FGL batch's own a_norm (Coauthor-CS cut to scale 0.05, 6 clients),
    as ``gnn.apply_sage`` makes it, at both layers' widths."""
    from repro_torch.core import gnn
    from repro_torch.launch import fgl_train
    batch, _, _ = fgl_train.build_data(fgl_train.parse(
        ["--dataset", "coauthor_cs", "--scale", "0.05", "--clients", "6", "--servers", "3"]))
    a = gnn.normalize_adjacency(torch.as_tensor(batch.adj), torch.as_tensor(batch.node_mask))
    a = a.numpy()
    assert 0 < (a != 0).sum(-1).max() <= CAP
    rng = np.random.default_rng(0)
    for d in (batch.x.shape[-1], 32):
        _check(a, rng.normal(size=a.shape[:2] + (d,)).astype(F32))


def test_walk_matches_the_jax_kernel_in_interpret_mode():
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    rng = np.random.default_rng(7)
    a = _cap_rows(rng, 2, 150)
    a = a / np.maximum(a.sum(-1, keepdims=True), 1).astype(F32)
    h = rng.normal(size=(2, 150, 40)).astype(F32)
    got = walk(a, h)
    for b in range(2):
        want = np.asarray(jops.sage_aggregate(jnp.asarray(a[b]), jnp.asarray(h[b]),
                                              interpret=True))
        np.testing.assert_allclose(got[b], want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("m,n,d", [(2, 130, 129), (1, 1001, 300), (3, 517, 77), (1, 65, 32),
                                   (2, 64, 64), (1, 6123, 5)])
def test_gather_schedule_writes_each_output_once(m, n, d):
    assert (schedule_writes(m, n, d) == 1).all()
