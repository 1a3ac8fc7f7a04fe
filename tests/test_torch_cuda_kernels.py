"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (inside the fixture, never at import) when
there is no CUDA device. On a machine with an H100 and nvcc they build the
kernels from ``src/repro_torch/kernels/csrc`` and run them:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_kernels.py -q

Tolerances: ``sage_aggregate`` sums an output's products in f32 in
ascending column order of A, another order than cuBLAS's, so values agree
within 1e-5 absolute plus 1e-5 relative;
``sim_topk`` scores within 1e-5 and indices exact except between candidates
whose scores lie within 1e-5 (``torch_parity.assert_topk_match``);
``flash_attention`` within 1e-5 in f32 (the f32 route's 3-pass TF32 split
holds each operand to ~2^-22, within f32's summation order) and 2e-2 in bf16 (the tensor-core route rounds P to bf16 before P V, and a bf16
output may round the other way by one unit in the last place); the
``flash_attention`` backward within 1e-5 of each gradient's max |value| in
f32, or within the plain version's own error against float64 where that is
larger (both sum up to Skv or Sq f32 products in other orders), and 2e-2 of
it in bf16 (the tensor-core route rounds P and dS to bf16 before their
products, and the gradients are rounded to bf16), the row log-sum-exp within
1e-5; ``sim_block``
within 1e-5 in f32 and 3e-2 in bf16, absolute and relative, the JAX tests'
own tolerances.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sage_aggregate as ksage
from repro_torch.kernels import sim_topk as ksim
from torch_parity import assert_topk_match, gram_rows

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _adj(gen, m, n, dev):
    a = (torch.rand((m, n, n), generator=gen, device=dev) < 0.05).float()
    a[:, 0] = 0.0                              # an isolated row: the clamp matters
    a = a * torch.rand((m, n, n), generator=gen, device=dev) * 2
    if n > 2:
        # A dense row of 1/3 (past the kernel's index capacity: its gather
        # walks A's row), and a row-normalised neighbour set (1/deg, as the
        # main path's a_norm).
        a[:, 1] = 1.0 / 3.0
        nb = (torch.rand((m, n), generator=gen, device=dev) < 0.1).float()
        a[:, 2] = nb / torch.clamp_min(nb.sum(-1, keepdim=True), 1.0)
    return a


# (operand, bits, (batch, row, column)): NaNs (the canonical NaN that GPU
# arithmetic produces, torch's default, negative with a full mantissa) and
# ±Inf, written into h or the adjacency.
SAGE_NONFINITE = [("h", 0x7FFFFFFF, (0, 3, 2)), ("h", 0x7FC00000, (0, 7, 4)),
                  ("h", 0xFFFFFFFF, (0, 9, 0)), ("h", 0x7F800000, (0, 700, 1)),
                  ("h", 0xFF800000, (0, 11, 30)), ("adj", 0x7FFFFFFF, (0, 5, 3)),
                  ("adj", 0x7F800000, (0, 6, 8)), ("adj", 0xFF800000, (0, 8, 12))]
# Writes that put two non-finite operands into one product: a -Inf in the
# adjacency against a +Inf and a -Inf in the same row of h (the split alone
# gives NaN there, the plain version -Inf and +Inf), and against -Inf alone.
SAGE_NONFINITE_PAIRS = [(("adj", 0xFF800000, (0, 5, 3)), ("h", 0x7F800000, (0, 3, 1)),
                         ("h", 0xFF800000, (0, 3, 2))),
                        (("adj", 0xFF800000, (0, 8, 12)), ("h", 0xFF800000, (0, 12, 30)))]


# Ragged shapes, then n and d with every remainder mod 4 (the index pass
# peels each row's head up to a 16-byte boundary), then the gather's
# instances (d <= 32, <= 64, <= 128, wider) and the widths past them; then
# each non-finite input at two instances, and each pair of them, which must
# give NaN and ±Inf where the plain version does.
@pytest.mark.parametrize("m,n,d,nonfinite", [
    *((m, n, d, None) for m, n, d in [
        (3, 1001, 77), (2, 130, 129), (1, 5, 1), (6, 257, 32), (2, 1001, 77), (1, 914, 1433),
        (2, 1002, 66), (1, 1003, 33), (2, 999, 1), (3, 517, 32), (2, 640, 64), (2, 641, 65)]),
    *((2, 1001, d, bad) for bad in SAGE_NONFINITE for d in (77, 33)),
    *((2, 1001, d, bad) for bad in SAGE_NONFINITE_PAIRS for d in (77, 33))])
def test_sage_forward_matches_plain(dev, m, n, d, nonfinite):
    gen = torch.Generator(device=dev).manual_seed(n + d if nonfinite else n)
    adj = _adj(gen, m, n, dev)
    h = torch.randn((m, n, d), generator=gen, device=dev)
    writes = (nonfinite,) if nonfinite and isinstance(nonfinite[0], str) else nonfinite or ()
    for operand, bits, at in writes:
        x = adj if operand == "adj" else h
        x.view(torch.int32)[at] = bits - (1 << 32) if bits >> 31 else bits  # the bits as they are
    before = ksage.launches
    got = ops.sage_aggregate(adj, h)
    torch.cuda.synchronize()
    assert ksage.launches == before + 1
    want = ref.sage_aggregate(adj, h)
    assert bool(torch.isfinite(want).all()) == (nonfinite is None)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5, equal_nan=True)


SAGE_CAP = int(re.search(r"constexpr int CAP = (\d+);", (
    Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
    / "sage_aggregate.cu").read_text()).group(1))


def _cap_adj(gen, m, n, dev):
    """Rows at the kernel's index capacity: rows 0-5 of every client but the
    last hold CAP - 1, CAP, CAP + 1, 0, 1 and n entries, row r >= 6 holds
    r % (CAP + 2); the last client has no edge at all."""
    a = torch.zeros((m, n, n), device=dev)
    for b in range(m - 1):
        for r in range(n):
            k = (SAGE_CAP - 1, SAGE_CAP, SAGE_CAP + 1, 0, 1, n)[r] if r < 6 else r % (SAGE_CAP + 2)
            cols = torch.randperm(n, generator=gen, device=dev)[:k]
            a[b, r, cols] = torch.rand((k,), generator=gen, device=dev) * 2 + 0.01
    return a


# The rows on both sides of the index's capacity and a client with no edge,
# at the three widths of the gather (d <= 32, <= 128, wider), finite and with
# each non-finite write: two calls bit for bit, and the plain version's values.
@pytest.mark.parametrize("d", [32, 77, 300])
@pytest.mark.parametrize("nonfinite", [None, *SAGE_NONFINITE, *SAGE_NONFINITE_PAIRS])
def test_sage_index_capacity_and_empty_client(dev, d, nonfinite):
    gen = torch.Generator(device=dev).manual_seed(d)
    adj = _cap_adj(gen, 3, 1001, dev)
    h = torch.randn((3, 1001, d), generator=gen, device=dev)
    writes = (nonfinite,) if nonfinite and isinstance(nonfinite[0], str) else nonfinite or ()
    for operand, bits, at in writes:
        x = adj if operand == "adj" else h
        x.view(torch.int32)[at] = bits - (1 << 32) if bits >> 31 else bits
    got = ops.sage_aggregate(adj, h)
    again = ops.sage_aggregate(adj, h)
    want = ref.sage_aggregate(adj, h)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert not got[2].any()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5, equal_nan=True)


@pytest.mark.parametrize("flags", [["--dataset", "coauthor_cs", "--scale", "0.05"],
                                   ["--dataset", "cora", "--scale", "1.0"]])
def test_sage_main_path_adjacency(dev, flags):
    """An FGL batch's own normalised adjacency, as ``gnn.apply_sage`` makes
    it, at both layers' widths; two calls bit for bit."""
    from repro_torch.core import gnn
    from repro_torch.launch import fgl_train
    batch, _, _ = fgl_train.build_data(fgl_train.parse(flags))
    a_norm = gnn.normalize_adjacency(torch.as_tensor(batch.adj).to(dev),
                                     torch.as_tensor(batch.node_mask).to(dev))
    gen = torch.Generator(device=dev).manual_seed(1)
    for width in (batch.x.shape[-1], 32):
        h = torch.randn(a_norm.shape[:2] + (width,), generator=gen, device=dev)
        got = ops.sage_aggregate(a_norm, h)
        assert torch.equal(got, ops.sage_aggregate(a_norm, h))
        torch.testing.assert_close(got, ref.sage_aggregate(a_norm, h), atol=1e-5, rtol=1e-5)


def test_sage_grads_match_plain(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    adj = _adj(gen, 3, 300, dev)
    h = torch.randn((3, 300, 20), generator=gen, device=dev)
    g = torch.randn((3, 300, 20), generator=gen, device=dev)
    grads = []
    for fn in (ops.sage_aggregate, ref.sage_aggregate):
        a = adj.clone().requires_grad_(True)
        x = h.clone().requires_grad_(True)
        torch.sum(fn(a, x) * g).backward()
        grads.append((a.grad, x.grad))
    torch.testing.assert_close(grads[0][1], grads[1][1], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(grads[0][0], grads[1][0], atol=1e-5, rtol=1e-5)


def test_sage_input_without_grad_gets_none(dev):
    """Layer 1's features need no gradient, and the backward computes none."""
    adj = torch.rand((2, 50, 50), device=dev)
    x = torch.randn((2, 50, 8), device=dev)
    w = torch.randn((8, 3), device=dev, requires_grad=True)
    torch.sum(ops.sage_aggregate(adj, x) @ w).backward()
    assert x.grad is None and w.grad is not None


def _sim(gen, nb, n, c, dev):
    h = torch.randn((nb, n, c), generator=gen, device=dev)
    h[:, 11] = h[:, 3]                         # exact duplicates: exact ties
    h[:, 40] = h[:, 3]
    cid = torch.repeat_interleave(torch.arange(4, dtype=torch.int32, device=dev),
                                  (n + 3) // 4)[:n]
    mask = (torch.rand((nb, n), generator=gen, device=dev) < 0.8).float()
    return h, cid, mask


@pytest.mark.parametrize("nb,n,c,k,off", [(3, 1237, 7, 4, 0), (1, 200, 15, 16, 0),
                                          (2, 129, 1, 3, 500)])
def test_sim_topk_matches_plain(dev, nb, n, c, k, off):
    gen = torch.Generator(device=dev).manual_seed(n + k)
    h, cid, mask = _sim(gen, nb, n, c, dev)
    before = ksim.launches
    kv, ki = ops.sim_topk(h, cid, mask, k, col_offset=off)
    torch.cuda.synchronize()
    assert ksim.launches == before + 1
    rv, ri = ref.sim_topk(h, cid, mask, k, col_offset=off)
    unshift = lambda i: np.where(i >= 0, i - off, -1)  # noqa: E731
    assert_topk_match(kv.cpu().numpy(), unshift(ki.cpu().numpy()), rv.cpu().numpy(),
                      unshift(ri.cpu().numpy()), gram_rows(h.cpu().numpy()), atol=1e-5)


def _chunked_n(nb, c, k, n_min, rem):
    """The smallest n >= n_min that the kernel splits into at least three
    chunks of L candidates with n % L == rem % L; returns (n, L)."""
    for n in range(n_min, n_min + 4096):
        chunks, chunk_len, _ = ksim.plan(nb, n, c, k)
        if chunks >= 3 and n % chunk_len == rem % chunk_len:
            return n, chunk_len
    raise AssertionError(f"no n >= {n_min} with n % L == {rem} % L")


def _client_ids(kind, n, gen, dev):
    """'blocks': contiguous runs of 1200 slots, as the main path's slot //
    n_pad, so whole row tiles and candidate tiles hold one client (tiles
    every row of a block must skip); 'scattered': ids that are neither
    contiguous nor small, drawn per slot."""
    if kind == "blocks":
        return (torch.arange(n, device=dev) // 1200).to(torch.int32)
    ids = torch.tensor([7, -3, 1000, 42], dtype=torch.int32, device=dev)
    return ids[torch.randint(0, 4, (n,), generator=gen, device=dev)]


# (nb, c, k, col_offset, rem, clients): n just above (rem 1) or just below
# (rem -1) a multiple of the chunk length, with copies of row 3 on both sides
# of chunk edges (exact ties across chunks), at every top-k depth and feature
# width the kernel is instantiated for.
@pytest.mark.parametrize("nb,c,k,off,rem,clients", [
    (2, 15, 4, 0, 1, "blocks"), (2, 15, 4, 0, -1, "scattered"), (1, 16, 16, 300, 1, "scattered"),
    (1, 1, 16, 0, -1, "blocks"), (3, 7, 8, 0, 1, "blocks"), (2, 3, 2, 11, -1, "scattered")])
def test_sim_topk_across_chunks(dev, nb, c, k, off, rem, clients):
    n, chunk_len = _chunked_n(nb, c, k, 2500, rem)
    gen = torch.Generator(device=dev).manual_seed(n + c + k)
    h = torch.randn((nb, n, c), generator=gen, device=dev)
    for j in (chunk_len - 1, chunk_len, 2 * chunk_len + 3, n - 1):
        h[:, j] = h[:, 3]
    cid = _client_ids(clients, n, gen, dev)
    mask = (torch.rand((nb, n), generator=gen, device=dev) < 0.8).float()
    before = ksim.launches
    kv, ki = ops.sim_topk(h, cid, mask, k, col_offset=off)
    torch.cuda.synchronize()
    assert ksim.launches == before + 1
    rv, ri = ref.sim_topk(h, cid, mask, k, col_offset=off)
    unshift = lambda i: np.where(i >= 0, i - off, -1)  # noqa: E731
    assert_topk_match(kv.cpu().numpy(), unshift(ki.cpu().numpy()), rv.cpu().numpy(),
                      unshift(ri.cpu().numpy()), gram_rows(h.cpu().numpy()), atol=1e-5)


@pytest.mark.parametrize("c,k", [(4, 4), (3, 16)])
def test_sim_topk_exact_ties_across_chunks(dev, c, k):
    """Small integer features make every score an integer, exact in any
    summation order, and most of them tied: the indices must be the plain
    version's exactly, smallest index first, however the chunks split them."""
    n, _ = _chunked_n(2, c, k, 2500, 5)
    gen = torch.Generator(device=dev).manual_seed(c * k)
    h = torch.randint(-2, 3, (2, n, c), generator=gen, device=dev).float()
    cid = _client_ids("scattered", n, gen, dev)
    mask = (torch.rand((2, n), generator=gen, device=dev) < 0.8).float()
    kv, ki = ops.sim_topk(h, cid, mask, k)
    rv, ri = ref.sim_topk(h, cid, mask, k)
    assert torch.equal(kv, rv) and torch.equal(ki, ri)


def test_sim_topk_targets_in_one_chunk(dev):
    """Server 0's targets all lie in its second chunk; server 1's in its last,
    partial one, which belongs to one client, whose own rows get none."""
    n, chunk_len = _chunked_n(2, 15, 4, 3000, 37)
    gen = torch.Generator(device=dev).manual_seed(1)
    h = torch.randn((2, n, 15), generator=gen, device=dev)
    h[:, chunk_len + 5] = h[:, chunk_len + 2]
    cid = _client_ids("blocks", n, gen, dev)
    mask = torch.zeros((2, n), device=dev)
    mask[0, chunk_len:2 * chunk_len] = 1.0
    mask[1, n - 37:] = 1.0
    assert (cid[n - 37:] == cid[-1]).all()
    kv, ki = ops.sim_topk(h, cid, mask, 4)
    rv, ri = ref.sim_topk(h, cid, mask, 4)
    assert (ki[1, cid == cid[-1]] == -1).all()
    assert_topk_match(kv.cpu().numpy(), ki.cpu().numpy(), rv.cpu().numpy(), ri.cpu().numpy(),
                      gram_rows(h.cpu().numpy()), atol=1e-5)


def test_sim_topk_fewer_targets_than_k(dev):
    h = torch.randn((1, 64, 5), device=dev)
    cid = torch.zeros(64, dtype=torch.int32, device=dev)
    cid[:2] = 1                                # rows 2.. see only 2 other-client nodes
    kv, ki = ops.sim_topk(h, cid, torch.ones((1, 64), device=dev), 4)
    assert (ki[0, 2:, 2:] == -1).all() and torch.isneginf(kv[0, 2:, 2:]).all()
    assert (ki[0, 2:, :2] >= 0).all()


def test_sim_topk_refuses_what_it_cannot_run(dev):
    h = torch.randn((1, 40, 17), device=dev)
    with pytest.raises(ValueError, match="c"):
        ops.sim_topk(h, torch.zeros(40, device=dev), torch.ones((1, 40), device=dev), 3)
    with pytest.raises(ValueError, match="k"):
        ops.sim_topk(h[..., :4], torch.zeros(40, device=dev),
                     torch.ones((1, 40), device=dev), 17)


def _rows_scores(rows, cand):
    """scores_of for query rows against candidates: float64 row of rows @ candᵀ."""
    r64, c64 = np.asarray(rows, np.float64), np.asarray(cand, np.float64)

    def scores_of(lead, row):
        return (c64[lead] if lead else c64) @ (r64[lead] if lead else r64)[row]
    return scores_of


# (nb, q, m, c, k, col_offset): query rows apart from the candidates, fewer
# or more of them, shifted indices, k above the candidate count.
@pytest.mark.parametrize("nb,q,m,c,k,off", [(3, 700, 1237, 7, 4, 0), (2, 2100, 900, 15, 4, 4000),
                                            (1, 50, 3, 5, 8, 17), (2, 333, 2600, 16, 16, 0)])
def test_sim_topk_rows_match_plain(dev, nb, q, m, c, k, off):
    """The general form: query rows of their own clients against a candidate
    slab, against ``ref.sim_topk``'s rows form; one launch."""
    gen = torch.Generator(device=dev).manual_seed(q + m + k)
    cand, cid, mask = _sim(gen, nb, m, c, dev) if m > 40 else (
        torch.randn((nb, m, c), generator=gen, device=dev),
        torch.arange(m, dtype=torch.int32, device=dev), torch.ones((nb, m), device=dev))
    rows = torch.randn((nb, q, c), generator=gen, device=dev)
    rows[:, 5] = cand[:, m // 2]                # a row that meets its own copy
    rcid = torch.randint(0, 4, (nb, q), generator=gen, device=dev).to(torch.int32)
    before = ksim.launches
    kv, ki = ops.sim_topk(cand, cid, mask, k, col_offset=off, rows=rows, row_cid=rcid)
    torch.cuda.synchronize()
    assert ksim.launches == before + 1
    rv, ri = ref.sim_topk(cand, cid, mask, k, col_offset=off, rows=rows, row_cid=rcid)
    unshift = lambda i: np.where(i >= 0, i - off, -1)  # noqa: E731
    assert_topk_match(kv.cpu().numpy(), unshift(ki.cpu().numpy()), rv.cpu().numpy(),
                      unshift(ri.cpu().numpy()), _rows_scores(rows.cpu(), cand.cpu()),
                      atol=1e-5)


@pytest.mark.parametrize("slabs", [2, 3, 4])
@pytest.mark.parametrize("ints", [False, True])
def test_sim_topk_fold_over_slabs_is_the_square_call(dev, slabs, ints):
    """Query shards folded over candidate slabs in ring order (each shard's
    own slab first, then the one before it, ...), at the slabs' offsets,
    with the running list folded in by the merge kernel: bit for bit the
    square call's result, random or integer (tie-heavy) features."""
    nb, n, c, k = 3, 2900, 15, 4
    gen = torch.Generator(device=dev).manual_seed(slabs)
    h = (torch.randint(-2, 3, (nb, n, c), generator=gen, device=dev).float() if ints
         else torch.randn((nb, n, c), generator=gen, device=dev))
    cid = _client_ids("blocks", n, gen, dev)
    mask = (torch.rand((nb, n), generator=gen, device=dev) < 0.8).float()
    want_v, want_i = ops.sim_topk(h, cid, mask, k)
    shard = -(-n // slabs)
    pad = shard * slabs - n
    hp = torch.cat([h, h.new_zeros((nb, pad, c))], 1)
    cp = torch.cat([cid, cid.new_full((pad,), -1)])
    mp = torch.cat([mask, mask.new_zeros((nb, pad))], 1)
    got_v, got_i = [], []
    before = ksim.launches
    for me in range(slabs):
        q = slice(me * shard, (me + 1) * shard)
        run = None
        for step in range(slabs):
            owner = (me - step) % slabs
            o = slice(owner * shard, (owner + 1) * shard)
            run = ops.sim_topk(hp[:, o], cp[o], mp[:, o], k, col_offset=owner * shard,
                               rows=hp[:, q], row_cid=cp[q], run=run)
        got_v.append(run[0])
        got_i.append(run[1])
    torch.cuda.synchronize()
    assert ksim.launches == before + slabs * slabs
    got_v, got_i = torch.cat(got_v, 1)[:, :n], torch.cat(got_i, 1)[:, :n]
    assert torch.equal(got_i, want_i) and torch.equal(got_v, want_v)


# (b, hq, hkv, sq, skv, d, window, dtype): ragged with a window and GQA 2:1;
# a 40-token prompt (the reference's ops.mha is wrong below 128); MQA at
# D = 128; decode-style end alignment; more queries than keys (rows before
# key 0 are fully masked); the serving main path's shape, Qwen3-4B as
# configured at batch 8 and a 2048-token prompt. Then the bf16 (tensor-core)
# route at every head dim: fewer than 64 queries; one query against a long
# cache of a length that is not a multiple of the 64-key tile, with GQA 4:1;
# more queries than keys without a window; ragged 333 tokens; a window of
# 100, not a multiple of the tile; GQA 4:1 at D = 128. And the f32 route at
# D = 80 and D = 128; then more f32 rows: a 333-token prompt (Skv not a
# multiple of 8, the key order inside each k-step of P V); a window of 100
# that crosses tile edges; more queries than keys; one query against a
# 1000-key cache; MQA at D = 128; ragged 77 queries against 301 keys at
# D = 32; and the serving main path's shape in f32.
FLASH_SHAPES = [
    (2, 4, 2, 200, 200, 32, 64, torch.float32),
    (2, 4, 2, 40, 40, 32, None, torch.float32),
    (1, 8, 1, 300, 300, 128, None, torch.bfloat16),
    (1, 4, 2, 3, 77, 64, None, torch.float32),
    (1, 4, 2, 130, 100, 80, 16, torch.bfloat16),
    (8, 32, 8, 2048, 2048, 80, None, torch.bfloat16),
    (2, 4, 2, 40, 40, 32, None, torch.bfloat16),
    (1, 8, 2, 1, 1000, 64, None, torch.bfloat16),
    (1, 4, 1, 150, 90, 64, None, torch.bfloat16),
    (2, 4, 2, 333, 333, 80, None, torch.bfloat16),
    (1, 4, 2, 500, 500, 64, 100, torch.bfloat16),
    (2, 16, 4, 256, 256, 128, None, torch.bfloat16),
    (1, 4, 1, 200, 200, 80, None, torch.float32),
    (1, 4, 2, 100, 100, 128, 40, torch.float32),
    (2, 4, 2, 333, 333, 80, None, torch.float32),
    (1, 4, 2, 500, 500, 80, 100, torch.float32),
    (1, 4, 1, 150, 90, 64, None, torch.float32),
    (1, 8, 2, 1, 1000, 80, None, torch.float32),
    (1, 8, 1, 300, 300, 128, None, torch.float32),
    (2, 4, 2, 77, 301, 32, None, torch.float32),
    (8, 32, 8, 2048, 2048, 80, None, torch.float32),
    # D = 240 (gemma3-12b's head dim), both types: GQA 16:8 with and without
    # a window, ragged 77 queries against 301 keys, more queries than keys
    # (rows that see no key), one query against a 1000-key cache.
    (1, 16, 8, 300, 300, 240, None, torch.bfloat16),
    (1, 16, 8, 200, 333, 240, 64, torch.bfloat16),
    (1, 4, 2, 150, 90, 240, None, torch.bfloat16),
    (1, 8, 2, 1, 1000, 240, None, torch.bfloat16),
    (2, 4, 2, 77, 301, 240, None, torch.bfloat16),
    (1, 16, 8, 300, 300, 240, None, torch.float32),
    (1, 16, 8, 200, 333, 240, 64, torch.float32),
    (1, 4, 2, 150, 90, 240, None, torch.float32),
    (1, 8, 2, 1, 1000, 240, None, torch.float32),
    (2, 4, 2, 77, 301, 240, None, torch.float32),
    # The wgmma kernel's tiling (bf16): Sq of 65, 129 and 191 around its
    # 64-row warpgroups and 128-row blocks; Skv not a multiple of its key
    # tiles (64 at D <= 64, 128 at D = 80 and 128, 48 at D = 240); D = 80 and
    # D = 240 across the partial last 64-column box of the swizzle; Hymba's
    # GQA 25:5 at D = 64 with window 1024; and B * H = 160 heads of 3 blocks,
    # more blocks than SMs, over the 3-D maps' outer dimension.
    (1, 4, 2, 65, 65, 64, None, torch.bfloat16),
    (2, 4, 2, 129, 129, 80, 100, torch.bfloat16),
    (1, 4, 1, 191, 191, 128, None, torch.bfloat16),
    (1, 4, 2, 100, 333, 128, None, torch.bfloat16),
    (1, 4, 2, 70, 201, 240, 64, torch.bfloat16),
    (1, 8, 4, 257, 257, 240, None, torch.bfloat16),
    (2, 4, 2, 300, 300, 80, 16, torch.bfloat16),
    (1, 4, 4, 191, 129, 32, None, torch.bfloat16),
    (1, 25, 5, 1100, 1100, 64, 1024, torch.bfloat16),
    (4, 40, 8, 300, 300, 128, None, torch.bfloat16),
    # The f32 wgmma kernel's tiling: Sq of 65, 129 and 191 around its 64-row
    # consumers and 128-row blocks (64-row blocks at D = 240, whose two
    # consumers take the tiles in turn: one tile, then an odd count); Skv
    # not a multiple of its key tiles (64, 32 at D = 128, 16 at D = 240) nor
    # of 8 (the transposed V planes' groups); D = 80 across the partial last
    # 32-column box; GQA 25:5 with a window at D = 64; B * H = 160 heads,
    # more blocks than SMs.
    (1, 4, 2, 65, 65, 64, None, torch.float32),
    (2, 4, 2, 129, 129, 80, 100, torch.float32),
    (1, 4, 1, 191, 191, 128, None, torch.float32),
    (1, 4, 2, 100, 333, 128, None, torch.float32),
    (1, 4, 2, 10, 10, 240, None, torch.float32),
    (1, 4, 2, 70, 201, 240, 64, torch.float32),
    (1, 8, 4, 257, 257, 240, None, torch.float32),
    (1, 4, 4, 191, 129, 32, None, torch.float32),
    (1, 25, 5, 1100, 1100, 64, 1024, torch.float32),
    (4, 40, 8, 300, 300, 80, None, torch.float32),
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,window,dtype", FLASH_SHAPES)
def test_flash_attention_matches_plain(dev, b, hq, hkv, sq, skv, d, window, dtype):
    gen = torch.Generator(device=dev).manual_seed(sq + d)
    q = torch.randn((b, hq, sq, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, hkv, skv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, hkv, skv, d), generator=gen, device=dev).to(dtype)
    route = "launches_tc" if dtype == torch.bfloat16 else "launches_f32"
    other = "launches_f32" if dtype == torch.bfloat16 else "launches_tc"
    before = {name: getattr(kflash, name) for name in ("launches", route, other)}
    got = ops.mha(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert kflash.launches == before["launches"] + 1
    assert getattr(kflash, route) == before[route] + 1
    assert getattr(kflash, other) == before[other]
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.flash_attention(q, k, v, window=window).float(),
                               atol=tol, rtol=tol)
    if sq > skv:                               # rows before key 0 see nothing: exact 0
        assert (got[:, :, :sq - skv] == 0).all()


def test_flash_forward_is_wgmma_fed_by_tma(dev):
    """Every instance of the bf16 forward, the serving kernel and the training
    one at each head dim, runs wgmma (HGMMA) on tiles that TMA loads
    (UTMALDG) and no mma.sync (HMMA), in the SASS of the built library."""
    import sys
    from pathlib import Path

    from repro_torch.kernels import build

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import _sass_counts

    build.load()
    counts = _sass_counts(build.library_path())
    for kind in ("flash_attention_tc_kernel", "flash_attention_tc_lse_kernel"):
        for d in kflash.HEAD_DIMS:
            c = counts[f"{kind}<{d}>"]
            assert c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["HMMA"] == 0, (kind, d, c)


def test_flash_backward_is_wgmma_fed_by_tma(dev):
    """Every instance of the bf16 backward's dK/dV and dQ kernels, one at each
    head dim, runs wgmma (HGMMA) on tiles that TMA loads (UTMALDG) and no
    mma.sync (HMMA), in the SASS of the built library."""
    import sys
    from pathlib import Path

    from repro_torch.kernels import build

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import _sass_counts

    build.load()
    counts = _sass_counts(build.library_path())
    for kind in ("flash_attention_bwd_dkdv_tc_kernel", "flash_attention_bwd_dq_tc_kernel"):
        for d in kflash.HEAD_DIMS:
            c = counts[f"{kind}<{d}>"]
            assert c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["HMMA"] == 0, (kind, d, c)


def test_flash_backward_f32_is_wgmma(dev):
    """Every instance of the f32 backward's dK/dV and dQ kernels, one at each
    head dim, runs TF32 wgmma (HGMMA) on tiles that TMA loads (UTMALDG) and no
    mma.sync (HMMA), in the SASS of the built library."""
    import sys
    from pathlib import Path

    from repro_torch.kernels import build

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import WGMMA_F32_BWD_KERNELS, _sass_counts

    build.load()
    counts = _sass_counts(build.library_path())
    for kind in WGMMA_F32_BWD_KERNELS:
        for d in kflash.HEAD_DIMS:
            c = counts[f"{kind}<{d}>"]
            assert c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["HMMA"] == 0, (kind, d, c)


def test_flash_forward_f32_is_wgmma(dev):
    """Every instance of the f32 forward, one at each head dim, runs TF32
    wgmma (HGMMA) on tiles that TMA loads (UTMALDG) and no mma.sync (HMMA),
    in the SASS of the built library."""
    import sys
    from pathlib import Path

    from repro_torch.kernels import build

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import WGMMA_F32_FWD_KERNELS, _sass_counts

    build.load()
    counts = _sass_counts(build.library_path())
    for kind in WGMMA_F32_FWD_KERNELS:
        for d in kflash.HEAD_DIMS:
            c = counts[f"{kind}<{d}>"]
            assert c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["HMMA"] == 0, (kind, d, c)


# (b, hq, hkv, sq, skv, d, window): the main paths' shape, gemma3-12b's f32
# training shape with a window, and a ragged GQA case at every other head dim.
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,window", [
    (2, 32, 8, 2048, 2048, 80, None), (2, 16, 8, 2048, 2048, 240, 1024),
    (1, 4, 2, 333, 301, 32, 100), (1, 4, 2, 333, 301, 64, None),
    (1, 4, 2, 333, 301, 128, 100)])
def test_flash_attention_f32_two_calls_bit_for_bit(dev, b, hq, hkv, sq, skv, d, window):
    """The f32 forward is deterministic: two calls give the same bits, the
    output and the row log-sum-exp (the persistent CTAs take the blocks in
    another order each call; no atomics touch a result)."""
    gen = torch.Generator(device=dev).manual_seed(sq + d)
    q = torch.randn((b, hq, sq, d), generator=gen, device=dev)
    k, v = (torch.randn((b, hkv, skv, d), generator=gen, device=dev) for _ in range(2))
    first, lse = kflash.launch(q, k, v, window=window, with_lse=True)
    again, lse_again = kflash.launch(q, k, v, window=window, with_lse=True)
    assert torch.equal(first, again) and torch.equal(lse, lse_again)
    assert torch.equal(kflash.launch(q, k, v, window=window), first)


def _attention_f64(q, k, v):
    """Causal attention in float64, with P @ |V| beside it: the sum of the
    magnitudes of the terms of each output, the scale of f32's error."""
    rep = q.shape[1] // k.shape[1]
    k, v = (x.double().repeat_interleave(rep, 1) for x in (k, v))
    sq, skv = q.shape[2], k.shape[2]
    logits = (q.double() @ k.transpose(-1, -2)) / q.shape[-1] ** 0.5
    seen = torch.arange(skv, device=q.device)[None] <= torch.arange(sq, device=q.device)[:, None]
    p = torch.softmax(logits.masked_fill(~seen, -torch.inf), -1)
    return p @ v, p @ v.abs()


# (b, hq, hkv, sq, skv, d, kind): inputs that make the split's error matter
# most, held to float64. "sharp": q scaled by 20, so each softmax row is
# dominated by a few keys and an error in a score moves the output most;
# logits reach ~70, whose f32 rounding alone moves outputs by ~1e-5, so the
# kernel is held to the larger of 1e-5 and the plain f32 version's own
# error. "spread": V's values scaled by 2^u, u uniform in [-20, 20] per
# element, held within 1e-5 of P @ |V| (sums of terms 2^40 apart cancel, so
# no absolute limit fits every output). One TF32 pass misses either by ~50x.
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,kind", [
    (1, 4, 2, 300, 300, 80, "sharp"), (1, 4, 1, 200, 200, 128, "sharp"),
    (1, 4, 2, 300, 300, 80, "spread"), (1, 4, 1, 200, 200, 128, "spread"),
    (1, 4, 2, 200, 200, 240, "sharp"), (1, 4, 2, 200, 200, 240, "spread")])
def test_flash_attention_f32_hard_inputs(dev, b, hq, hkv, sq, skv, d, kind):
    gen = torch.Generator(device=dev).manual_seed(sq + d + len(kind))
    q = torch.randn((b, hq, sq, d), generator=gen, device=dev)
    k = torch.randn((b, hkv, skv, d), generator=gen, device=dev)
    v = torch.randn((b, hkv, skv, d), generator=gen, device=dev)
    if kind == "sharp":
        q = q * 20
    else:
        v = v * torch.exp2(torch.rand(v.shape, generator=gen, device=dev) * 40 - 20)
    got = ops.mha(q, k, v, causal=True)
    want, scale = _attention_f64(q, k, v)
    err = (got.double() - want).abs()
    if kind == "sharp":
        plain = (ref.flash_attention(q, k, v).double() - want).abs().max().item()
        assert err.max().item() <= max(1e-5, plain), (err.max().item(), plain)
    else:
        excess = (err - 1e-5 * scale).max().item()
        assert excess <= 0, f"f32 route off by more than 1e-5 of P @ |V| (excess {excess:.3g})"


_BITS = {"nan": 0x7FFFFFFF, "+inf": 0x7F800000, "-inf": 0xFF800000}


def _nonfinite_rows(run, dev, operand, value):
    """Write one NaN or ±Inf into q, k or v of a GQA 2:1 input (q head 1's
    row 70, or kv head 0's key 70; column 5), run ``run(q, k, v)``, and
    check each row of the output against IEEE arithmetic: a row is non-finite
    exactly where it meets a NaN or +Inf score (a NaN or ±Inf in its q row,
    or in a key it sees whose product with its q is not -Inf: a -Inf score
    gives the key weight 0, as a mask does), or a NaN or ±Inf in a row of V
    that it sees. Every other row is held to the plain version, except, for
    a write into V, the rows before key 70 of the heads that read it: beside
    the key in a tile, they take 0 x Inf there, as the plain version's
    P @ V does for every row."""
    gen = torch.Generator(device=dev).manual_seed(len(operand) + len(value))
    q = torch.randn((1, 4, 200, 80), generator=gen, device=dev)
    k, v = (torch.randn((1, 2, 200, 80), generator=gen, device=dev) for _ in range(2))
    x = {"q": q, "k": k, "v": v}[operand]
    head, pos, col = (1, 70, 5) if operand == "q" else (0, 70, 5)
    bits = _BITS[value]
    x.view(torch.int32)[0, head, pos, col] = bits - (1 << 32) if bits >> 31 else bits
    got = run(q, k, v)
    torch.cuda.synchronize()
    plain = ref.flash_attention(q, k, v)
    bad = ~torch.isfinite(got).all(-1)[0]            # [q heads, rows]
    rows = torch.arange(200, device=dev)
    want = torch.zeros_like(bad)
    held = torch.ones_like(bad)                       # rows held to the plain version
    if operand == "q":
        want[head, pos] = True
    elif operand == "k":                              # q heads 0 and 1 read kv head 0
        score = q[0, :2, :, col] * x[0, head, pos, col]
        want[:2] = (rows >= pos) & ~torch.isneginf(score)
    else:
        want[:2] = rows >= pos
        held[:2] = False
    assert torch.equal(bad[held | want], want[held | want])
    keep = held & ~want
    torch.testing.assert_close(got[0][keep], plain[0][keep], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("operand", ["q", "k", "v"])
@pytest.mark.parametrize("value", ["nan", "+inf", "-inf"])
def test_flash_attention_f32_nonfinite_inputs(dev, operand, value):
    _nonfinite_rows(lambda q, k, v: ops.mha(q, k, v, causal=True), dev, operand, value)


def test_flash_attention_refuses_what_it_cannot_run(dev):
    q = torch.randn((1, 2, 16, 256), device=dev)      # above the largest instance
    with pytest.raises(ValueError, match="head dim"):
        ops.mha(q, q, q)
    q = torch.randn((1, 2, 16, 32), device=dev)
    with pytest.raises(ValueError, match="causal"):
        ops.mha(q, q, q, causal=False)
    with pytest.raises(ValueError, match="device"):
        ops.mha(q, q.cpu(), q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.mha(q.half(), q.half(), q.half())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d,window", [(2, 5, 1, 128, 20, 1024),
                                                 (2, 5, 1, 128, 20, None),
                                                 (1, 4, 2, 300, 100, 64),
                                                 (1, 4, 2, 150, 100, None)])
def test_flash_attention_padded_head_dim(dev, b, hq, hkv, s, d, window, dtype):
    """A head dim without an instance (hymba-1.5b's smoke config's 20, and
    100) runs through the next instance, zero-padded: the forward with and
    without the row log-sum-exp and the backward on their routes, one launch
    a call, within the limits of the module docstring of the plain versions
    at the true head dim, and the backward bit for bit across two runs."""
    q, k, v, do = _flash_bwd_inputs(dev, b, hq, hkv, s, s, d, dtype, seed=s + d)
    tc = dtype == torch.bfloat16
    routes = ("launches_tc", "launches_tc_lse", "launches_bwd_tc") if tc else (
        "launches_f32", "launches_f32", "launches_bwd_f32")
    before = {name: getattr(kflash, name) for name in _FLASH_COUNTERS}
    out = ops.mha(q, k, v, window=window)
    o, lse = kflash.launch(q, k, v, window=window, with_lse=True)
    got = kflash.launch_bwd(q, k, v, o, do, lse, window=window)
    again = kflash.launch_bwd(q, k, v, o, do, lse, window=window)
    torch.cuda.synchronize()
    after = {name: getattr(kflash, name) for name in before}
    want = {name: 0 for name in _FLASH_COUNTERS}
    for name in routes:
        want[name] += 1
    want["launches_bwd"] = 2
    want[routes[2]] = 2
    assert {name: after[name] - n for name, n in before.items()} == want
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    plain = ref.flash_attention(q, k, v, window=window).float()
    for o_got in (out, o):
        assert o_got.shape == q.shape and o_got.dtype == dtype
        torch.testing.assert_close(o_got.float(), plain, atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref.flash_attention_lse(q, k, window=window),
                               atol=1e-5, rtol=0)
    plain_g = ref.flash_attention_bwd(q, k, v, o, do, lse, window=window)
    if dtype == torch.float32:
        exact = ref.flash_attention_bwd(*(t.double() for t in (q, k, v, o, do, lse)),
                                        window=window)
    for i, (name, g, p) in enumerate(zip(("dq", "dk", "dv"), got, plain_g)):
        assert g.dtype == dtype and g.shape == p.shape, name
        scale = p.float().abs().max().item()
        if tc:
            err = (g.float() - p.float()).abs().max().item()
            assert err <= 2e-2 * scale, (name, err, scale)
        else:
            err = (g.double() - exact[i]).abs().max().item()
            own = (p.double() - exact[i]).abs().max().item()
            assert err <= max(1e-5 * scale, own), (name, err, scale, own)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# The backward: every head dim in both types; ragged lengths, more queries
# than keys (rows that see no key: dq 0), a window that crosses tiles, MQA,
# queries at the end of a longer cache, and the training shape in bf16. The
# last two bf16 cases cut the first tensor-core kernels' tiles (mma.sync: 16
# rows or keys a warp, 64 a block; 32 a tile at D = 128) where the others do
# not: more queries than keys with Sq not a multiple of 16, and D = 128 with a window
# and GQA 4:1; then D = 128 over 1300 keys (the MoE and vlm configs' head
# dim, past the 300 keys of the cases before it).
FLASH_BWD_SHAPES = [
    (2, 4, 2, 200, 200, 32, 64, torch.float32),
    (1, 4, 2, 333, 333, 80, None, torch.float32),
    (1, 4, 1, 150, 90, 64, None, torch.float32),
    (1, 8, 1, 300, 300, 128, None, torch.float32),
    (1, 4, 2, 500, 500, 80, 100, torch.float32),
    (2, 4, 2, 77, 301, 32, None, torch.float32),
    (1, 4, 2, 130, 100, 32, 50, torch.bfloat16),
    (2, 4, 2, 333, 333, 64, None, torch.bfloat16),
    (1, 8, 1, 300, 300, 128, 40, torch.bfloat16),
    (1, 4, 1, 150, 90, 80, None, torch.bfloat16),
    (2, 32, 8, 2048, 2048, 80, None, torch.bfloat16),
    (2, 4, 2, 203, 75, 64, None, torch.bfloat16),
    (1, 8, 2, 300, 300, 128, 70, torch.bfloat16),
    (2, 4, 2, 1300, 1300, 128, None, torch.bfloat16),    # D = 128 past 1000 keys
    # D = 240 (gemma3-12b's head dim), both types: GQA 16:8 with a window
    # that crosses tiles, more queries than keys with Sq not a multiple of 16
    # (rows that see no key), ragged 77 queries against 301 keys, and
    # gemma's window of 1024 over 1100 keys.
    (1, 16, 8, 300, 300, 240, 100, torch.float32),
    (1, 4, 2, 203, 75, 240, None, torch.float32),
    (1, 4, 2, 77, 301, 240, None, torch.float32),
    (1, 16, 8, 300, 300, 240, 100, torch.bfloat16),
    (1, 4, 2, 203, 75, 240, None, torch.bfloat16),
    (1, 4, 2, 77, 301, 240, None, torch.bfloat16),
    (1, 16, 8, 1100, 1100, 240, 1024, torch.bfloat16),
    # The wgmma forward's tiling under the training kernel (the row
    # log-sum-exp): Sq of 65 and 191 around its warpgroups, keys not a
    # multiple of its tiles, D = 80 and 240 across the last swizzle box,
    # Hymba's GQA 25:5 with window 1024.
    (1, 4, 2, 65, 65, 80, None, torch.bfloat16),
    (1, 4, 2, 191, 301, 240, 100, torch.bfloat16),
    (2, 4, 2, 129, 200, 128, None, torch.bfloat16),
    (1, 25, 5, 1100, 1100, 64, 1024, torch.bfloat16),
    # The wgmma backward's tiling: 129 and 255 keys against its 128-key
    # dK/dV blocks (the second consumer's 64 keys ragged or empty), D = 240
    # with the window's edge inside its 64-key blocks, and Hymba's GQA 25:5
    # with window 1024 at a length where the edge crosses 64-row q tiles.
    (1, 4, 2, 129, 129, 80, None, torch.bfloat16),
    (2, 4, 1, 200, 255, 128, 90, torch.bfloat16),
    (1, 8, 4, 300, 300, 240, 100, torch.bfloat16),
    (1, 25, 5, 1157, 1157, 64, 1024, torch.bfloat16),
    # The f32 wgmma backward's tiling (64-key and 64-row blocks, 32-row or
    # 16-row tiles, two consumers taking tiles in turn): 65 and 129 keys
    # against its 64-key blocks, D = 240 with the window's edge inside a key
    # block and with more queries than keys (rows that see no key), and a
    # group of 5 q heads a kv head.
    (1, 4, 2, 65, 65, 80, None, torch.float32),
    (2, 4, 2, 129, 129, 80, None, torch.float32),
    (1, 8, 4, 300, 300, 240, 37, torch.float32),
    (1, 4, 2, 150, 70, 240, None, torch.float32),
    (1, 5, 1, 191, 191, 80, 100, torch.float32),
]


def _flash_bwd_inputs(dev, b, hq, hkv, sq, skv, d, dtype, seed, q_scale=1.0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = (q_scale * torch.randn((b, hq, sq, d), generator=gen, device=dev)).to(dtype)
    k, v = (torch.randn((b, hkv, skv, d), generator=gen, device=dev).to(dtype) for _ in range(2))
    do = torch.randn((b, hq, sq, d), generator=gen, device=dev).to(dtype)
    return q, k, v, do


_FLASH_COUNTERS = ("launches_bwd", "launches_bwd_tc", "launches_bwd_f32", "launches_tc",
                   "launches_tc_lse", "launches_f32")


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,window,dtype", FLASH_BWD_SHAPES)
def test_flash_attention_backward_matches_plain(dev, b, hq, hkv, sq, skv, d, window, dtype):
    """The forward with its row log-sum-exp, then the backward on its route
    (bf16: wgmma fed by TMA, f32: 3-pass TF32), against the plain
    version: the counters of the two kernels moved and no other, the limits
    of the module docstring, rows that see no key dq 0, and a second run bit
    for bit."""
    q, k, v, do = _flash_bwd_inputs(dev, b, hq, hkv, sq, skv, d, dtype, seed=sq + skv + d)
    tc = dtype == torch.bfloat16
    routes = ("launches_tc_lse", "launches_bwd_tc") if tc else ("launches_f32",
                                                               "launches_bwd_f32")
    before = {name: getattr(kflash, name) for name in _FLASH_COUNTERS}
    o, lse = kflash.launch(q, k, v, window=window, with_lse=True)
    tol = 1e-5 if dtype == torch.float32 else 2e-2       # the forward's, as above
    torch.testing.assert_close(o.float(), ref.flash_attention(q, k, v, window=window).float(),
                               atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref.flash_attention_lse(q, k, window=window),
                               atol=1e-5, rtol=0)
    got = kflash.launch_bwd(q, k, v, o, do, lse, window=window)
    torch.cuda.synchronize()
    after = {name: getattr(kflash, name) for name in before}
    assert {name: after[name] - n for name, n in before.items()} == {
        name: int(name == "launches_bwd" or name in routes) for name in _FLASH_COUNTERS}
    plain = ref.flash_attention_bwd(q, k, v, o, do, lse, window=window)
    if dtype == torch.float32 and sq * skv <= 500 * 500:
        # The same formula in float64 from the same o and lse.
        exact = ref.flash_attention_bwd(*(t.double() for t in (q, k, v, o, do, lse)),
                                        window=window)
    for name, g, p in zip(("dq", "dk", "dv"), got, plain):
        assert g.dtype == dtype and g.shape == p.shape, name
        scale = p.float().abs().max().item()
        if dtype == torch.bfloat16:
            err = (g.float() - p.float()).abs().max().item()
            assert err <= 2e-2 * scale, (name, err, scale)
        else:
            e = exact[("dq", "dk", "dv").index(name)]
            err = (g.double() - e).abs().max().item()
            own = (p.double() - e).abs().max().item()
            assert err <= max(1e-5 * scale, own), (name, err, scale, own)
    if sq > skv:                                  # rows before key 0: dq exactly 0
        assert (got[0][:, :, :sq - skv] == 0).all()
    again = kflash.launch_bwd(q, k, v, o, do, lse, window=window)
    assert all(torch.equal(a, b) for a, b in zip(got, again))   # deterministic


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,window", [(1, 4, 2, 300, 300, 80, None),
                                                       (1, 8, 2, 200, 200, 64, 50),
                                                       (1, 16, 8, 200, 200, 240, 64)])
def test_flash_attention_backward_peaky_softmax(dev, b, hq, hkv, sq, skv, d, window):
    """q scaled by 8, bf16: most rows put nearly all their weight on one key,
    so P is near 1 there and dS = P (dP - D) cancels. The backward on the
    tensor cores, from the plain version's output and row log-sum-exp,
    within 2e-2 of max |grad| of the plain backward, and a second run bit for
    bit."""
    q, k, v, do = _flash_bwd_inputs(dev, b, hq, hkv, sq, skv, d, torch.bfloat16, seed=sq + d,
                                    q_scale=8.0)
    o = ref.flash_attention(q, k, v, window=window)
    lse = ref.flash_attention_lse(q, k, window=window)
    before = kflash.launches_bwd_tc
    got = kflash.launch_bwd(q, k, v, o, do, lse, window=window)
    torch.cuda.synchronize()
    assert kflash.launches_bwd_tc == before + 1
    plain = ref.flash_attention_bwd(q, k, v, o, do, lse, window=window)
    for name, g, p in zip(("dq", "dk", "dv"), got, plain):
        err = (g.float() - p.float()).abs().max().item()
        assert err <= 2e-2 * p.float().abs().max().item(), (name, err)
    again = kflash.launch_bwd(q, k, v, o, do, lse, window=window)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _bwd_nonfinite(dev, operand, value, dtype):
    """A NaN or ±Inf in q, k, v or dO of a GQA 2:1 input (q head 1's row 70,
    or kv head 0's key 70; column 5), in f32 (3-pass TF32) or bf16
    (the tensor cores). The kernel's gradients are non-finite only where the
    plain version's are (which also meets the value where a masked pair's 0
    multiplies it, on tiles the kernel skips), equal to them elsewhere
    (f32 within 1e-5, bf16 within 2e-2 of the plain version's max |grad|
    there), and for a NaN non-finite at least where the value reaches: in q,
    dq's row and the dk and dv of the keys it sees; in k, the dq of every
    row that sees the key and all of the kv head's dk and dv; in v, those
    rows' dq and the kv head's dk; in dO, the row's dq, the dk of the keys
    it sees and their dv's column 5."""
    q, k, v, do = _flash_bwd_inputs(dev, 1, 4, 2, 200, 200, 80, dtype, seed=7)
    o, lse = kflash.launch(q, k, v, with_lse=True)
    x = {"q": q, "k": k, "v": v, "do": do}[operand]
    head = 1 if operand in ("q", "do") else 0
    if dtype == torch.float32:
        bits = _BITS[value]
        x.view(torch.int32)[0, head, 70, 5] = bits - (1 << 32) if bits >> 31 else bits
    else:
        x[0, head, 70, 5] = {"nan": torch.nan, "+inf": torch.inf, "-inf": -torch.inf}[value]
    if operand != "do":
        o, lse = kflash.launch(q, k, v, with_lse=True)
    before = (kflash.launches_bwd_tc, kflash.launches_bwd_f32)
    got = kflash.launch_bwd(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    tc = dtype == torch.bfloat16
    assert (kflash.launches_bwd_tc - before[0], kflash.launches_bwd_f32 - before[1]) == (
        (1, 0) if tc else (0, 1))
    plain = ref.flash_attention_bwd(q, k, v, o, do, lse)
    for g, p in zip(got, plain):
        bad, pbad = ~torch.isfinite(g), ~torch.isfinite(p)
        assert not (bad & ~pbad).any()
        if tc:
            want = p[~pbad].float()
            err = (g[~pbad].float() - want).abs().max().item()
            assert err <= 2e-2 * want.abs().max().item(), err
        else:
            torch.testing.assert_close(g[~pbad], p[~pbad], atol=1e-5, rtol=1e-5)
    if value != "nan":
        return
    dq, dk, dv = (~torch.isfinite(t) for t in got)
    want = {"q": (dq[0, 1, 70], dk[0, 0, :71], dv[0, 0, :71]),
            "k": (dq[0, :2, 70:], dk[0, 0], dv[0, 0]),
            "v": (dq[0, :2, 70:], dk[0, 0]),
            "do": (dq[0, 1, 70], dk[0, 0, :71], dv[0, 0, :71, 5])}[operand]
    assert all(w.all() for w in want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("operand", ["q", "k", "v", "do"])
@pytest.mark.parametrize("value", ["nan", "+inf", "-inf"])
def test_flash_attention_backward_nonfinite_inputs(dev, operand, value, dtype):
    _bwd_nonfinite(dev, operand, value, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mha_gradients_through_the_kernels(dev, dtype):
    """``ops.mha`` inside a model's attention, differentiated by autograd on
    the card: one forward and one backward launch, and ``wq``, ``wk``,
    ``wv`` and ``q_norm`` get the gradients of the same attention with the
    plain version patched in (within 1e-5 of max |grad| in f32, 2e-2 in
    bf16)."""
    from repro_torch.models import attention as attn

    p = attn.init_attention(torch.Generator(device=dev).manual_seed(1), 128, 4, 2, 32,
                            qk_norm=True, use_bias=False, dtype=dtype)
    for t in p.parameters():
        t.requires_grad_(True)
    x = torch.randn((2, 200, 128), device=dev, generator=torch.Generator(device=dev)
                    .manual_seed(2)).to(dtype)
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=32, qk_norm=True, rope_theta=1e6,
              window=0)
    grads = []
    for route in ("kernel", "plain"):
        p.zero_grad()
        before = (kflash.launches, kflash.launches_bwd)
        mha = ops.mha
        if route == "plain":
            ops.mha = lambda q, k, v, *, causal=True, window=None: ref.flash_attention(  # noqa
                q, k, v, window=window)
        try:
            out, _, _ = attn.self_attention_kv(p, x, **kw)
            out.float().square().sum().backward()
        finally:
            ops.mha = mha
        torch.cuda.synchronize()
        launched = (kflash.launches - before[0], kflash.launches_bwd - before[1])
        assert launched == ((1, 1) if route == "kernel" else (0, 0))
        grads.append({n: t.grad.float().clone() for n, t in p.named_parameters()})
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for name in ("wq", "wk", "wv", "q_norm", "k_norm", "wo"):
        g, want = grads[0][name], grads[1][name]
        assert g.abs().max() > 0, name
        assert (g - want).abs().max().item() <= tol * want.abs().max().item(), name


def test_flash_attention_backward_refuses_what_it_cannot_run(dev):
    q = torch.randn((1, 2, 16, 32), device=dev)
    o, lse = kflash.launch(q, q, q, with_lse=True)
    with pytest.raises(ValueError, match="lse"):
        kflash.launch_bwd(q, q, q, o, o, lse[:, :1])
    with pytest.raises(ValueError, match="match q"):
        kflash.launch_bwd(q, q, q, o.bfloat16(), o, lse)
    with pytest.raises(ValueError, match="device"):
        kflash.launch_bwd(q, q, q, o, o, lse.cpu())


# (b, n, c): the JAX tests' shapes (tests/test_kernels.py, and the
# non-multiples of tests/test_stacked_edge.py), then the Coauthor-CS
# server's 12246 flat slots x 15 classes, the gram that sim_topk fuses away.
SIM_BLOCK_SHAPES = [(64, 300, 7), (128, 1024, 15), (10, 33, 6), (256, 512, 10),
                    (33, 70, 7), (5, 200, 10), (96, 96, 6), (12246, 12246, 15)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,c", SIM_BLOCK_SHAPES)
def test_sim_block_matches_plain(dev, b, n, c, dtype):
    gen = torch.Generator(device=dev).manual_seed(b + n)
    rows = torch.randn((b, c), generator=gen, device=dev).to(dtype)
    h = torch.randn((n, c), generator=gen, device=dev).to(dtype)
    before = ksim.block_launches
    got = ops.sim_block(rows, h)
    torch.cuda.synchronize()
    assert ksim.block_launches == before + 1 and got.dtype == dtype and got.shape == (b, n)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), ref.sim_block(rows, h).float(), atol=tol, rtol=tol)


def test_sim_block_refuses_what_it_cannot_run(dev):
    x = torch.randn((4, 3), device=dev)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.sim_block(x, x.bfloat16())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.sim_block(x.half(), x.half())
    with pytest.raises(ValueError, match="rows"):
        ops.sim_block(x, x[:, :2])
    with pytest.raises(ValueError, match="devices"):
        ops.sim_block(x, x.cpu())
