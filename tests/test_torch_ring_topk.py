"""The port's candidate-sharded ring top-k (``repro_torch.core.ring_topk``).

The cases of ``tests/test_ring_topk.py`` (divisible, ragged and tiny n,
fully-masked rows, k above the valid candidates, duplicated rows that tie),
each through the port's ``imputation.similarity_topk(mesh=)`` on a size-1
mesh in this process and on ``gloo`` groups of 2 and 4 ranks on the CPU
(``launch.mesh.spawn``), against the JAX package's single-device
``similarity_topk`` and its ``ring_similarity_topk`` on a size-1 mesh: the
reference's own multi-device ring drifts under jax 0.9 (ROADMAP §3), so the
port is held to its single-device paths. Also: ``ref.topk_merge``'s fold
order, the general (rows apart from candidates) form of ``ref.sim_topk``
against its square call, and the byte/FLOP accounting against the
reference's.

Tolerances: scores 1e-5; indices exact except between candidates whose
scores lie within 1e-5 (``torch_parity.assert_topk_match``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import imputation as jimp
from repro.core import ring_topk as jring
from repro_torch.core import imputation as pimp
from repro_torch.core import ring_topk as pring
from repro_torch.kernels import ref
from repro_torch.launch import mesh as mesh_lib
from torch_mesh_workers import ring_cases
from torch_parity import assert_topk_match, gram_rows


class _Mesh1:
    """The reference's degenerate size-1 mesh."""
    size = 1


def _cases():
    """The reference's multi-device cases, plus a batched [3, 37, 6] one."""
    rng = np.random.default_rng(0)
    cases = []
    for n in (64, 37, 11):                    # divisible / ragged / tiny
        h = rng.standard_normal((n, 6)).astype(np.float32)
        cid = rng.integers(0, 3, n).astype(np.int32)
        mask = rng.integers(0, 2, n).astype(np.float32)
        cases.append((h, cid, mask, 4))
        cases.append((h, cid, np.zeros(n, np.float32), 4))     # fully masked
        cases.append((h, cid, mask, min(n, 16)))               # k > valid candidates
    base = rng.standard_normal((6, 4)).astype(np.float32)      # duplicated rows: ties
    cases.append((np.tile(base, (4, 1)), (np.arange(24) % 2).astype(np.int32),
                  np.ones(24, np.float32), 5))
    cases.append((rng.standard_normal((3, 37, 6)).astype(np.float32),
                  rng.integers(0, 3, (3, 37)).astype(np.int32),
                  rng.integers(0, 2, (3, 37)).astype(np.float32), 4))
    return cases


CASES = _cases()


def _reference(h, cid, mask, k):
    """The JAX package's single-device answer (one element at a time for a
    batched case)."""
    if h.ndim == 3:
        outs = [_reference(h[b], cid[b], mask[b], k) for b in range(h.shape[0])]
        return np.stack([o[0] for o in outs]), np.stack([o[1] for o in outs])
    s, i = jimp.similarity_topk(jnp.asarray(h), jnp.ones(h.shape[0]), jnp.asarray(cid), k,
                                target_mask=jnp.asarray(mask))
    return np.asarray(s), np.asarray(i)


def _check(got, case):
    h, cid, mask, k = case
    want_s, want_i = _reference(*case)
    assert_topk_match(got[0], got[1], want_s, want_i, gram_rows(h), atol=1e-5)


@pytest.fixture(scope="module", params=[2, 4])
def world(request):
    """The cases on a gloo group of 2 or 4 ranks: every rank's results."""
    return request.param, mesh_lib.spawn(ring_cases, request.param, "cpu", args=(CASES,))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_size1_mesh_matches_reference(case):
    h, cid, mask, k = CASES[case]
    got = pimp.similarity_topk(torch.from_numpy(h), torch.ones(h.shape[:-1]),
                               torch.from_numpy(cid), k, target_mask=torch.from_numpy(mask),
                               mesh=mesh_lib.make_sim_mesh())
    _check((got[0].numpy(), got[1].numpy()), CASES[case])


@pytest.mark.parametrize("case", [0, 4, 9])
def test_size1_mesh_matches_references_ring(case):
    """The raw (-inf, -1) lists against the reference's ring on its size-1
    mesh."""
    h, cid, mask, k = CASES[case]
    jv, ji = jring.ring_similarity_topk(jnp.asarray(h), jnp.asarray(cid), jnp.asarray(mask),
                                        k, mesh=_Mesh1())
    pv, pi = pring.ring_similarity_topk(torch.from_numpy(h), torch.from_numpy(cid),
                                        torch.from_numpy(mask), k, mesh=mesh_lib.make_sim_mesh())
    assert_topk_match(pv.numpy(), pi.numpy(), np.asarray(jv), np.asarray(ji), gram_rows(h))


def test_every_rank_holds_the_whole_result(world):
    size, ranks = world
    assert [r["rank"] for r in ranks] == list(range(size))
    assert all(r["size"] == size for r in ranks)
    for r in ranks[1:]:
        for (s0, i0), (s, i) in zip(ranks[0]["results"], r["results"]):
            np.testing.assert_array_equal(i, i0)
            np.testing.assert_array_equal(s, s0)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_ring_matches_reference(world, case):
    _, ranks = world
    _check(ranks[0]["results"][case], CASES[case])


@pytest.mark.parametrize("case", [0, 3, 9])
def test_ring_equals_one_rank(world, case):
    """On the CPU too, the folds give the one-call answer: same indices and
    scores as the size-1 mesh."""
    h, cid, mask, k = CASES[case]
    want = pimp.similarity_topk(torch.from_numpy(h), torch.ones(h.shape[:-1]),
                                torch.from_numpy(cid), k, target_mask=torch.from_numpy(mask))
    s, i = world[1][0]["results"][case]
    np.testing.assert_array_equal(i, want[1].numpy())
    np.testing.assert_allclose(s, want[0].numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_merge_fold_order_invariance(seed):
    """Folding slabs in any order gives the same list, ties included, and
    it is the stable top-k of the whole row."""
    rng = np.random.default_rng(3)
    n, k, slabs = 48, 4, 4
    vals = rng.standard_normal((5, n)).astype(np.float32)
    vals[:, ::7] = 1.5
    chunks = np.split(vals, slabs, axis=1)
    width = n // slabs

    def fold(order):
        rv, ri = torch.full((5, k), -torch.inf), torch.full((5, k), -1, dtype=torch.int32)
        for s in order:
            idx = (s * width + torch.arange(width, dtype=torch.int32)).expand(5, width)
            rv, ri = ref.topk_merge(rv, ri, torch.from_numpy(chunks[s]), idx)
        return rv, ri

    v_seq, i_seq = fold(range(slabs))
    v_perm, i_perm = fold(np.random.default_rng(seed).permutation(slabs))
    assert torch.equal(i_perm, i_seq) and torch.equal(v_perm, v_seq)
    want_v, want_i = ref.stable_topk(torch.from_numpy(vals), k)
    assert torch.equal(i_seq, want_i.to(torch.int32)) and torch.equal(v_seq, want_v)


@pytest.mark.parametrize("q,m,k,off", [(37, 37, 4, 0), (20, 50, 4, 100), (9, 3, 6, 7)])
def test_ref_rows_form(q, m, k, off):
    """``ref.sim_topk``'s general form: rows = candidates is the square call;
    rows apart score against the candidates (k may exceed them), and a
    running list folds in."""
    g = torch.Generator().manual_seed(q + m)
    cand = torch.randn((2, m, 5), generator=g)
    cid = torch.randint(0, 3, (m,), generator=g).to(torch.int32)
    mask = (torch.rand((2, m), generator=g) < 0.7).float()
    if q == m:
        want = ref.sim_topk(cand, cid, mask, k, off)
        got = ref.sim_topk(cand, cid, mask, k, off, rows=cand, row_cid=cid)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        return
    rows = torch.randn((2, q, 5), generator=g)
    rcid = torch.randint(0, 3, (q,), generator=g).to(torch.int32)
    v, i = ref.sim_topk(cand, cid, mask, k, off, rows=rows, row_cid=rcid)
    gram = rows @ cand.transpose(1, 2)
    keep = (rcid[:, None] != cid[None, :]) & (mask[:, None, :] > 0)
    full = torch.where(keep, gram, -torch.inf)
    pad = torch.full((2, q, max(k - m, 0)), -torch.inf)
    want_v, want_i = ref.stable_topk(torch.cat([full, pad], -1), k)
    want_i = torch.where(want_v > -torch.inf, want_i.to(torch.int32) + off, -1)
    assert torch.equal(v, want_v) and torch.equal(i, want_i)
    # Folding the same slab again changes nothing; an empty list folds to itself.
    v2, i2 = ref.sim_topk(cand, cid, mask, k, off, rows=rows, row_cid=rcid, run=(v, i))
    assert torch.equal(v2, v) and torch.equal(i2, i)


def test_traffic_model_is_the_references():
    for n, c, size in ((1024, 32, 4), (12246, 15, 3), (37, 6, 1)):
        for fn in ("ring_rotation_bytes", "ring_total_bytes", "allgather_bytes"):
            assert getattr(pring, fn)(n, c, size) == getattr(jring, fn)(n, c, size)
        assert pring.sim_topk_flops(10, n, c) == jring.sim_topk_flops(10, n, c)
