"""Parity of the port's plain kernel versions with the JAX package's kernels.

The same numpy-seeded inputs go through the reference kernel (the Pallas
kernel in interpret mode, as the JAX package's own tests run it on the CPU)
and through ``repro_torch.kernels`` on CPU tensors, which is the plain
PyTorch version the CUDA kernels are held against on the card.

Tolerances: f32 values agree within 1e-5 per op (the two packages sum the
same products in other orders); integers (indices, the -1 convention) are
exact, except where two candidates' scores lie within 1e-5 of each other,
where either may be chosen (``torch_parity.assert_topk_match``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import imputation as jimp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import sim_topk as jsim
from repro_torch.core import imputation as pimp
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref
from repro_torch.kernels import sage_aggregate as psage
from repro_torch.kernels import sim_topk as psim
from torch_parity import assert_topk_match, gram_rows

ATOL = 1e-5


def _adj(rng, m, n, *, normalized):
    a = (rng.random((m, n, n)) < 0.2).astype(np.float32)
    a[:, 0, :] = 0.0                       # an isolated row: the clamp matters
    if normalized:
        a = a / np.maximum(a.sum(-1, keepdims=True), 1.0)
    else:
        a *= rng.uniform(0.5, 2.0, size=a.shape).astype(np.float32)
    return a


class TestSageAggregate:
    @pytest.mark.parametrize("m,n,d,normalized", [
        (3, 37, 11, True),      # ragged, the main path's row-normalized A
        (2, 130, 5, False),     # crosses a 128 block, raw weights (deg > 1)
        (1, 9, 133, False),     # wide d crosses a 128 block
    ])
    def test_forward_matches_pallas(self, m, n, d, normalized):
        rng = np.random.default_rng(n * 100 + d)
        adj = _adj(rng, m, n, normalized=normalized)
        h = rng.normal(size=(m, n, d)).astype(np.float32)
        want = np.stack([np.asarray(jops.sage_aggregate(jnp.asarray(adj[i]),
                                                        jnp.asarray(h[i]),
                                                        interpret=True))
                         for i in range(m)])
        got = pops.sage_aggregate(torch.from_numpy(adj), torch.from_numpy(h))
        assert got.shape == (m, n, d) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)

    def test_grads_match_jax(self):
        rng = np.random.default_rng(7)
        m, n, d = 3, 41, 6
        adj = _adj(rng, m, n, normalized=False)
        h = rng.normal(size=(m, n, d)).astype(np.float32)
        g = rng.normal(size=(m, n, d)).astype(np.float32)

        def jloss(a, x):
            out = jax.vmap(lambda ai, xi: jops.sage_aggregate(ai, xi, interpret=True))(a, x)
            return jnp.sum(out * g)
        ja, jh = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(adj), jnp.asarray(h))
        ta = torch.from_numpy(adj).requires_grad_(True)
        th = torch.from_numpy(h).requires_grad_(True)
        torch.sum(pops.sage_aggregate(ta, th) * torch.from_numpy(g)).backward()
        np.testing.assert_allclose(th.grad.numpy(), np.asarray(jh), atol=ATOL)
        np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ja), atol=ATOL)

    # (writes): a -Inf in A against a +Inf and a -Inf in the same row of H,
    # then against a -Inf alone: the products the CUDA kernel's split cannot
    # form, which its epilogue recomputes.
    @pytest.mark.parametrize("writes", [
        (("adj", (0, 5, 3), -np.inf), ("h", (0, 3, 1), np.inf), ("h", (0, 3, 2), -np.inf)),
        (("adj", (1, 8, 12), -np.inf), ("h", (1, 12, 4), -np.inf)),
    ])
    def test_minus_inf_against_inf_matches_pallas(self, writes):
        rng = np.random.default_rng(5)
        adj = _adj(rng, 2, 37, normalized=False)
        h = rng.normal(size=(2, 37, 11)).astype(np.float32)
        for operand, at, value in writes:
            (adj if operand == "adj" else h)[at] = value
        want = np.stack([np.asarray(jops.sage_aggregate(jnp.asarray(adj[i]), jnp.asarray(h[i]),
                                                        interpret=True))
                         for i in range(2)])
        got = pops.sage_aggregate(torch.from_numpy(adj), torch.from_numpy(h)).numpy()
        row = writes[0][1]
        assert np.isinf(want[row[0], row[1]]).any()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_allclose(got, want, atol=ATOL, equal_nan=True)

    def test_cpu_tensor_takes_plain_version(self):
        before = psage.launches
        x = torch.ones(2, 3, 3)
        out = pops.sage_aggregate(x, torch.ones(2, 3, 4))
        assert psage.launches == before
        torch.testing.assert_close(out, torch.ones(2, 3, 4))

    def test_unsupported_device_raises(self):
        x = torch.ones(1, 3, 3, device="meta")
        with pytest.raises(ValueError, match="no implementation"):
            pops.sage_aggregate(x, torch.ones(1, 3, 2, device="meta"))

    def test_kernel_wrapper_refuses_cpu_tensors(self):
        with pytest.raises(ValueError, match="CUDA"):
            psage.launch(torch.ones(1, 3, 3), torch.ones(1, 3, 2))


def _sim_inputs(seed, n, c, n_clients, *, dup=True):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, c)).astype(np.float32)
    if dup:
        h[5] = h[2]                       # exact duplicate rows: exact ties
        h[9] = h[2]
    cid = rng.integers(0, n_clients, size=n).astype(np.int32)
    mask = (rng.random(n) < 0.7).astype(np.float32)
    return h, cid, mask


class TestSimTopk:
    @pytest.mark.parametrize("n,c,k,n_clients,col_offset", [
        (37, 7, 4, 3, 0),
        (300, 15, 5, 4, 0),     # crosses the Pallas column block
        (23, 3, 6, 5, 100),     # shifted indices
    ])
    def test_matches_pallas(self, n, c, k, n_clients, col_offset):
        h, cid, mask = _sim_inputs(n + c, n, c, n_clients)
        jv, ji = jops.sim_topk(jnp.asarray(h), jnp.asarray(cid), jnp.asarray(mask), k,
                               col_offset=col_offset, interpret=True)
        pv, pi = pops.sim_topk(torch.from_numpy(h), torch.from_numpy(cid),
                               torch.from_numpy(mask), k, col_offset=col_offset)
        assert pv.dtype == torch.float32 and pi.dtype == torch.int32
        unshift = lambda i: np.where(i >= 0, i - col_offset, -1)  # noqa: E731
        assert_topk_match(pv.numpy(), unshift(pi.numpy()), np.asarray(jv),
                          unshift(np.asarray(ji)), gram_rows(h), atol=ATOL)

    def test_fewer_valid_targets_than_k(self):
        h, cid, _ = _sim_inputs(3, 16, 4, 2)
        mask = np.zeros(16, np.float32)
        mask[[1, 2, 3]] = 1.0             # at most 3 targets for every row
        jv, ji = jops.sim_topk(jnp.asarray(h), jnp.asarray(cid), jnp.asarray(mask), 5,
                               interpret=True)
        pv, pi = pref.sim_topk(torch.from_numpy(h), torch.from_numpy(cid),
                               torch.from_numpy(mask), 5)
        assert (pi.numpy()[:, 3:] == -1).all()
        assert np.isneginf(pv.numpy()[:, 3:]).all()
        assert_topk_match(pv.numpy(), pi.numpy(), np.asarray(jv), np.asarray(ji),
                          gram_rows(h), atol=ATOL)

    def test_duplicate_rows_tie_to_smallest_index(self):
        h = np.ones((8, 4), np.float32)   # every score is equal
        cid = np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int32)
        mask = np.ones(8, np.float32)
        _, ji = jops.sim_topk(jnp.asarray(h), jnp.asarray(cid), jnp.asarray(mask), 3,
                              interpret=True)
        _, pi = pref.sim_topk(torch.from_numpy(h), torch.from_numpy(cid),
                              torch.from_numpy(mask), 3)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(pi.numpy()[0], [2, 3, 4])

    def test_batched_over_servers(self):
        """The [N] axis of the port equals N separate reference calls."""
        hs, cids, masks = zip(*(_sim_inputs(s, 29, 5, 3) for s in range(3)))
        h, mask = np.stack(hs), np.stack(masks)
        cid = cids[0]
        pv, pi = pops.sim_topk(torch.from_numpy(h), torch.from_numpy(cid),
                               torch.from_numpy(mask), 4)
        for b in range(3):
            jv, ji = jops.sim_topk(jnp.asarray(h[b]), jnp.asarray(cid),
                                   jnp.asarray(mask[b]), 4, interpret=True)
            assert_topk_match(pv[b].numpy(), pi[b].numpy(), np.asarray(jv),
                              np.asarray(ji), gram_rows(h[b]), atol=ATOL)

    def test_similarity_topk_matches_reference_path(self):
        """imputation.similarity_topk: the 0.0 / -1 mapping of invalid rows."""
        n, n_servers = 45, 2
        rng = np.random.default_rng(11)
        h = rng.normal(size=(n_servers, n, 6)).astype(np.float32)
        h[0, 7] = h[0, 3]
        flat = (rng.random((n_servers, n)) < 0.8).astype(np.float32)
        target = flat * (rng.random((n_servers, n)) < 0.8)
        cid = np.repeat(np.arange(3, dtype=np.int32), 15)
        ps, pi = pimp.similarity_topk(torch.from_numpy(h), torch.from_numpy(flat),
                                      torch.from_numpy(cid), 4,
                                      target_mask=torch.from_numpy(target))
        for b in range(n_servers):
            js, ji = jimp.similarity_topk(jnp.asarray(h[b]), jnp.asarray(flat[b]),
                                          jnp.asarray(cid), 4, kernel_impl="reference",
                                          target_mask=jnp.asarray(target[b]))
            assert_topk_match(ps[b].numpy(), pi[b].numpy(), np.asarray(js),
                              np.asarray(ji), gram_rows(h[b]), atol=ATOL)
            assert (pi[b].numpy()[flat[b] == 0] == -1).all()
            assert (ps[b].numpy()[flat[b] == 0] == 0.0).all()

    def test_k_out_of_range_raises(self):
        with pytest.raises(ValueError, match="k"):
            pref.sim_topk(torch.ones(3, 2), torch.zeros(3), torch.ones(3), 4)

    def test_kernel_wrapper_refuses_cpu_tensors(self):
        before = psim.launches
        with pytest.raises(ValueError, match="CUDA"):
            psim.launch(torch.ones(1, 3, 2), torch.zeros(3), torch.ones(1, 3), 2)
        assert psim.launches == before


def _block_inputs(seed, b, n, c, dtype):
    """rows [b, c], h [n, c] from one numpy seed, as (jax, torch) pairs in ``dtype``
    (both packages round the same f32 values to bf16 to nearest even)."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(b, c)).astype(np.float32)
    h = rng.normal(size=(n, c)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                       torch.bfloat16)
    return ((jnp.asarray(rows).astype(jdt), jnp.asarray(h).astype(jdt)),
            (torch.from_numpy(rows).to(tdt), torch.from_numpy(h).to(tdt)))


def _as_f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


class TestSimBlock:
    """``ops.sim_block`` on the CPU (the plain version the CUDA kernel is held
    against) against the JAX kernel in interpret mode and its oracle, with the
    JAX tests' own tolerances: 1e-5 in f32, 3e-2 in bf16 (absolute and relative)."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("b,n,c", [(64, 300, 7), (128, 1024, 15), (10, 33, 6),
                                       (256, 512, 10)])
    def test_matches_pallas(self, b, n, c, dtype):
        (jr, jh), (tr, th) = _block_inputs(b * 1000 + n, b, n, c, dtype)
        got = pops.sim_block(tr, th)
        assert got.shape == (b, n) and got.dtype == tr.dtype
        tol = 1e-5 if dtype == "float32" else 3e-2
        for want in (jops.sim_block(jr, jh, interpret=True), jref.sim_block(jr, jh)):
            np.testing.assert_allclose(_as_f32(got), _as_f32(want), atol=tol, rtol=tol)

    @pytest.mark.parametrize("b,n,c,bm,bn", [(33, 70, 7, 16, 32), (5, 200, 10, 8, 64),
                                             (96, 96, 6, 128, 512)])
    def test_non_multiple_shapes(self, b, n, c, bm, bn):
        (jr, jh), (tr, th) = _block_inputs(b + n, b, n, c, "float32")
        want = jops.sim_block(jr, jh, block_m=bm, block_n=bn, interpret=True)
        np.testing.assert_allclose(pops.sim_block(tr, th).numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)

    def test_gram_symmetry(self):
        h = np.random.default_rng(96).normal(size=(96, 7)).astype(np.float32)
        gram = pops.sim_block(torch.from_numpy(h), torch.from_numpy(h)).numpy()
        np.testing.assert_allclose(gram, gram.T, atol=1e-5, rtol=1e-5)
        want = jops.sim_block(jnp.asarray(h), jnp.asarray(h), interpret=True)
        np.testing.assert_allclose(gram, np.asarray(want), atol=1e-5, rtol=1e-5)

    def test_cpu_tensor_takes_plain_version(self):
        before = psim.block_launches
        out = pops.sim_block(torch.ones(2, 3), torch.ones(4, 3))
        assert psim.block_launches == before
        torch.testing.assert_close(out, torch.full((2, 4), 3.0))

    def test_unsupported_device_raises(self):
        with pytest.raises(ValueError, match="no implementation"):
            pops.sim_block(torch.ones(2, 3, device="meta"), torch.ones(4, 3, device="meta"))

    def test_kernel_wrapper_refuses_cpu_tensors(self):
        before = psim.block_launches
        with pytest.raises(ValueError, match="CUDA"):
            psim.launch_block(torch.ones(2, 3), torch.ones(4, 3))
        assert psim.block_launches == before


class TestTopkMerge:
    @pytest.mark.parametrize("k,m", [(1, 5), (4, 9), (6, 3)])
    def test_matches_reference_merge(self, k, m):
        rng = np.random.default_rng(k * 10 + m)
        rows = 12
        # Values from a small set, so ties are common; some slots unfilled.
        run_v = np.sort(rng.integers(0, 4, size=(rows, k)).astype(np.float32), -1)[:, ::-1]
        run_i = rng.permutation(rows * k).reshape(rows, k).astype(np.int32) + 1000
        run_v[:3, -1], run_i[:3, -1] = -np.inf, -1
        slab_v = rng.integers(0, 4, size=(rows, m)).astype(np.float32)
        slab_v[rng.random((rows, m)) < 0.3] = -np.inf
        slab_i = np.tile(np.arange(m, dtype=np.int32), (rows, 1))
        jv, ji = jsim.topk_merge(*map(jnp.asarray, (run_v.copy(), run_i, slab_v, slab_i)))
        pv, pi = pref.topk_merge(*map(torch.from_numpy, (run_v.copy(), run_i, slab_v, slab_i)))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))

    @pytest.mark.parametrize("chunk,order", [(64, "ascending"), (64, "shuffled"),
                                             (100, "shuffled")])
    def test_folding_chunk_lists_matches_unsplit(self, chunk, order):
        """What the CUDA kernel does: a partial top-k per chunk of candidates,
        then the chunks' lists folded by topk_merge in any order. Integer
        features make scores exact and mostly tied, and copies of one row sit
        on both sides of chunk edges: the indices must equal the unsplit
        top-k's exactly, in both packages."""
        rng = np.random.default_rng(chunk)
        n, c, k = 300, 3, 5
        h = rng.integers(-2, 3, size=(n, c)).astype(np.float32)
        for j in (chunk - 1, chunk, 2 * chunk - 1, 2 * chunk, n - 1):
            h[j] = h[7]
        cid = np.array([7, -3, 1000])[rng.integers(0, 3, n)].astype(np.int32)
        mask = (rng.random(n) < 0.8).astype(np.float32)
        gram = h @ h.T
        gram[(cid[:, None] == cid[None, :]) | (mask[None, :] <= 0)] = -np.inf
        starts = list(range(0, n, chunk))
        if order == "shuffled":
            rng.shuffle(starts)
        empty_v = np.full((n, k), -np.inf, np.float32)
        empty_i = np.full((n, k), -1, np.int32)
        got = {}
        for pkg, merge, conv, back in (
                ("jax", jsim.topk_merge, jnp.asarray, np.asarray),
                ("torch", pref.topk_merge, torch.from_numpy, lambda t: t.numpy())):
            run_v, run_i = conv(empty_v), conv(empty_i)
            for j0 in starts:
                cols = np.arange(j0, min(n, j0 + chunk), dtype=np.int32)
                slab_i = np.ascontiguousarray(np.broadcast_to(cols, (n, len(cols))))
                part_v, part_i = merge(conv(empty_v), conv(empty_i),
                                       conv(np.ascontiguousarray(gram[:, cols])), conv(slab_i))
                run_v, run_i = merge(run_v, run_i, part_v, part_i)
            got[pkg] = back(run_v), back(run_i)
        want_v, want_i = pref.sim_topk(torch.from_numpy(h), torch.from_numpy(cid),
                                       torch.from_numpy(mask), k)
        for vals, idx in got.values():
            np.testing.assert_array_equal(vals, want_v.numpy())
            np.testing.assert_array_equal(idx, want_i.numpy())

    def test_stable_topk_matches_lax_top_k(self):
        x = np.array([[1.0, 3.0, 3.0, -np.inf, 3.0, 0.5],
                      [-np.inf, -np.inf, 2.0, 2.0, -np.inf, 1.0]], np.float32)
        jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
        pv, pi = pref.stable_topk(torch.from_numpy(x), 4)
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
