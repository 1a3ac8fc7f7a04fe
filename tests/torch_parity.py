"""Helpers shared by the port's parity tests (tests/test_torch_*.py). JAX is
imported only inside the helpers that need it: the CUDA tests import this
module on a machine without JAX."""
import numpy as np
import torch

# A JAX (XLA) dot and a torch dot of the same f32 vectors may sum in other
# orders and differ by a few ulps, so two candidates whose scores are closer
# than this may swap places between the packages.
TIE_TOL = 1e-5


def assert_topk_match(vals_p, idx_p, vals_j, idx_j, scores_of, *, atol=1e-5):
    """Top-k agreement under the tie rule.

    ``vals``/``idx`` are [..., n, k] (port ``_p``, reference ``_j``).
    ``scores_of(lead, row)`` gives the row's exact float64 score of every
    candidate (the gram row). Values agree within ``atol``; unfilled slots
    (-1) agree exactly; where the two picked different candidates, their
    exact scores are within ``TIE_TOL`` of each other (a near tie), and
    nowhere else may the indices differ.
    """
    vals_p, vals_j = np.asarray(vals_p), np.asarray(vals_j)
    idx_p, idx_j = np.asarray(idx_p), np.asarray(idx_j)
    assert vals_p.shape == vals_j.shape and idx_p.shape == idx_j.shape
    np.testing.assert_allclose(vals_p, vals_j, atol=atol, err_msg="top-k scores")
    np.testing.assert_array_equal(idx_p < 0, idx_j < 0, err_msg="unfilled slots")
    for pos in zip(*np.nonzero(idx_p != idx_j)):
        *lead, row, _ = pos
        full = scores_of(tuple(lead), row)
        gap = abs(full[idx_p[pos]] - full[idx_j[pos]])
        assert gap <= TIE_TOL, (f"idx differ at {pos}: {idx_p[pos]} vs {idx_j[pos]} "
                                f"with score gap {gap:.3g} > {TIE_TOL}")


def gram_rows(h):
    """scores_of for a [..., n, c] feature array: float64 row of h @ hᵀ."""
    h64 = np.asarray(h, np.float64)

    def scores_of(lead, row):
        hb = h64[lead] if lead else h64
        return hb @ hb[row]
    return scores_of


def tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties away from zero."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    """The CUDA kernels' split (csrc/tf32.cuh): finite x -> (tf32(x),
    tf32(x - hi)); else (0, x)."""
    x = np.asarray(x, dtype=np.float32)
    finite = np.isfinite(x)
    hi = np.where(finite, tf32(x), np.float32(0.0))
    return hi, np.where(finite, tf32(x - hi), x)


def log_drops(monkeypatch, capacity_factor):
    """Wrap the port's ``moe.slot_positions`` for one test: every MoE layer
    it routes appends the share of its (token, k) slots whose position
    reaches the capacity ``apply_moe`` derives from ``capacity_factor`` and
    the group's shape (a float). Returns the list."""
    from repro_torch.models import moe

    log, slot_positions = [], moe.slot_positions

    def logged(topi, num_experts):
        pos = slot_positions(topi, num_experts)
        _, t, k = topi.shape
        cap = max(1, int(capacity_factor * t * k / num_experts))
        log.append(1.0 - (pos < cap).double().mean().item())
        return pos

    monkeypatch.setattr(moe, "slot_positions", logged)
    return log


def assert_init_like(got: dict, want: dict) -> None:
    """A port ``init_model``'s state dict against the reference's weights
    carried across (``want``): the same names, shapes and dtypes; leaves the
    reference fills with one value (ones, zeros) or a fixed vector (mamba's
    ``a_log``, the sLSTM's ``b_in``, learned positions excepted) equal to
    1e-6; truncated normals whose std is within 5 % of the reference's draw,
    or for a leaf of fewer than 6400 elements within 4 / sqrt(n), four
    standard errors of the two samples' ratio."""
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        leaf = name.rsplit(".", 1)[-1]
        if torch.all(w == w.flatten()[0]) or leaf in ("a_log", "b_in"):
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=name)
        else:
            tol = max(0.05, 4 / w.numel() ** 0.5)
            assert abs(g.float().std().item() / w.float().std().item() - 1) < tol, name


def assert_round_trip(model, params) -> None:
    """``convert.lm_params_to_jax(model)`` gives the reference's tree
    ``params`` back leaf for leaf, and ``lm_params_from_jax`` of it the same
    model."""
    import jax

    from repro_torch.convert import lm_params_from_jax, lm_params_to_jax
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), lm_params_to_jax(model)))[0]
    want = {jax.tree_util.keystr(p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert sorted(jax.tree_util.keystr(p) for p, _ in got) == sorted(want)
    for path, leaf in got:
        np.testing.assert_array_equal(leaf, np.asarray(want[jax.tree_util.keystr(path)]))
    back = lm_params_from_jax(lm_params_to_jax(model), model.cfg, "cpu").state_dict()
    for name, t in model.state_dict().items():
        assert torch.equal(back[name], t), name
