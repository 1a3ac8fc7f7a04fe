"""Helpers shared by the port's parity tests (tests/test_torch_*.py)."""
import numpy as np

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
