"""The arithmetic of the CUDA f32 ``flash_attention`` backward, on the CPU.

The kernel (``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``) runs
the backward's products on the tensor cores in TF32, which keeps 10 mantissa
bits, with the 3-pass split of ``csrc/tf32.cuh``: each operand is
``x = hi + lo`` (both TF32, rounded to nearest with ties away from zero; a
non-finite x all lo) and each product ``x_lo y_hi + x_hi y_lo + x_hi y_hi``
in f32. Its dK/dV kernel computes ``Sᵀ = K Qᵀ`` and ``dPᵀ = V dOᵀ`` over
tiles of query rows, then ``dV += Pᵀ dO`` and ``dK += dSᵀ Q``; its dQ kernel
computes ``S = Q Kᵀ`` and ``dP = dO Vᵀ`` over tiles of keys, then
``dQ += dS K``. Here those sums are emulated tile by tile in numpy: TF32
rounding by bit arithmetic (``torch_parity.tf32`` / ``split``), one f32
rounding per ``mma`` of a k-step of 8, the two small passes of S and dP in
an accumulator of their own, each tile's dV, dK or dQ product in a fresh
accumulator added to the running sum in f32, P = exp2(S scale log2(e) - L
log2(e)) with one rounding before the exponential, dS = P (dP - D), and the
masks applied by selection. P and dS are split with the finiteness test.
Their A fragments are taken from the C fragment by the kernel's lane rule,
and the B fragments from the pair planes by the kernel's read rule, so a
mismatch of the two row (or key) orders shows as a wrong result.

The three passes hold 1e-5 (absolute and relative) against the port's plain
``ref.flash_attention_bwd`` and against ``jax.vjp`` of the JAX package's
plain attention (``models.attention._sdpa``, the attention it trains with),
at Qwen3-4B's head dim 80 and at 128; one pass (hi x hi in every product)
misses 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import ref
from torch_parity import split, tf32

TOL = 1e-5
LOG2E = np.float32(1.4426950408889634)
GPU_NAN = np.array([0x7FFFFFFF], dtype=np.uint32).view(np.float32)[0]   # the card's NaN


def _tiles(d):
    """The kernel's tiles: (query rows per dK/dV tile, keys per dQ tile)."""
    return {128: (16, 32), 240: (8, 8)}.get(d, (32, 32))


def _a_fragment_cols():
    """Column of a C tile that each mma index k of the A fragment built from
    it holds: lane (g, t)'s accumulator element e is row g + 8 (e >> 1),
    column 2t + (e & 1), and the kernel uses it as A element
    (e >> 1) | ((e & 1) << 1), which is row g + 8 (a & 1), index
    t + 4 (a >> 1). The same rule places the raw K, V (dK/dV) and Q, dO (dQ)
    A fragments: column 2t at index t, 2t + 1 at t + 4."""
    cols = np.full(8, -1)
    for t in range(4):
        for e in range(4):
            a = (e >> 1) | ((e & 1) << 1)
            assert (a & 1) == (e >> 1)                # same row
            cols[t + 4 * (a >> 1)] = 2 * t + (e & 1)
    return cols


def _b_fragment_rows():
    """Row of an 8-row slab (query rows, keys or head-dim columns) that each
    mma index k of a B fragment read from a pair plane holds: lane (g, t)
    reads plane floats 4t..4t + 3 of plane row g, (hi, hi, lo, lo) of slab
    rows 2t and 2t + 1, so b0 (index t) is row 2t and b1 (index t + 4) row
    2t + 1."""
    rows = np.full(8, -1)
    for t in range(4):
        rows[t], rows[t + 4] = 2 * t, 2 * t + 1
    return rows


A_COLS, B_ROWS = _a_fragment_cols(), _b_fragment_rows()


def _mma(acc, a, b):
    """acc + a @ b with one f32 rounding, as one tensor-core k-step."""
    return (acc.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64)).astype(
        np.float32)


def _product(a, b, passes, acc=None):
    """a @ b over k-steps of 8 as the kernel's mma.sync: a = (hi, lo) [M, K],
    b = (hi, lo) [K, N]. With ``acc`` None (S and dP): the two small passes
    into an accumulator of their own, the large one into another, added
    after the last k-step. Otherwise (dV, dK, dQ): all three passes into a
    fresh accumulator, small ones first, added to ``acc`` in f32."""
    (a_hi, a_lo), (b_hi, b_lo) = a, b
    kdim = a_hi.shape[1]
    big = np.zeros((a_hi.shape[0], b_hi.shape[1]), np.float32)
    small = np.zeros_like(big)
    for c in range(0, kdim, 8):
        width = min(8, kdim - c)            # the last tile may end early
        ka, kb = c + A_COLS[A_COLS < width], c + B_ROWS[B_ROWS < width]
        if passes == 3 and acc is None:
            small = _mma(small, a_lo[:, ka], b_hi[kb])
            small = _mma(small, a_hi[:, ka], b_lo[kb])
        elif passes == 3:
            big = _mma(big, a_lo[:, ka], b_hi[kb])
            big = _mma(big, a_hi[:, ka], b_lo[kb])
        big = _mma(big, a_hi[:, ka], b_hi[kb])
    if acc is None:
        return (big + small).astype(np.float32)
    return (acc + big).astype(np.float32)


def _split(x, passes, finite_test=True):
    """(hi, lo) of x; one pass keeps hi alone. Without the finiteness test
    the card's NaN (0x7fffffff) rounds to hi = lo = -0."""
    if passes == 1:
        return split(x)[0], np.zeros_like(x)
    if finite_test:
        return split(x)
    x = np.where(np.isnan(x), GPU_NAN, x)
    hi = tf32(x)
    return hi, tf32(x - hi)


def _visible(rows, keys, off, window):
    qpos = rows[:, None] + off
    keep = keys[None] <= qpos
    if window is not None:
        keep &= keys[None] > qpos - window
    return keep


def _probs(s, dp, l_log2, delta, keep, sl2):
    """P = exp2(s sl2 - L log2(e)) (one rounding before ex2) and
    dS = P (dP - D), both 0 by selection where the pair is masked."""
    with np.errstate(invalid="ignore", over="ignore"):
        x = (s.astype(np.float64) * sl2 - l_log2).astype(np.float32)
        p = np.exp2(x.astype(np.float64)).astype(np.float32)
        ds = (p * (dp - delta).astype(np.float32)).astype(np.float32)
    return np.where(keep, p, np.float32(0)), np.where(keep, ds, np.float32(0))


def kernel_dkdv(q, k, v, do, lse, delta, *, window=None, passes=3, finite_test=True):
    """The dK/dV kernel's sums for one kv head: q, do [G, Sq, D] (the
    group's q heads), k, v [Skv, D], lse, delta [G, Sq]; float32."""
    g_heads, sq, d = q.shape
    skv = k.shape[0]
    bq, _ = _tiles(d)
    scale = np.float32(d ** -0.5)
    sl2 = np.float32(scale * LOG2E)
    ks, vs = _split(k, passes), _split(v, passes)
    keys = np.arange(skv)
    dk = np.zeros((skv, d), np.float32)
    dv = np.zeros((skv, d), np.float32)
    for h in range(g_heads):
        qs, dos = _split(q[h], passes), _split(do[h], passes)
        for q0 in range(0, sq, bq):
            rows = np.arange(q0, min(q0 + bq, sq))
            tr = lambda x: (x[0][rows].T, x[1][rows].T)  # noqa: E731
            st = _product(ks, tr(qs), passes)           # Sᵀ [keys, rows]
            dpt = _product(vs, tr(dos), passes)         # dPᵀ
            keep = _visible(rows, keys, skv - sq, window).T
            l_log2 = (lse[h, rows] * LOG2E).astype(np.float32)
            pt, dst = _probs(st, dpt, l_log2[None], delta[h, rows][None], keep, sl2)
            rs = lambda x: (x[0][rows], x[1][rows])    # noqa: E731
            dv = _product(_split(pt, passes, finite_test), rs(dos), passes, acc=dv)
            dk = _product(_split(dst, passes, finite_test), rs(qs), passes, acc=dk)
    return (dk * scale).astype(np.float32), dv


def kernel_dq(q, k, v, do, lse, delta, *, window=None, passes=3):
    """The dQ kernel's sums for one q head: q, do [Sq, D], k, v [Skv, D] (its
    kv head), lse, delta [Sq]; float32."""
    sq, d = q.shape
    skv = k.shape[0]
    _, bkv = _tiles(d)
    scale = np.float32(d ** -0.5)
    sl2 = np.float32(scale * LOG2E)
    qs, dos = _split(q, passes), _split(do, passes)
    ks, vs = _split(k, passes), _split(v, passes)
    rows = np.arange(sq)
    l_log2 = (lse * LOG2E).astype(np.float32)[:, None]
    dq = np.zeros((sq, d), np.float32)
    for kb in range(0, skv, bkv):
        keys = np.arange(kb, min(kb + bkv, skv))
        tr = lambda x: (x[0][keys].T, x[1][keys].T)    # noqa: E731
        s = _product(qs, tr(ks), passes)
        dp = _product(dos, tr(vs), passes)
        keep = _visible(rows, keys, skv - sq, window)
        _, ds = _probs(s, dp, l_log2, delta[:, None], keep, sl2)
        dq = _product(_split(ds, passes), (ks[0][keys], ks[1][keys]), passes, acc=dq)
    return (dq * scale).astype(np.float32)


def kernel_bwd(q, k, v, o, do, lse, *, window=None, passes=3, finite_test=True):
    """(dq, dk, dv) of the kernel for [B, H, S, D] inputs, q head h reading
    kv head h // G, from the forward's o and lse."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    grp = hq // hkv
    delta = np.sum(do * o, axis=-1, dtype=np.float32)     # the D pass, f32
    dq = np.zeros_like(q)
    dk, dv = np.zeros_like(k), np.zeros_like(v)
    for bi in range(b):
        for j in range(hkv):
            hs = slice(j * grp, (j + 1) * grp)
            dk[bi, j], dv[bi, j] = kernel_dkdv(q[bi, hs], k[bi, j], v[bi, j], do[bi, hs],
                                               lse[bi, hs], delta[bi, hs], window=window,
                                               passes=passes, finite_test=finite_test)
            for h in range(j * grp, (j + 1) * grp):
                dq[bi, h] = kernel_dq(q[bi, h], k[bi, j], v[bi, j], do[bi, h], lse[bi, h],
                                      delta[bi, h], window=window, passes=passes)
    return dq, dk, dv


def _inputs(b, hq, hkv, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d),
                               (b, hq, sq, d)))


def _forward(q, k, v, window):
    """The forward's output and row log-sum-exp (the plain versions)."""
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    return (ref.flash_attention(tq, tk, tv, window=window).numpy(),
            ref.flash_attention_lse(tq, tk, window=window).numpy())


def test_fragment_orders_agree():
    """The A fragment a C fragment gives and the B fragment a pair plane
    gives hold the same row at every mma index: rows 0, 2, 4, 6 at indices
    0-3, rows 1, 3, 5, 7 at 4-7."""
    np.testing.assert_array_equal(_a_fragment_cols(), [0, 2, 4, 6, 1, 3, 5, 7])
    np.testing.assert_array_equal(_b_fragment_rows(), _a_fragment_cols())


# (b, hq, hkv, sq, skv, d, window): Qwen3-4B's head dim with GQA 2:1 over
# four dK/dV row tiles and eight dQ key tiles; fewer queries than keys, 173
# keys (the last dQ tile holds 13); D = 128 (16-row dK/dV tiles) with a
# window and MQA; D = 240 (8-row dK/dV tiles, 8-key dQ tiles, dK and dV by
# warps of their own: the same sums) with GQA 2:1 and a window, then fewer
# queries than keys, 91 keys (the last dQ tile holds 3).
SHAPES = [(1, 4, 2, 128, 256, 80, None), (1, 2, 1, 77, 173, 80, None),
          (1, 2, 1, 120, 120, 128, 40), (1, 4, 2, 64, 64, 240, 24),
          (1, 2, 1, 45, 91, 240, None)]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,window", SHAPES)
def test_three_passes_hold_f32(b, hq, hkv, sq, skv, d, window):
    q, k, v, do = _inputs(b, hq, hkv, sq, skv, d, seed=sq + d)
    o, lse = _forward(q, k, v, window)
    got = kernel_bwd(q, k, v, o, do, lse, window=window)
    plain = ref.flash_attention_bwd(*(torch.from_numpy(x) for x in (q, k, v, o, do, lse)),
                                    window=window)

    def attend(q, k, v):
        return jattn._sdpa(q, k, v, causal=True, window=window or 0, q_offset=skv - sq)
    _, vjp = jax.vjp(attend, *(jnp.asarray(x) for x in (q, k, v)))
    oracle = vjp(jnp.asarray(do))
    for name, g, p, j in zip(("dq", "dk", "dv"), got, plain, oracle):
        np.testing.assert_allclose(g, p.numpy(), atol=TOL, rtol=TOL, err_msg=name)
        np.testing.assert_allclose(g, np.asarray(j), atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,window", SHAPES[::2])
def test_one_pass_misses_f32(b, hq, hkv, sq, skv, d, window):
    q, k, v, do = _inputs(b, hq, hkv, sq, skv, d, seed=sq + d)
    o, lse = _forward(q, k, v, window)
    one = kernel_bwd(q, k, v, o, do, lse, window=window, passes=1)
    plain = ref.flash_attention_bwd(*(torch.from_numpy(x) for x in (q, k, v, o, do, lse)),
                                    window=window)
    assert not all(np.allclose(g, p.numpy(), atol=TOL, rtol=TOL) for g, p in zip(one, plain))


@pytest.mark.parametrize("finite_test", [True, False])
def test_nan_in_do_reaches_dv_only_with_the_finiteness_test(finite_test):
    """A NaN in dO (q head 1, row 70, column 5 of a GQA 2:1 input) reaches
    dq's row, the dk of the keys row 70 sees and those keys' dv column 5.
    dS is NaN there and carries it to dq and dk either way; P is finite, so
    dv's NaN comes from dO's split. The backward has no row sum l to carry a
    NaN of P: split without the finiteness test, a NaN P or dS would become
    -0 and leave finite gradients, which the kernel's split does not."""
    q, k, v, do = _inputs(1, 2, 1, 130, 130, 80, seed=7)
    o, lse = _forward(q, k, v, None)
    do[0, 1, 70, 5] = np.nan
    dq, dk, dv = kernel_bwd(q, k, v, o, do, lse, finite_test=finite_test)
    assert np.isnan(dq[0, 1, 70]).all() and np.isfinite(dq[0, 0]).all()
    assert np.isnan(dv[0, 0, :71, 5]).all()
    if finite_test:
        assert np.isnan(dk[0, 0, :71]).all() and np.isfinite(dk[0, 0, 71:]).all()
    else:      # dS's NaN is lost before dK's product
        assert np.isfinite(dk).all()
