"""The arithmetic of the CUDA f32 ``flash_attention`` backward, on the CPU.

The kernel (``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``) runs
the backward's products on the tensor cores in TF32 (``wgmma``), which keeps
10 mantissa bits, with the 3-pass split of ``csrc/tf32.cuh``: each operand
is ``x = hi + lo`` (both TF32, rounded to nearest with ties away from zero;
a non-finite x all lo) and each product ``x_lo y_hi + x_hi y_lo + x_hi y_hi``
in f32. Its dK/dV kernel takes blocks of 64 keys and computes ``Sᵀ = K Qᵀ``
and ``dPᵀ = V dOᵀ`` over the tiles of query rows that see them, then
``dV += Pᵀ dO`` and ``dK += dSᵀ Q``; its dQ kernel takes blocks of 64 query
rows and computes ``S = Q Kᵀ`` and ``dP = dO Vᵀ`` over tiles of keys, then
``dQ += dS K``. Two consumer warpgroups take a block's tiles in turn, each
summing its own, and the first adds the second's sums to its own at the end.
Here those sums are emulated tile by tile in numpy, with the tile sizes read
from the ``.cu`` source: TF32 rounding by bit arithmetic
(``torch_parity.tf32`` / ``split``), one f32 rounding per k-step of 8, the
two small passes of S and dP in an accumulator of their own, each tile's dV,
dK or dQ product in a fresh accumulator added to its warpgroup's running sum
in f32, P = exp2(S scale log2(e) - L log2(e)) with one rounding before the
exponential, dS = P (dP - D), and the masks applied by selection. P and dS
are split with the finiteness test. Their A fragments are taken from the C
fragment by the kernel's lane rule, and the B fragments from the transposed
planes in the order the kernel's pre-pass writes them, so a mismatch of the
two row (or key) orders shows as a wrong result.

The three passes hold 1e-5 (absolute and relative) against the port's plain
``ref.flash_attention_bwd`` and against ``jax.vjp`` of the JAX package's
plain attention (``models.attention._sdpa``, the attention it trains with),
at Qwen3-4B's head dim 80 and at 128; one pass (hi x hi in every product)
misses 1e-5.
"""
import re
from pathlib import Path

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
SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
          / "flash_attention_bwd.cu").read_text()
# The pre-pass the backward launches, shared with the f32 forward.
SPLIT_SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
                / "tf32.cuh").read_text()
BLOCK = int(re.search(r"constexpr int ROWS = (\d+);", SOURCE).group(1))
CONSUMERS = int(re.search(r"constexpr int CONSUMERS = (\d+);", SOURCE).group(1))
BT = {int(d): int(bt) for d, bt in re.findall(
    r"struct F32Tiling<(\d+)> \{\s*static constexpr int BT = (\d+),", SOURCE)}


def _tiles(d):
    """The kernel's tiles: (query rows per dK/dV tile, keys per dQ tile)."""
    return BT[d], BT[d]


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
    """Row of an 8-row slab (query rows or keys) that each k index of a B
    operand read from a transposed plane holds: the pre-pass writes row r of
    each group of 8 at position (r >> 1) | ((r & 1) << 2) (the kernel's
    `pos`), and wgmma reads position k as k index k."""
    rows = np.full(8, -1)
    for r in range(8):
        rows[(r >> 1) | ((r & 1) << 2)] = r
    return rows


A_COLS, B_ROWS = _a_fragment_cols(), _b_fragment_rows()


def _mma(acc, a, b):
    """acc + a @ b with one f32 rounding, as one tensor-core k-step."""
    return (acc.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64)).astype(
        np.float32)


def _product(a, b, passes, acc=None):
    """a @ b over k-steps of 8 as the kernel's wgmma: a = (hi, lo) [M, K],
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


def _rows(x, r0, n):
    """Rows [r0, r0 + n) of x [S, ...]: zeros past S, as TMA loads them."""
    out = np.zeros((n,) + x.shape[1:], x.dtype)
    m = max(0, min(n, x.shape[0] - r0))
    out[:m] = x[r0:r0 + m]
    return out


def kernel_dkdv(q, k, v, do, lse, delta, *, window=None, passes=3, finite_test=True):
    """The dK/dV kernel's sums for one kv head: q, do [G, Sq, D] (the
    group's q heads), k, v [Skv, D], lse, delta [G, Sq]; float32. Each block
    of 64 keys walks the q tiles of each head whose rows see some of its
    keys; tile j of the block goes to consumer j % 2."""
    g_heads, sq, d = q.shape
    skv = k.shape[0]
    bq, _ = _tiles(d)
    scale = np.float32(d ** -0.5)
    sl2 = np.float32(scale * LOG2E)
    off = skv - sq
    dk = np.zeros((skv, d), np.float32)
    dv = np.zeros((skv, d), np.float32)
    qs = [_split(_rows(q[h], 0, -(-sq // bq) * bq), passes) for h in range(g_heads)]
    dos = [_split(_rows(do[h], 0, -(-sq // bq) * bq), passes) for h in range(g_heads)]
    for k0 in range(0, skv, BLOCK):
        keys = k0 + np.arange(BLOCK)
        ks, vs = _split(_rows(k, k0, BLOCK), passes), _split(_rows(v, k0, BLOCK), passes)
        i_lo = max(0, k0 - off)
        i_hi = min(sq - 1, min(k0 + BLOCK, skv) - 1 + window - 1 - off) if window else sq - 1
        n_qt = i_hi // bq - i_lo // bq + 1 if i_hi >= i_lo else 0
        acc = [[np.zeros((BLOCK, d), np.float32)] * 2 for _ in range(CONSUMERS)]
        for jt in range(g_heads * n_qt):
            h, qt = divmod(jt, n_qt)
            rows = (i_lo // bq + qt) * bq + np.arange(bq)
            tr = lambda x: (x[0][rows].T, x[1][rows].T)  # noqa: E731
            st = _product(ks, tr(qs[h]), passes)           # Sᵀ [keys, rows]
            dpt = _product(vs, tr(dos[h]), passes)         # dPᵀ
            keep = (_visible(np.minimum(rows, sq - 1), np.minimum(keys, skv - 1), off, window).T
                    & (rows < sq)[None] & (keys < skv)[:, None])
            l_log2 = (_rows(lse[h], 0, rows[-1] + 1)[rows] * LOG2E).astype(np.float32)
            dl = _rows(delta[h], 0, rows[-1] + 1)[rows]
            pt, dst = _probs(st, dpt, l_log2[None], dl[None], keep, sl2)
            rs = lambda x: (x[0][rows], x[1][rows])    # noqa: E731
            c = jt % CONSUMERS
            ak, av = acc[c]
            acc[c] = [_product(_split(dst, passes, finite_test), rs(qs[h]), passes, acc=ak),
                      _product(_split(pt, passes, finite_test), rs(dos[h]), passes, acc=av)]
        n = min(BLOCK, skv - k0)
        dk[k0:k0 + n] = (acc[0][0] + acc[1][0]).astype(np.float32)[:n]
        dv[k0:k0 + n] = (acc[0][1] + acc[1][1]).astype(np.float32)[:n]
    return (dk * scale).astype(np.float32), dv


def kernel_dq(q, k, v, do, lse, delta, *, window=None, passes=3):
    """The dQ kernel's sums for one q head: q, do [Sq, D], k, v [Skv, D] (its
    kv head), lse, delta [Sq]; float32. Each block of 64 rows walks the key
    tiles some of its rows may see; tile j of the block goes to consumer
    j % 2."""
    sq, d = q.shape
    skv = k.shape[0]
    _, bkv = _tiles(d)
    scale = np.float32(d ** -0.5)
    sl2 = np.float32(scale * LOG2E)
    off = skv - sq
    ks = _split(_rows(k, 0, -(-skv // bkv) * bkv), passes)
    vs = _split(_rows(v, 0, -(-skv // bkv) * bkv), passes)
    dq = np.zeros((sq, d), np.float32)
    for q0 in range(0, sq, BLOCK):
        rows = q0 + np.arange(BLOCK)
        qs, dos = _split(_rows(q, q0, BLOCK), passes), _split(_rows(do, q0, BLOCK), passes)
        l_log2 = (_rows(lse, q0, BLOCK) * LOG2E).astype(np.float32)[:, None]
        dl = _rows(delta, q0, BLOCK)[:, None]
        k_hi = min(skv, min(q0 + BLOCK, sq) + off) - 1
        kb0 = (max(0, q0 + off - window + 1) if window else 0) // bkv * bkv
        acc = [np.zeros((BLOCK, d), np.float32) for _ in range(CONSUMERS)]
        for jt, kb in enumerate(range(kb0, k_hi + 1, bkv)):
            keys = kb + np.arange(bkv)
            tr = lambda x: (x[0][keys].T, x[1][keys].T)    # noqa: E731
            s = _product(qs, tr(ks), passes)
            dp = _product(dos, tr(vs), passes)
            keep = (_visible(np.minimum(rows, sq - 1), np.minimum(keys, skv - 1), off, window)
                    & (rows < sq)[:, None] & (keys < skv)[None])
            _, ds = _probs(s, dp, l_log2, dl, keep, sl2)
            c = jt % CONSUMERS
            acc[c] = _product(_split(ds, passes), (ks[0][keys], ks[1][keys]), passes, acc=acc[c])
        n = min(BLOCK, sq - q0)
        dq[q0:q0 + n] = (acc[0] + acc[1]).astype(np.float32)[:n]
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
    """The A fragment a C fragment gives and the B operand a transposed plane
    gives hold the same row at every k index: rows 0, 2, 4, 6 at indices
    0-3, rows 1, 3, 5, 7 at 4-7 (the pre-pass's `pos` in tf32.cuh, whose
    tf32_split_kernel the backward launches)."""
    assert "tf32_split_kernel<D><<<" in SOURCE
    assert "pos = (row & ~7) | ((row & 7) >> 1) | ((row & 1) << 2);" in SPLIT_SOURCE
    np.testing.assert_array_equal(_a_fragment_cols(), [0, 2, 4, 6, 1, 3, 5, 7])
    np.testing.assert_array_equal(_b_fragment_rows(), _a_fragment_cols())


# (b, hq, hkv, sq, skv, d, window): Qwen3-4B's head dim with GQA 2:1 over
# four 32-row dK/dV tiles and eight 32-key dQ tiles; fewer queries than
# keys, 173 keys (the last dQ tile holds 13); D = 128 with a window and MQA;
# D = 240 (16-row dK/dV tiles and 16-key dQ tiles) with GQA 2:1 and a
# window, then fewer queries than keys, 91 keys (the last dQ tile holds 11).
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
