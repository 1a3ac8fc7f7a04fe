"""The arithmetic of the CUDA f32 ``flash_attention`` route, on the CPU.

The kernel (``src/repro_torch/kernels/csrc/flash_attention.cu``) runs
``S = Q Kᵀ`` and ``O += P V`` on the tensor cores in TF32, which keeps 10
mantissa bits, with the 3-pass split of ``csrc/tf32.cuh``: each operand is
``x = hi + lo`` (both TF32, rounded to nearest with ties away from zero) and
each product ``x_lo y_hi + x_hi y_lo + x_hi y_hi`` in f32. Here the kernel's
sums are emulated tile by tile in numpy, one row's keys in order: TF32
rounding by bit arithmetic (``torch_parity.tf32`` / ``split``), one f32
rounding per TF32 k-step of 8, the two small passes of S in their own
accumulator, each kv tile's P V in a fresh one, and the online softmax with
the scale folded into the exponent; the key tiles are read from the
kernel's ``Tiling<D>``. P's A fragment is taken from the S accumulator by
the kernel's lane rule, and V's B operand from the transposed plane by the
pre-pass's key order, so a mismatch of the two orders shows as a wrong
result. (At D = 240 the kernel's two consumers take a block's tiles in turn
and merge; ``tests/test_torch_flash_fwd_f32_wgmma.py`` walks that schedule.)

The three passes hold 1e-5 (absolute and relative) against the port's plain
version and the JAX package's oracle (kv heads repeated), at Qwen3-4B's head
dim 80 and at 128; one pass (``q_hi k_hi``, ``p_hi v_hi``) misses 1e-5.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from torch_parity import split, tf32

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
          / "flash_attention.cu").read_text()
# Keys a tile, by head dim: the kernel's Tiling<D>.
BKV = {int(d): int(n) for d, n in re.findall(
    r"struct Tiling<(\d+)> \{ static constexpr int BKV = (\d+),", SOURCE)}
TOL = 1e-5
LOG2E = 1.4426950408889634
GPU_NAN = np.array([0x7FFFFFFF], dtype=np.uint32).view(np.float32)[0]   # what ex2 gives


def _a_fragment_keys():
    """Key (column of the S tile) that each mma index k of P's A fragment
    holds: lane (g, t)'s accumulator element e is row g + 8 (e >> 1), key
    2t + (e & 1), and the kernel uses it as A element (e >> 1) | ((e & 1) << 1),
    which is row g + 8 (a & 1), index t + 4 (a >> 1)."""
    keys = np.full(8, -1)
    for t in range(4):
        for e in range(4):
            a = (e >> 1) | ((e & 1) << 1)
            assert (a & 1) == (e >> 1)                # same row
            keys[t + 4 * (a >> 1)] = 2 * t + (e & 1)
    return keys


def _b_fragment_keys():
    """Key (row of the V tile) that each mma index k of V's B operand holds:
    k index i reads position i of its group of 8 in the transposed V plane,
    where the pre-pass (tf32.cuh) writes key r at position
    (r >> 1) | ((r & 1) << 2), so index t holds key 2t and index t + 4 key
    2t + 1."""
    keys = np.full(8, -1)
    for r in range(8):
        keys[(r >> 1) | ((r & 1) << 2)] = r
    return keys


def _mma(acc, a, b):
    """acc + a @ b with one f32 rounding, as one tensor-core k-step."""
    return (acc.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64)).astype(
        np.float32)


def kernel_attention(q, k, v, *, window=None, passes=3):
    """The kernel's sums for q [Sq, D], k, v [Skv, D] (one head), float32."""
    sq, d = q.shape
    skv = k.shape[0]
    bkv = BKV[d]                          # the kernel's tiles
    sl2 = np.float32(np.float32(d ** -0.5) * np.float32(LOG2E))
    (q_hi, q_lo), (k_hi, k_lo), (v_hi, v_lo) = split(q), split(k), split(v)
    a_keys, b_keys = _a_fragment_keys(), _b_fragment_keys()
    qpos = np.arange(sq) + skv - sq
    m_run = np.full(sq, -np.inf, np.float32)
    l_run = np.zeros(sq, np.float32)
    o = np.zeros((sq, d), np.float32)
    for kb in range(0, skv, bkv):
        kt = slice(kb, min(kb + bkv, skv))
        s = np.zeros((sq, kt.stop - kb), np.float32)
        s2 = np.zeros_like(s)
        for c in range(0, d, 8):
            cs = slice(c, c + 8)
            if passes == 3:
                s2 = _mma(s2, q_lo[:, cs], k_hi[kt, cs].T)
                s2 = _mma(s2, q_hi[:, cs], k_lo[kt, cs].T)
            s = _mma(s, q_hi[:, cs], k_hi[kt, cs].T)
        s = s + s2
        kpos = np.arange(kb, kt.stop)
        keep = kpos[None] <= qpos[:, None]
        if window is not None:
            keep &= kpos[None] > qpos[:, None] - window
        s = np.where(keep, s, np.float32(-np.inf))
        with np.errstate(invalid="ignore"):
            mx = np.fmax.reduce(s, axis=1) * sl2
        m_new = np.fmax(m_run, mx)
        m_use = np.where(m_new == -np.inf, np.float32(0), m_new).astype(np.float32)
        alpha = np.exp2(m_run - m_use).astype(np.float32)
        m_run = m_new
        with np.errstate(invalid="ignore"):
            p = np.exp2((s.astype(np.float64) * sl2 - m_use[:, None]).astype(np.float32))
        p = np.where(np.isnan(p), GPU_NAN, p)
        l_run = (l_run * alpha + p.sum(1, dtype=np.float32)).astype(np.float32)
        o = (o * alpha[:, None]).astype(np.float32)
        ot = np.zeros_like(o)
        p_hi = tf32(p)                               # no finiteness test: NaN -> -0
        p_lo = tf32(p - p_hi)
        for c in range(0, kt.stop - kb, 8):
            width = min(8, p.shape[1] - c)           # the last tile may end early
            ka = c + a_keys[a_keys < width]
            kv_rows = kb + c + b_keys[b_keys < width]
            a_hi, a_lo = p_hi[:, ka], p_lo[:, ka]
            b_hi, b_lo = v_hi[kv_rows], v_lo[kv_rows]
            if passes == 3:
                ot = _mma(ot, a_lo, b_hi)
                ot = _mma(ot, a_hi, b_lo)
            ot = _mma(ot, a_hi, b_hi)
        o = o + ot
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(l_run[:, None] == 0, np.float32(0), o / l_run[:, None])


def kernel_mha(q, k, v, **kw):
    """kernel_attention over [B, H, S, D], q head h reading kv head h // G."""
    rep = q.shape[1] // k.shape[1]
    return np.stack([np.stack([kernel_attention(q[b, h], k[b, h // rep], v[b, h // rep], **kw)
                               for h in range(q.shape[1])]) for b in range(q.shape[0])])


def _inputs(b, hq, hkv, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))


def test_fragment_key_orders_agree():
    """P's A fragment and V's B fragment hold the same key at every mma
    index: keys 0, 2, 4, 6 at indices 0-3, keys 1, 3, 5, 7 at 4-7."""
    np.testing.assert_array_equal(_a_fragment_keys(), [0, 2, 4, 6, 1, 3, 5, 7])
    np.testing.assert_array_equal(_b_fragment_keys(), _a_fragment_keys())


# (b, hq, hkv, sq, skv, d, window): Qwen3-4B's head dim with GQA 2:1 over
# four 64-key tiles; fewer queries than keys, 301 keys (the last k-step
# holds 5); D = 128 (32-key tiles) with a window and MQA; D = 240 (16-key
# tiles, P V in fresh accumulators of 48 columns: the same sums; one row's
# tiles in order) with GQA 2:1 and a window, then fewer queries than keys,
# 141 keys.
SHAPES = [(1, 4, 2, 256, 256, 80, None), (1, 2, 1, 77, 301, 80, None),
          (1, 2, 1, 200, 200, 128, 64), (1, 4, 2, 100, 100, 240, 40),
          (1, 2, 1, 60, 141, 240, None)]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,window", SHAPES)
def test_three_passes_hold_f32(b, hq, hkv, sq, skv, d, window):
    q, k, v = _inputs(b, hq, hkv, sq, skv, d, seed=sq + d)
    got = kernel_mha(q, k, v, window=window)
    plain = ref.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), window=window)
    np.testing.assert_allclose(got, plain.numpy(), atol=TOL, rtol=TOL)
    rep = hq // hkv
    oracle = jref.flash_attention(jnp.asarray(q), jnp.asarray(np.repeat(k, rep, 1)),
                                  jnp.asarray(np.repeat(v, rep, 1)), causal=True, window=window)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,window", SHAPES[::2])
def test_one_pass_misses_f32(b, hq, hkv, sq, skv, d, window):
    q, k, v = _inputs(b, hq, hkv, sq, skv, d, seed=sq + d)
    one = kernel_mha(q, k, v, window=window, passes=1)
    plain = ref.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), window=window)
    assert not np.allclose(one, plain.numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("operand", ["q", "k", "v"])
def test_nan_reaches_the_rows_that_see_it(operand):
    """P is split without a finiteness test, which turns a NaN into -0; the
    NaN reaches the output through the row sum l instead. A NaN in q, or in a
    key or value that rows see, leaves those rows NaN and the rows before it
    as they were."""
    q, k, v = _inputs(1, 1, 1, 130, 130, 80, seed=7)
    clean = kernel_attention(q[0, 0], k[0, 0], v[0, 0])
    x = {"q": q, "k": k, "v": v}[operand]
    x[0, 0, 70, 5] = np.nan
    got = kernel_attention(q[0, 0], k[0, 0], v[0, 0])
    bad = np.isnan(got).any(1)
    want = np.arange(130) == 70 if operand == "q" else np.arange(130) >= 70
    if operand == "v":          # rows before it meet the NaN value with weight 0
        assert bad[want].all()
    else:
        np.testing.assert_array_equal(bad, want)
        np.testing.assert_array_equal(got[~want], clean[~want])
