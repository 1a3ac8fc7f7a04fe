"""The arithmetic of the 3-pass TF32 split of ``csrc/tf32.cuh``, on the CPU.

The f32 ``flash_attention`` kernels (``src/repro_torch/kernels/csrc/
flash_attention.cu`` and ``flash_attention_bwd.cu``) run their products on
the tensor cores in TF32, which keeps 10 mantissa bits. They write each
operand as ``x = hi + lo`` with ``hi = tf32(x)`` and ``lo = tf32(x - hi)``,
rounding to nearest with ties away from zero, and sum
``a_lo h_hi + a_hi h_lo + a_hi h_hi`` in f32. Here TF32 rounding is emulated
by bit arithmetic on float32 and the same sum is formed with float32 matrix
products, at a hard input for it: a row-normalised sparse ``a_norm`` (one
isolated row, one dense row of 1/n), whose values TF32 does not hold, and
Gaussian ``h``. The three passes must agree with the plain version's formula
in float64 within 1e-5 absolute and relative, the CUDA tests' tolerance; one
pass (``a_hi h_hi``) must not, which is why the kernels take three. A
non-finite operand goes whole into ``lo`` with ``hi = 0``, so that NaN and
±Inf inputs give NaN and ±Inf where the plain version does.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from torch_parity import split, tf32

TOL = 1e-5


def inputs(seed, m, n, d, density):
    rng = np.random.default_rng(seed)
    a = (rng.random((m, n, n)) < density).astype(np.float32)
    a[:, 0] = 0.0                           # an isolated row: the clamp matters
    a[:, 1] = 1.0                           # a dense row: values 1/n
    a = a / np.maximum(a.sum(-1, keepdims=True), 1.0)
    return a, rng.normal(size=(m, n, d)).astype(np.float32)


def plain_f64(a, h):
    a64, h64 = a.astype(np.float64), h.astype(np.float64)
    return (a64 @ h64) / np.maximum(a64.sum(-1, keepdims=True), 1.0)


def passes(a, h, three):
    """The kernel's sum in f32: three passes, or a_hi h_hi alone."""
    (a_hi, a_lo), (h_hi, h_lo) = split(a), split(h)
    if three:
        agg = a_lo @ h_hi + a_hi @ h_lo
        agg += a_hi @ h_hi
    else:
        agg = a_hi @ h_hi
    deg = a.sum(-1, keepdims=True, dtype=np.float32)
    return agg / np.maximum(deg, np.float32(1.0))


@pytest.mark.parametrize("x,want", [
    (1.0 / 3.0, 0x3EAAA000),                # 1/3 = 0x3EAAAAAB rounds down
    (0x3F801000, 0x3F802000),               # a tie rounds away from zero ...
    (0xBF801000, 0xBF802000),               # ... on either side
    (0x3F800FFF, 0x3F800000),               # just below a tie rounds down
])
def test_tf32_rounding(x, want):
    x = np.array([x], dtype=np.uint32).view(np.float32) if isinstance(x, int) else np.float32(x)
    assert tf32(x).view(np.uint32).item() == want


def test_split_holds_x_to_2_pow_minus_22():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=4096), 1.0 / rng.integers(1, 6124, 4096)])
    x = x.astype(np.float32)
    hi, lo = split(x)
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    assert (np.abs(lo) <= np.abs(x) * 2.0**-11).all()
    err = np.abs(hi.astype(np.float64) + lo - x) / np.abs(x)
    assert err.max() <= 2.0**-22


# (seed, m, n, d, density): FedGL-on-Cora-like (n_pad = 914, ~9 neighbours a
# row), then ragged widths at ~4 neighbours a row.
SHAPES = [(0, 2, 914, 257, 0.01), (1, 1, 1003, 77, 0.004)]


@pytest.mark.parametrize("seed,m,n,d,density", SHAPES)
def test_three_passes_hold_f32(seed, m, n, d, density):
    a, h = inputs(seed, m, n, d, density)
    want = plain_f64(a, h)
    np.testing.assert_allclose(passes(a, h, three=True), want, atol=TOL, rtol=TOL)
    # The plain version, in f32, meets the same tolerance.
    got = ref.sage_aggregate(torch.from_numpy(a), torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("seed,m,n,d,density", SHAPES)
def test_one_pass_misses_f32(seed, m, n, d, density):
    a, h = inputs(seed, m, n, d, density)
    one = passes(a, h, three=False)
    assert not np.allclose(one, plain_f64(a, h), atol=TOL, rtol=TOL)


def test_add_and_mask_alone_loses_a_nan():
    """Why the kernel tests for finiteness: the add carries the mantissa of
    the NaN that GPU arithmetic produces into the sign, leaving -0."""
    nan = np.array([0x7FFFFFFF], dtype=np.uint32).view(np.float32)
    assert tf32(nan).view(np.uint32).item() == 0x80000000
    hi, lo = split(nan)
    assert hi.item() == 0.0 and np.isnan(lo).all()


def _bits(u):
    return np.array([u], dtype=np.uint32).view(np.float32)[0]


# (operand, bits, (batch, row, column)): NaNs (GPU-canonical, torch's default,
# negative with a full mantissa), ±Inf, in h and in the adjacency.
NONFINITE = [("h", 0x7FFFFFFF, (0, 3, 2)), ("h", 0x7FC00000, (1, 7, 4)),
             ("h", 0xFFFFFFFF, (0, 9, 0)), ("h", 0x7F800000, (1, 3, 1)),
             ("h", 0xFF800000, (0, 11, 6)), ("adj", 0x7FFFFFFF, (0, 5, 3)),
             ("adj", 0x7F800000, (1, 6, 8)), ("adj", 0xFF800000, (0, 8, 12))]


@pytest.mark.parametrize("operand,bits,at", NONFINITE)
def test_nonfinite_inputs_follow_the_plain_version(operand, bits, at):
    """Each product formed alone (no BLAS, which may skip zeros), so that
    0 * Inf is NaN on both sides: the split's three passes give NaN and ±Inf
    exactly where the plain formula does."""
    rng = np.random.default_rng(bits % 1000)
    a = (rng.random((2, 24, 24)) < 0.3).astype(np.float32) * np.float32(1.0 / 3.0)
    a[:, 0] = 0.0
    h = rng.normal(size=(2, 24, 7)).astype(np.float32)
    (a if operand == "adj" else h)[at] = _bits(bits)
    with np.errstate(invalid="ignore", over="ignore"):
        want = (a[..., None] * h[:, None]).sum(2) / np.maximum(a.sum(-1, keepdims=True), 1)
        (a_hi, a_lo), (h_hi, h_lo) = split(a), split(h)
        agg = ((a_lo[..., None] * h_hi[:, None]) + (a_hi[..., None] * h_lo[:, None])
               + (a_hi[..., None] * h_hi[:, None])).sum(2)
        got = agg / np.maximum(a.sum(-1, keepdims=True), np.float32(1.0))
    assert not np.isfinite(want).all()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, equal_nan=True)


# Two non-finite operands in one product: a -Inf in the adjacency against a
# +Inf and a -Inf in the same row of h, then against a -Inf alone.
NONFINITE_PAIRS = [(("adj", 0xFF800000, (0, 5, 3)), ("h", 0x7F800000, (0, 3, 1)),
                    ("h", 0xFF800000, (0, 3, 2))),
                   (("adj", 0xFF800000, (1, 8, 12)), ("h", 0xFF800000, (1, 12, 4)))]


@pytest.mark.parametrize("writes", NONFINITE_PAIRS)
def test_nan_outputs_recomputed_plain_follow_the_plain_version(writes):
    """Where both operands of one product are non-finite, the three passes
    pair an Inf with a 0 and give NaN where the plain formula gives ±Inf; the
    kernel's epilogue recomputes every NaN output as a plain f32 dot, which
    gives NaN and ±Inf exactly where the plain formula does."""
    rng = np.random.default_rng(len(writes))
    a = (rng.random((2, 24, 24)) < 0.3).astype(np.float32) * np.float32(1.0 / 3.0)
    a[:, 0] = 0.0
    h = rng.normal(size=(2, 24, 7)).astype(np.float32)
    for operand, bits, at in writes:
        (a if operand == "adj" else h)[at] = _bits(bits)
    deg = np.maximum(a.sum(-1, keepdims=True), np.float32(1.0))
    with np.errstate(invalid="ignore", over="ignore"):
        plain = (a[..., None] * h[:, None]).sum(2)
        (a_hi, a_lo), (h_hi, h_lo) = split(a), split(h)
        agg = ((a_lo[..., None] * h_hi[:, None]) + (a_hi[..., None] * h_lo[:, None])
               + (a_hi[..., None] * h_hi[:, None])).sum(2)
        want, split_only = plain / deg, agg / deg
        got = np.where(np.isnan(agg), plain, agg) / deg
    assert np.isnan(split_only[np.isinf(want)]).any()   # what the recompute repairs
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, equal_nan=True)
