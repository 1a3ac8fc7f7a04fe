"""Parity of the port's plain ``flash_attention`` with the JAX package's.

The same numpy-seeded q, k, v go through the port on CPU tensors
(``ref.flash_attention`` and ``ops.mha``, which routes a CPU tensor to it;
this is the plain version the CUDA kernel is held against on the card) and
through the reference: its oracle ``ref.flash_attention`` with the kv heads
repeated, and its Pallas kernel (``ops.mha(interpret=True)``) wherever that
is right. The reference's ``ops.mha`` pads q and kv to multiples of its
block sizes and the kernel end-aligns the padded lengths, so it is right
only where the padding keeps ``Skv - Sq``; below 128 queries it is not
(``test_reference_mha_wrong_below_128_queries``, ROADMAP.md queue 3).

Tolerances: f32 2e-5, bf16 2e-2 (as ``tests/test_kernels.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as pfa
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (b, hq, hkv, sq, skv, d, window): the grid of tests/test_kernels.py, then
# short prompts (Sq < 128) and decode-style end alignment (Sq < Skv).
SHAPES = [
    (1, 2, 2, 128, 128, 64, None),
    (2, 4, 2, 256, 256, 64, None),       # GQA 2:1
    (1, 8, 1, 128, 128, 128, None),      # MQA
    (2, 4, 4, 200, 200, 64, 64),         # ragged seq + sliding window
    (1, 2, 2, 384, 384, 32, 128),
    (2, 4, 2, 8, 8, 32, None),
    (1, 4, 2, 40, 40, 80, None),         # the head dim of qwen3-4b as configured
    (2, 4, 2, 127, 127, 32, 16),
    (1, 4, 2, 3, 77, 32, None),          # Sq < Skv: queries at the end
    (1, 2, 1, 128, 256, 64, 100),
    (1, 2, 2, 40, 200, 32, 64),
    # gemma3-12b's head dim, 240: GQA 2:1, with a window on a ragged prompt,
    # and queries at the end of a longer cache (Sq >= 128: the reference's
    # Pallas kernel is compared too).
    (1, 4, 2, 128, 128, 240, None),
    (1, 4, 2, 200, 200, 240, 64),
    (1, 2, 1, 128, 256, 240, 100),
]


def _inputs(b, hq, hkv, sq, skv, d, dtype, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    if dtype == "bfloat16":   # both packages see the same bf16-rounded values
        q, k, v = (torch.from_numpy(a).bfloat16().float().numpy() for a in (q, k, v))
    return q, k, v


def _jax(a, dtype):
    return jnp.asarray(a).astype(jnp.dtype(dtype))


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


def _pallas_is_right(sq, skv):
    """Whether the reference's padding in ``ops.mha`` keeps the end alignment."""
    pad = lambda n, m: -(-n // m) * m  # noqa: E731
    block_q = min(128, max(8, sq))
    return pad(skv, 128) - pad(sq, block_q) == skv - sq


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,window", SHAPES)
def test_matches_reference(b, hq, hkv, sq, skv, d, window, dtype):
    q, k, v = _inputs(b, hq, hkv, sq, skv, d, dtype, seed=sq * 7 + skv + d)
    rep = hq // hkv
    want = jref.flash_attention(_jax(q, dtype), _jax(np.repeat(k, rep, 1), dtype),
                                _jax(np.repeat(v, rep, 1), dtype), causal=True,
                                window=window)
    tq, tk, tv = (_torch(a, dtype) for a in (q, k, v))
    got = pref.flash_attention(tq, tk, tv, causal=True, window=window)
    assert got.shape == (b, hq, sq, d) and got.dtype == tq.dtype
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    before = pfa.launches
    routed = pops.mha(tq, tk, tv, causal=True, window=window)
    assert pfa.launches == before          # a CPU tensor runs the plain version
    np.testing.assert_array_equal(_f32(routed), _f32(got))
    if _pallas_is_right(sq, skv):
        kernel = jops.mha(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype), causal=True,
                          window=window, interpret=True)
        np.testing.assert_allclose(_f32(got), _f32(kernel), atol=tol, rtol=tol)


def test_fully_masked_rows_give_zero():
    """More queries than keys: the first two sit before key 0 and see nothing."""
    q, k, v = (torch.randn(1, 2, s, 32) for s in (6, 4, 4))
    out = pref.flash_attention(q, k, v, causal=True)
    assert torch.all(out[:, :, :2] == 0) and torch.all(torch.isfinite(out))
    np.testing.assert_allclose(out[0, 0, 2].numpy(), v[0, 0, 0].numpy(), atol=1e-6)


def test_mha_refuses_non_causal_and_mixed_devices():
    q = torch.randn(1, 2, 8, 32)
    with pytest.raises(ValueError, match="causal"):
        pops.mha(q, q, q, causal=False)
    with pytest.raises(ValueError, match="device"):
        pops.mha(q, q.to("meta"), q)


@pytest.mark.xfail(strict=True, reason="the reference's ops.mha shifts queries below "
                   "128 tokens onto zero-padded keys (ROADMAP.md queue 3)")
def test_reference_mha_wrong_below_128_queries():
    q, k, v = _inputs(1, 4, 2, 40, 40, 32, "float32", seed=0)
    want = jref.flash_attention(jnp.asarray(q), jnp.asarray(np.repeat(k, 2, 1)),
                                jnp.asarray(np.repeat(v, 2, 1)), causal=True)
    got = jops.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                   interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-5, rtol=2e-5)
