"""``attention._sdpa_chunked`` against the reference's ``_sdpa_chunked``.

The cases of ``tests/test_kernels.py``'s chunked-attention test, a GQA case,
a ragged query count, a windowed layer with and without the key band (the
reference's ``REPRO_DISABLE_WINDOW_BAND`` switch is the port's ``band``
keyword) and non-causal attention; all at 1e-5 in float32, and against the
port's own plain ``_sdpa``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as RA
from repro_torch.models import attention as PA

CASES = [  # (b, hq, hkv, sq, skv, d, window, causal, chunk)
    (1, 2, 2, 256, 256, 32, 0, True, 64),
    (2, 4, 4, 128, 128, 16, 48, True, 64),
    (2, 8, 2, 256, 256, 32, 64, True, 64),       # GQA, windowed with a band
    (2, 4, 2, 128, 256, 16, 0, True, 32),        # fewer queries than keys (end-aligned)
    (1, 4, 1, 96, 96, 16, 0, True, 64),          # ragged: one chunk
    (1, 2, 2, 128, 128, 16, 0, False, 32),
]


def _inputs(b, hq, hkv, sq, skv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32))


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,window,causal,chunk", CASES)
def test_chunked_matches_reference(b, hq, hkv, sq, skv, d, window, causal, chunk):
    q, k, v = _inputs(b, hq, hkv, sq, skv, d)
    want = np.asarray(RA._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       causal=causal, window=window, chunk=chunk))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = PA._sdpa_chunked(tq, tk, tv, causal=causal, window=window, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    plain = PA._sdpa(tq, tk, tv, causal=causal, window=window, q_offset=skv - sq)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5, rtol=1e-5)


def test_band_switch_matches_reference_environment(monkeypatch):
    """``band=False`` is the reference with ``REPRO_DISABLE_WINDOW_BAND=1``:
    the window masks the full rows instead of slicing the band; the same
    numbers either way."""
    q, k, v = _inputs(1, 4, 2, 512, 512, 16, seed=1)
    monkeypatch.setenv("REPRO_DISABLE_WINDOW_BAND", "1")
    want = np.asarray(RA._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       causal=True, window=100, chunk=128))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    no_band = PA._sdpa_chunked(tq, tk, tv, causal=True, window=100, chunk=128, band=False)
    band = PA._sdpa_chunked(tq, tk, tv, causal=True, window=100, chunk=128)
    np.testing.assert_allclose(no_band.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(band.numpy(), want, atol=1e-5, rtol=1e-5)


def test_chunked_keeps_dtype_and_runs_on_meta():
    q = torch.empty((2, 8, 1024, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 2, 1024, 64), dtype=torch.bfloat16, device="meta")
    out = PA._sdpa_chunked(q, k, k, causal=True, window=256, chunk=256)
    assert out.shape == q.shape and out.dtype == torch.bfloat16 and out.device.type == "meta"
