"""The plain backward of the port's ``flash_attention`` against autograd and
against the JAX package.

``ref.flash_attention_bwd`` (the plain version the CUDA backward kernel is
held against on the card) takes the forward's output and row log-sum-exp
(``ref.flash_attention_lse``) and the output's gradient. The same
numpy-seeded q, k, v and dO go through it, through torch autograd of
``ref.flash_attention``, and through ``jax.vjp`` of the reference's plain
``_sdpa`` (the attention the reference trains with), with the kv heads as
each takes them. The reference masks with -1e30, so a fully masked row
(more queries than keys) attends to every key there; it is compared only
where no row is fully masked, and autograd only on rows that see a key.
``ops.mha`` on CPU tensors that need a gradient runs this backward through
``FlashAttention``.

Tolerance: 1e-5 (f32 sums in other orders). The tensor-core kernel's
roundings (P and dS to bf16 before their products) are held on bf16 inputs
to the CUDA tests' limit, 2e-2 of each gradient's max |value|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as pfa
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref

TOL = 1e-5

# (b, hq, hkv, sq, skv, d, window): MHA, GQA, MQA, a window, Sq < Skv (queries
# at the end of the keys), Sq > Skv (fully masked rows), each head dim.
SHAPES = [
    (1, 2, 2, 40, 40, 32, None),
    (2, 4, 2, 33, 33, 64, None),       # GQA 2:1
    (1, 4, 1, 17, 17, 80, None),       # MQA at qwen3-4b's head dim
    (2, 4, 2, 50, 50, 32, 8),          # window
    (1, 4, 2, 7, 29, 128, None),       # Sq < Skv
    (1, 2, 1, 12, 40, 64, 16),         # Sq < Skv with a window
    (1, 4, 2, 20, 12, 32, None),       # Sq > Skv: the first 8 rows see no key
    (1, 4, 2, 40, 40, 240, None),      # gemma3-12b's head dim, GQA 2:1
    (1, 4, 2, 30, 50, 240, 16),        # ... Sq < Skv with a window
    (1, 2, 1, 20, 12, 240, None),      # ... Sq > Skv
]


def _inputs(b, hq, hkv, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d),
                               (b, hq, sq, d)))


def _plain(q, k, v, do, window):
    q, k, v, do = (torch.from_numpy(a) for a in (q, k, v, do))
    o = pref.flash_attention(q, k, v, window=window)
    lse = pref.flash_attention_lse(q, k, window=window)
    return pref.flash_attention_bwd(q, k, v, o, do, lse, window=window)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,window", SHAPES)
def test_matches_autograd(b, hq, hkv, sq, skv, d, window):
    q, k, v, do = _inputs(b, hq, hkv, sq, skv, d, seed=sq + skv + d)
    dq, dk, dv = _plain(q, k, v, do, window)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = pref.flash_attention(tq, tk, tv, window=window)
    out.backward(torch.from_numpy(do))
    seen = slice(max(sq - skv, 0), None)          # rows that see a key
    _close(dq[:, :, seen], tq.grad[:, :, seen])
    _close(dk, tk.grad)
    _close(dv, tv.grad)
    if sq > skv:                                  # fully masked rows: dq is 0
        assert torch.all(dq[:, :, :sq - skv] == 0)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,window", [s for s in SHAPES if s[3] <= s[4]])
def test_matches_reference_vjp(b, hq, hkv, sq, skv, d, window):
    q, k, v, do = _inputs(b, hq, hkv, sq, skv, d, seed=sq * 3 + d)
    dq, dk, dv = _plain(q, k, v, do, window)

    def attend(q, k, v):
        return jattn._sdpa(q, k, v, causal=True, window=window or 0, q_offset=skv - sq)
    _, vjp = jax.vjp(attend, *(jnp.asarray(a) for a in (q, k, v)))
    for got, want in zip((dq, dk, dv), vjp(jnp.asarray(do))):
        _close(got, want)


@pytest.mark.parametrize("window", [None, 6])
def test_lse_matches_logsumexp(window):
    q, k, _, _ = _inputs(2, 4, 2, 21, 30, 32, seed=3)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    lse = pref.flash_attention_lse(tq, tk, window=window)
    logits = torch.einsum("bhqd,bhkd->bhqk", tq, tk.repeat_interleave(2, 1)) / 32 ** 0.5
    qpos = torch.arange(21)[:, None] + 9
    kpos = torch.arange(30)[None]
    mask = (kpos <= qpos) & ((kpos > qpos - window) if window else True)
    want = torch.logsumexp(logits.masked_fill(~mask, -torch.inf), -1)
    _close(lse, want)


def test_fully_masked_rows_get_minus_inf_lse():
    q, k, _, _ = _inputs(1, 2, 2, 6, 4, 32, seed=4)
    lse = pref.flash_attention_lse(torch.from_numpy(q), torch.from_numpy(k))
    assert torch.all(torch.isneginf(lse[:, :, :2])) and torch.all(torch.isfinite(lse[:, :, 2:]))


def test_mha_differentiates_through_the_plain_backward(monkeypatch):
    """On CPU tensors that need a gradient, ``ops.mha`` runs
    ``FlashAttention``, whose backward is ``ref.flash_attention_bwd``; with
    no gradient wanted it runs the plain forward alone."""
    q, k, v, do = _inputs(1, 4, 2, 24, 24, 32, seed=5)
    calls = []
    plain_bwd = pref.flash_attention_bwd
    monkeypatch.setattr(pref, "flash_attention_bwd",
                        lambda *a, **kw: calls.append(1) or plain_bwd(*a, **kw))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    before = (pfa.launches, pfa.launches_bwd)
    out = pops.mha(tq, tk, tv, window=10)
    out.backward(torch.from_numpy(do))
    assert calls == [1] and (pfa.launches, pfa.launches_bwd) == before
    dq, dk, dv = _plain(q, k, v, do, 10)
    for got, want in ((tq.grad, dq), (tk.grad, dk), (tv.grad, dv)):
        assert torch.equal(got, want)
    with torch.no_grad():
        assert pops.mha(tq, tk, tv, window=10).grad_fn is None


def _bwd_bf16_products(q, k, v, o, do, lse, window):
    """``pref.flash_attention_bwd``'s formula with the bf16 tensor-core
    kernel's roundings: P and dS, formed in f32, rounded to bf16 before
    dv = Pᵀ dO, dk = dSᵀ Q and dq = dS K (f32 sums of exact products)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    mask = pref._visible(sq, skv, True, window, q.device)
    group = lambda t: t.float().reshape(b, hkv, g, sq, d)  # noqa: E731
    qf, of, dof = group(q), group(o), group(do)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    s = (qf @ kf.transpose(-1, -2)) / d ** 0.5
    p = torch.where(mask, torch.exp(s - lse.reshape(b, hkv, g, sq, 1)), 0.0)
    ds = torch.where(mask, p * (dof @ vf.transpose(-1, -2)
                                - torch.sum(dof * of, dim=-1, keepdim=True)), 0.0)
    p, ds = p.bfloat16().float(), ds.bfloat16().float()
    dq = (ds @ kf) / d ** 0.5
    dk = torch.sum(ds.transpose(-1, -2) @ qf, dim=2) / d ** 0.5
    dv = torch.sum(p.transpose(-1, -2) @ dof, dim=2)
    return dq.reshape(b, hq, sq, d).bfloat16(), dk.bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("q_scale", [1.0, 8.0], ids=["plain", "peaky"])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,window", [(2, 4, 2, 50, 50, 32, 8),
                                                       (1, 8, 2, 37, 37, 80, 20)])
def test_bf16_product_roundings_fit_the_kernel_limit(b, hq, hkv, sq, skv, d, window, q_scale):
    """bf16 inputs, GQA with a window, q as drawn or scaled by 8 (a peaky
    softmax, where dS = P (dP - D) cancels): the backward with P and dS
    rounded to bf16 before their products stays within 2e-2 of each
    gradient's max |value| of ``pref.flash_attention_bwd``, the limit the
    tensor-core kernel is held to on the card, and the roundings do move it."""
    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _inputs(b, hq, hkv, sq, skv, d, seed=sq + d))
    q = (q.float() * q_scale).bfloat16()
    o = pref.flash_attention(q, k, v, window=window)
    lse = pref.flash_attention_lse(q, k, window=window)
    plain = pref.flash_attention_bwd(q, k, v, o, do, lse, window=window)
    rounded = _bwd_bf16_products(q, k, v, o, do, lse, window)
    moved = 0.0
    for name, got, want in zip(("dq", "dk", "dv"), rounded, plain):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2e-2 * want.float().abs().max().item(), (name, err)
        moved = max(moved, err)
    assert moved > 0
