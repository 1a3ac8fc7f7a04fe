"""Parity of the port's mixture-of-experts FFN with the JAX package.

``repro_torch.models.moe.apply_moe`` against ``repro.models.moe.apply_moe``
on the same numpy-seeded inputs and the reference's ``init_moe`` weights,
on the CPU: outputs and the aux loss at 1e-5 (f32 sums in other orders),
with ample capacity and with a tight one that drops (token, k) slots, with
several token groups, on a decode-shaped input, and with a zero router
whose tied gates must resolve to experts 0..k-1 as ``jax.lax.top_k``'s do;
the gradients of ``sum(out * r) + aux`` with respect to x and every weight
at 1e-5 of each leaf's largest; bf16 outputs within 2e-2 of max |out|
(rounded expert products in another order) and the aux at 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as pmoe
from torch_parity import log_drops

OP_TOL = 1e-5
D, FF, E = 32, 48, 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=tol, rtol=tol)


def _pair(act, dtype=jnp.float32, zero_router=False):
    jp = jmoe.init_moe(jax.random.key(7), D, FF, E, act, dtype)
    if zero_router:
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    pp = pmoe.MoE(D, FF, E, act, dtype=tdt)
    pp.load_state_dict({k: _t(np.asarray(v, np.float32)).to(tdt if k != "router" else
                                                           torch.float32)
                        for k, v in jp.items()}, strict=True)
    return jp, pp


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _both(jp, pp, x, **kw):
    want = jax.jit(lambda p, x: jmoe.apply_moe(p, x, **kw))(jp, jnp.asarray(x))
    got = pmoe.apply_moe(pp, _t(x), **kw)
    return got, want


# (act, capacity factor, group_len, x shape): ample capacity (cf = E / k)
# and a tight one that drops, one group a sequence and several.
CASES = [("silu", E / 2, 512, (2, 24, D)), ("silu", 0.5, 512, (2, 24, D)),
         ("gelu", E / 2, 512, (2, 24, D)), ("gelu", 0.5, 512, (2, 24, D)),
         ("silu", 0.5, 8, (2, 24, D)), ("gelu", 1.25, 6, (3, 12, D)),
         ("silu", 1.25, 512, (4, 1, D))]


@pytest.mark.parametrize("act,cf,group_len,shape", CASES)
def test_apply_moe_matches(act, cf, group_len, shape):
    jp, pp = _pair(act)
    kw = dict(num_experts=E, top_k=2, capacity_factor=cf, act=act, group_len=group_len)
    (out, aux), (jout, jaux) = _both(jp, pp, _x(shape), **kw)
    assert out.shape == shape and out.dtype == torch.float32
    _close(out, jout, OP_TOL)
    _close(aux, jaux, OP_TOL)


@pytest.mark.parametrize("cf", [0.5, 8.0])
def test_tight_capacity_drops_the_same_slots(monkeypatch, cf):
    """The share of (token, k) slots dropped, from the port's slot
    positions, equals the one recomputed from the reference's gates and
    positions."""
    jp, pp = _pair("silu")
    x = _x((2, 24, D), seed=3)
    gates = jax.nn.softmax(jnp.asarray(x).reshape(2, 24, D) @ jp["router"], axis=-1)
    _, topi = jax.lax.top_k(gates, 3)
    cap = max(1, int(cf * 24 * 3 / E))
    onehot = jax.nn.one_hot(topi, E, dtype=jnp.int32).reshape(2, 72, E)
    pos = jnp.sum(((jnp.cumsum(onehot, 1) - onehot) * onehot), -1)
    want = 1.0 - float(jnp.mean(pos < cap))
    got = log_drops(monkeypatch, cf)
    pmoe.apply_moe(pp, _t(x), num_experts=E, top_k=3, capacity_factor=cf, act="silu")
    assert len(got) == 1 and abs(got[0] - want) < 1e-7
    assert (want > 0) == (cf < 1)


@pytest.mark.parametrize("cf", [0.5, 4.0])
def test_zero_router_ties_resolve_as_the_reference(cf):
    """All gates equal: top-k takes experts 0..k-1 in both packages, so the
    same tokens fill and overflow the same experts."""
    jp, pp = _pair("silu", zero_router=True)
    x = _x((2, 16, D), seed=4)
    _, _, topi = pmoe.route(pp.router, _t(x), 2)
    assert torch.equal(topi, torch.tensor([0, 1]).expand(2, 16, 2))
    kw = dict(num_experts=E, top_k=2, capacity_factor=cf, act="silu")
    (out, aux), (jout, jaux) = _both(jp, pp, x, **kw)
    _close(out, jout, OP_TOL)
    _close(aux, jaux, OP_TOL)
    if cf < 1:      # capacity 2 of 16 tokens: all but the first two dropped
        assert torch.all(out[:, 2:] == 0) and torch.any(out[:, :2] != 0)


def test_ragged_groups_raise_in_both():
    jp, pp = _pair("gelu")
    x = _x((1, 10, D))
    kw = dict(num_experts=E, top_k=2, capacity_factor=1.0, act="gelu", group_len=4)
    with pytest.raises(ValueError, match="multiple"):
        pmoe.apply_moe(pp, _t(x), **kw)
    with pytest.raises(AssertionError):
        jmoe.apply_moe(jp, jnp.asarray(x), **kw)


@pytest.mark.parametrize("act,cf", [("silu", 0.5), ("gelu", 4.0)])
def test_gradients_match(act, cf):
    """d/d(x, router, w_up, w_gate, w_down) of sum(out * r) + aux."""
    jp, pp = _pair(act)
    x, r = _x((2, 16, D), seed=5), _x((2, 16, D), seed=6)
    kw = dict(num_experts=E, top_k=2, capacity_factor=cf, act=act, group_len=8)

    def jloss(p, x):
        out, aux = jmoe.apply_moe(p, x, **kw)
        return jnp.sum(out * jnp.asarray(r)) + aux
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    for prm in pp.parameters():
        prm.requires_grad_(True)
    out, aux = pmoe.apply_moe(pp, xt, **kw)
    (torch.sum(out * _t(r)) + aux).backward()
    grads = dict(pp.named_parameters())
    assert set(grads) == set(jgp)
    for name, g in jgp.items():
        scale = float(jnp.abs(g).max())
        assert scale > 0, name
        _close(grads[name].grad / scale, np.asarray(g) / scale, OP_TOL)
    _close(xt.grad / float(jnp.abs(jgx).max()), np.asarray(jgx) / float(jnp.abs(jgx).max()),
           OP_TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_bf16_within_tolerance(act):
    """bf16 weights and input: the router in f32 in both, so the routing is
    the same here; the expert products are rounded to bf16 in another order.
    Limit: 2e-2 of max |out|; the aux (f32 from the same gates) at 1e-5."""
    jp, pp = _pair(act, dtype=jnp.bfloat16)
    x = _x((2, 24, D), seed=8)
    kw = dict(num_experts=E, top_k=2, capacity_factor=1.0, act=act)
    jout, jaux = jax.jit(lambda p, x: jmoe.apply_moe(p, x, **kw))(
        jp, jnp.asarray(x, jnp.bfloat16))
    out, aux = pmoe.apply_moe(pp, _t(x).to(torch.bfloat16), **kw)
    assert out.dtype == torch.bfloat16
    want = np.asarray(jout, np.float32)
    err = np.abs(out.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err
    _close(aux, jaux, OP_TOL)


def test_init_scales():
    """Names, shapes and dtypes of ``init_moe``; router f32 whatever the
    dtype; truncated normals within 5 % of the reference's std."""
    jp = jmoe.init_moe(jax.random.key(1), 64, 96, 16, "silu", jnp.bfloat16)
    pp = pmoe.init_moe(torch.Generator().manual_seed(1), 64, 96, 16, "silu", torch.bfloat16)
    got = dict(pp.named_parameters())
    assert set(got) == set(jp)
    for name, w in jp.items():
        g = got[name]
        assert tuple(g.shape) == w.shape, name
        assert g.dtype == (torch.float32 if name == "router" else torch.bfloat16), name
        want_std = float(jnp.std(w.astype(jnp.float32)))
        assert abs(g.float().std().item() / want_std - 1) < 0.05, name
    assert pmoe.MoE(8, 4, 2, "gelu", dtype=torch.float32).w_gate is None
