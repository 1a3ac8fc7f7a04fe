"""Parity of the port's hybrid (hymba) and ssm (xlstm) families with the JAX
package.

Per op, on the reference's own ``init_*`` weights carried into the port's
modules and the same numpy-seeded inputs, on the CPU: ``apply_mamba`` (with
its final state) and ``decode_mamba``; ``apply_mlstm`` (with its ``c, n``)
and ``decode_mlstm``; ``apply_slstm`` (with its ``c, n, h, m``) and
``decode_slstm``; at sequence lengths the reference accepts (at most 128 or
a multiple of 128; 256 crosses a chunk). Per stack, at the hymba-1.5b and
xlstm-125m smoke configs (f32; hymba's second layer has a 64-token window),
the reference's ``transformer.init_model`` weights carried across by
``convert.lm_params_from_jax``: forward logits, prefill logits and every
cache entry (k/v ring-rolled where the prompt passes the window, the mamba
``h``, the mLSTM's ``c, n``, the sLSTM's ``c, n, h, m``), 8 decode steps,
greedy tokens.

Tolerances: 1e-5 per op in f32 (f32 sums in other orders: the scans'
association differs), except the mLSTM's output across a chunk, 1e-4 (see
``test_apply_mlstm``); in bf16, 2e-2 of max |out| (rounded projections in
another order); 1e-4 after a whole stack; greedy tokens identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import decoding as jdec
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro.models import xlstm as jx
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs as pconfigs
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve as pserve
from repro_torch.launch import train as ptrain
from repro_torch.models import decoding as pdec
from repro_torch.models import ssm as pssm
from repro_torch.models import transformer as ptr
from repro_torch.models import xlstm as px
from repro_torch.serve.engine import ServeEngine as PServeEngine
from torch_parity import assert_init_like, assert_round_trip

OP_TOL = 1e-5
STACK_TOL = 1e-4
BF16_TOL = 2e-2
D, H = 32, 4


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=tol, rtol=tol)


def _load(module, jp):
    """``module`` with the reference's leaves, each in the module's own dtype
    (f32 gates stay f32 in a bf16 mixer)."""
    own = module.state_dict()
    module.load_state_dict({k: _t(v).to(own[k].dtype) for k, v in jp.items()}, strict=True)
    return module


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _states_close(got, want, tol):
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key], tol)


# ---------------------------------------------------------------------------
# mamba
# ---------------------------------------------------------------------------

def _mamba(dtype=jnp.float32, state=8):
    jp = jssm.init_mamba(jax.random.key(1), D, expand=2, state=state, dtype=dtype)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return jp, _load(pssm.Mamba(D, expand=2, state=state, dtype=tdt), jp), tdt


@pytest.mark.parametrize("s", [40, 128, 256])
def test_apply_mamba(s):
    """The output and the final state; 256 carries the state across a chunk."""
    jp, pp, _ = _mamba()
    # A larger dt than softplus(-4) so that the decay and the carry matter.
    jp = dict(jp, b_dt=jnp.full((1,), 0.5, jnp.float32))
    pp.b_dt.data.fill_(0.5)
    x = _x((2, s, D), s)
    want, wst = jax.jit(lambda p, x: jssm.apply_mamba(p, x, state=8, return_state=True))(
        jp, jnp.asarray(x))
    got, gst = pssm.apply_mamba(pp, _t(x), state=8, return_state=True)
    _close(got, want, OP_TOL)
    _states_close(gst, wst, OP_TOL)
    _close(pssm.apply_mamba(pp, _t(x), state=8), want, OP_TOL)


def test_apply_mamba_bf16_keeps_the_cast_order():
    """bf16 projections, an f32 a_log and f32 scan: within 2e-2 of max |out|."""
    jp, pp, tdt = _mamba(jnp.bfloat16)
    assert pp.a_log.dtype == torch.float32 and pp.in_proj.dtype == tdt
    x = _x((2, 256, D), 3)
    want = jax.jit(lambda p, x: jssm.apply_mamba(p, x, state=8))(
        jp, jnp.asarray(x, jnp.bfloat16))
    got = pssm.apply_mamba(pp, _t(x).to(tdt), state=8)
    assert got.dtype == tdt
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL * np.abs(want).max())


def test_apply_mamba_refuses_a_ragged_chunk():
    _, pp, _ = _mamba()
    with pytest.raises(ValueError, match="multiple"):
        pssm.apply_mamba(pp, _t(_x((1, 200, D))), state=8)


def test_decode_mamba():
    jp, pp, _ = _mamba()
    x = _x((2, 1, D), 5)
    h = np.abs(_x((2, 2 * D, 8), 6))
    want, wst = jax.jit(lambda p, x, h: jssm.decode_mamba(p, x, {"h": h}, state=8))(
        jp, jnp.asarray(x), jnp.asarray(h))
    got, gst = pssm.decode_mamba(pp, _t(x), {"h": _t(h)}, state=8)
    _close(got, want, OP_TOL)
    _states_close(gst, wst, OP_TOL)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm(dtype=jnp.float32):
    jp = jx.init_mlstm(jax.random.key(2), D, H, expand=2, dtype=dtype)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return jp, _load(px.MLSTM(D, H, expand=2, dtype=tdt), jp), tdt


@pytest.mark.parametrize("s", [40, 128, 256])
def test_apply_mlstm(s):
    """The output and the carried ``c, n``. Across a chunk (256) the output
    is held at 1e-4, the states at 1e-5: the output divides by
    max(|n_inter + n_intra|, 1), sums of terms up to e^8 that cancel, and
    there two f32 orders of the same sums part by up to 1.2e-4 at |y| ~ 6.5
    (each is 4-8e-5 from the same formula run in float64)."""
    jp, pp, _ = _mlstm()
    x = _x((2, s, D), s)
    want, wst = jax.jit(lambda p, x: jx.apply_mlstm(p, x, H, return_state=True))(
        jp, jnp.asarray(x))
    got, gst = px.apply_mlstm(pp, _t(x), H, return_state=True)
    _close(got, want, OP_TOL if s <= 128 else STACK_TOL)
    _states_close(gst, wst, OP_TOL)


def test_apply_mlstm_bf16():
    """bf16 q, k, v and output gate, f32 gates and state."""
    jp, pp, tdt = _mlstm(jnp.bfloat16)
    assert pp.w_fgate.dtype == torch.float32 and pp.wq.dtype == tdt
    x = _x((2, 256, D), 4)
    want = np.asarray(jax.jit(lambda p, x: jx.apply_mlstm(p, x, H))(
        jp, jnp.asarray(x, jnp.bfloat16)), np.float32)
    got = px.apply_mlstm(pp, _t(x).to(tdt), H)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL * np.abs(want).max())


def test_decode_mlstm():
    jp, pp, _ = _mlstm()
    dh = 2 * D // H
    x = _x((2, 1, D), 7)
    c, n = _x((2, H, dh, dh), 8), _x((2, H, dh), 9)
    want, wst = jax.jit(lambda p, x, c, n: jx.decode_mlstm(p, x, {"c": c, "n": n}, H))(
        jp, jnp.asarray(x), jnp.asarray(c), jnp.asarray(n))
    got, gst = px.decode_mlstm(pp, _t(x), {"c": _t(c), "n": _t(n)}, H)
    _close(got, want, OP_TOL)
    _states_close(gst, wst, OP_TOL)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _slstm():
    jp = jx.init_slstm(jax.random.key(3), D, H, dtype=jnp.float32)
    return jp, _load(px.SLSTM(D, dtype=torch.float32), jp)


@pytest.mark.parametrize("s", [1, 24])
def test_apply_slstm(s):
    jp, pp = _slstm()
    x = _x((2, s, D), s)
    want, wst = jax.jit(lambda p, x: jx.apply_slstm(p, x, H, return_state=True))(
        jp, jnp.asarray(x))
    got, gst = px.apply_slstm(pp, _t(x), H, return_state=True)
    _close(got, want, OP_TOL)
    _states_close(gst, wst, OP_TOL)


def test_decode_slstm():
    jp, pp = _slstm()
    x = _x((2, 1, D), 10)
    st = {"c": _x((2, D), 11), "n": np.abs(_x((2, D), 12)) + 1, "h": _x((2, D), 13),
          "m": _x((2, D), 14)}
    want, wst = jax.jit(lambda p, x, st: jx.decode_slstm(p, x, st))(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()})
    got, gst = px.decode_slstm(pp, _t(x), {k: _t(v) for k, v in st.items()})
    _close(got, want, OP_TOL)
    _states_close(gst, wst, OP_TOL)


def test_mixers_init_at_the_reference_scales():
    """``init_mamba``, ``init_mlstm`` and ``init_slstm`` draw each leaf at the
    scale of the reference's draw, with its constants, in its dtypes (f32
    gates and ``a_log`` in a bf16 mixer)."""
    gen = torch.Generator().manual_seed(5)
    for dtype in (jnp.float32, jnp.bfloat16):
        tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
        for got, (_, want, _) in (
                (pssm.init_mamba(gen, D, expand=2, state=8, dtype=tdt), _mamba(dtype)),
                (px.init_mlstm(gen, D, H, expand=2, dtype=tdt), _mlstm(dtype))):
            assert_init_like(got.state_dict(), want.state_dict())
    jp, want = _slstm()
    assert_init_like(px.init_slstm(gen, D, H, dtype=torch.float32).state_dict(),
                     want.state_dict())


def test_states_start_as_the_reference():
    """Zero states, the sLSTM's m at -1e9, the mamba state's shape."""
    _states_close(px.init_slstm_state(2, D), jx.init_slstm_state(2, D), 0)
    _states_close(px.init_mlstm_state(2, D, H), jx.init_mlstm_state(2, D, H), 0)
    _states_close(pssm.init_mamba_state(2, D, expand=2, state=8),
                  jssm.init_mamba_state(2, D, expand=2, state=8), 0)


# ---------------------------------------------------------------------------
# Whole stacks
# ---------------------------------------------------------------------------

ARCHS = ("hymba-1.5b", "xlstm-125m")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg, jax params, port model) from the same weights."""
    jcfg = jconfigs.get_config(request.param, "smoke")
    params = jax.jit(jtr.init_model, static_argnums=1)(jax.random.key(0), jcfg)
    model = lm_params_from_jax(jax.tree.map(np.asarray, params),
                               pconfigs.get_config(request.param, "smoke"), "cpu")
    return jcfg, params, model


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("s", [80, 256])
def test_forward_matches(pair, s):
    jcfg, params, model = pair
    tok = _tokens(jcfg, 2, s)
    want, _ = jax.jit(lambda p, t: jtr.forward(p, jcfg, t))(params, jnp.asarray(tok))
    got, aux = ptr.forward(model, torch.from_numpy(tok).long())
    assert got.shape == want.shape and aux.item() == 0.0
    _close(got, want, STACK_TOL)


@pytest.mark.parametrize("impl,s", [("reference", 128), ("reference", 256),
                                    ("pallas_interpret", 256)])
def test_prefill_and_decode_match(pair, impl, s):
    """Prefill logits and every cache entry, then 8 decode steps fed the same
    tokens; hymba's 64-slot ring buffer wraps in both. The reference's
    Pallas path is compared at 256 only (its ``ops.mha`` is wrong below 128
    queries, ROADMAP.md queue 3)."""
    jcfg, params, model = pair
    jcfg = dataclasses.replace(jcfg, attention_impl=impl)
    tok = _tokens(jcfg, 2, s)
    jl, jc = jax.jit(lambda p, t: jdec.prefill(p, jcfg, t, max_len=s + 12))(
        params, jnp.asarray(tok))
    with torch.no_grad():
        pl_, pc = pdec.prefill(model, torch.from_numpy(tok).long(), max_len=s + 12)
    _close(pl_, jl, STACK_TOL)
    assert pc["pos"] == int(jc["pos"]) == s
    for got, want in zip(pc["layers"], jc["layers"]):
        _states_close(got, want, STACK_TOL)
    jstep = jax.jit(lambda p, c, t: jdec.decode_step(p, jcfg, c, t))
    feed = _tokens(jcfg, 2, 8, seed=1)
    for i in range(8):
        jl, jc = jstep(params, jc, jnp.asarray(feed[:, i:i + 1]))
        with torch.no_grad():
            pl_, pc = pdec.decode_step(model, pc, torch.from_numpy(feed[:, i:i + 1]).long())
        _close(pl_, jl, STACK_TOL)
    for got, want in zip(pc["layers"], jc["layers"]):
        _states_close(got, want, STACK_TOL)


def test_generate_greedy_tokens_identical(pair):
    jcfg, params, model = pair
    tok = _tokens(jcfg, 3, 128)
    want = JServeEngine(jcfg, params, max_len=144).generate(tok, steps=12)
    got = PServeEngine(model, max_len=144).generate(tok, steps=12)
    np.testing.assert_array_equal(got, want)


def test_init_matches_reference_scales(pair):
    """``init_model`` draws the mamba, mLSTM and sLSTM leaves at the
    reference's scales, with its constants: ``a_log`` (f32 in every model),
    ``b_dt`` = -4, ``d_skip`` = 1, ``b_fgate`` = 3, ``b_igate`` = 0 and the
    sLSTM's ``b_in``."""
    _, _, ref_model = pair
    model = ptr.init_model(ref_model.cfg, seed=1, device="cpu")
    assert_init_like(model.state_dict(), ref_model.state_dict())


def test_convert_round_trip(pair):
    """The ssm family's unstacked per-layer list and hymba's stacked groups,
    leaf for leaf."""
    _, params, model = pair
    assert_round_trip(model, params)


def test_hybrid_remat_changes_nothing_but_memory():
    """Hymba's smoke config with remat (each group recomputed, its mamba
    scans checkpointed inside) gives the gradients of the run without it."""
    grads = {}
    for remat in (False, True):
        cfg = pconfigs.get_config("hymba-1.5b", "smoke", remat=remat)
        model = ptr.init_model(cfg, seed=3, device="cpu")
        tok = torch.from_numpy(_tokens(cfg, 2, 128)).long()
        for p in model.parameters():
            p.requires_grad_(True)
        logits, _ = ptr.forward(model, tok)
        loss = torch.log_softmax(logits, -1).mean()
        grads[remat] = torch.autograd.grad(loss, list(model.parameters()))
    for a, b in zip(grads[False], grads[True]):
        _close(b, a, 1e-6)


def test_launchers_run_the_families_on_the_cpu():
    """``launch.train``'s default (``--arch xlstm-125m --variant smoke``)
    trains with ``--device cpu``; ``launch.serve`` serves hymba and xlstm
    from a prompt that crosses a chunk."""
    out = ptrain.main(["--device", "cpu", "--steps", "2", "--log-every", "1"])
    assert out["state"].params.cfg.name == "xlstm-125m-smoke"
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    for arch in ARCHS:
        out = pserve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                           "--prompt-len", "256", "--steps", "3"])
        assert out["tokens"].shape == (2, 3) and torch.isfinite(out["logits"]).all()
