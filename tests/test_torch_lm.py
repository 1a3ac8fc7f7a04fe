"""Parity of the port's transformer serving path with the JAX package.

At the qwen3-4b, gemma3-12b, olmoe-1b-7b, mixtral-8x7b and
llama-3.2-vision-11b smoke configs (f32; gemma's first layer and both of
mixtral's have a 64-token window; olmoe and mixtral route through MoE
experts; the vlm attends to ``memory_stub``'s image embeddings through a
cross block whose gate is set to 0.5, since tanh(0) = 0 at init would
remove the memory), the reference's ``transformer.init_model`` weights are
carried into the port by ``convert.lm_params_from_jax`` and the same
numpy-seeded tokens go through both packages on the CPU, where the port's
prefill attention runs the plain version of the CUDA ``flash_attention``.

Tolerances: 1e-5 per op (layers, attention), 1e-4 on logits and caches after
a whole stack (two packages summing the same f32 products in other orders);
greedy tokens identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import lm_data as jdata
from repro.models import attention as jattn
from repro.models import decoding as jdec
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs as pconfigs
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax
from repro_torch.data import lm_data as pdata
from repro_torch.kernels import flash_attention as pfa
from repro_torch.launch import serve as pserve
from repro_torch.models import attention as pattn
from repro_torch.models import decoding as pdec
from repro_torch.models import layers as players
from repro_torch.models import transformer as ptr
from repro_torch.serve.engine import ServeEngine as PServeEngine
from torch_parity import log_drops

OP_TOL = 1e-5
STACK_TOL = 1e-4
ARCHS = ("qwen3-4b", "gemma3-12b", "olmoe-1b-7b", "mixtral-8x7b", "llama-3.2-vision-11b")


def _t(a):
    return torch.from_numpy(np.array(a))


def _with_gates(params, value=0.5):
    """The reference's params with every cross-block gate set to ``value``."""
    if "cross_blocks" not in params:
        return params
    cross = dict(params["cross_blocks"])
    cross["gate"] = jnp.full_like(cross["gate"], value)
    return dict(params, cross_blocks=cross)


def _memory(cfg, b, seed=0):
    """(numpy for the reference, tensor for the port) image embeddings of a
    vlm config, else (None, None)."""
    mem = jdata.memory_stub(cfg, b, rng=np.random.default_rng(seed))
    return mem, None if mem is None else _t(mem)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg, jax params, port cfg, port model) from the same weights."""
    jcfg = jconfigs.get_config(request.param, "smoke")
    params = _with_gates(jax.jit(jtr.init_model, static_argnums=1)(jax.random.key(0), jcfg))
    pcfg = pconfigs.get_config(request.param, "smoke")
    model = lm_params_from_jax(jax.tree.map(np.asarray, params), pcfg, "cpu")
    return jcfg, params, pcfg, model


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


class TestLayers:
    @pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
    def test_norm(self, kind):
        rng = np.random.default_rng(1)
        x = rng.normal(size=(2, 5, 24)).astype(np.float32)
        p = {"scale": rng.normal(size=24).astype(np.float32),
             "bias": rng.normal(size=24).astype(np.float32)}
        if kind == "rmsnorm":
            del p["bias"]
        norm = players.Norm(kind, 24, dtype=torch.float32)
        norm.load_state_dict({k: _t(v) for k, v in p.items()})
        _close(norm(_t(x)), jlayers.apply_norm(p, jnp.asarray(x), kind), OP_TOL)

    def test_head_norm_and_rope(self):
        rng = np.random.default_rng(2)
        x = rng.normal(size=(2, 3, 7, 32)).astype(np.float32)
        scale = rng.normal(size=32).astype(np.float32)
        pos = rng.integers(0, 3000, size=(2, 7))
        _close(players.rms_head_norm(_t(scale), _t(x)),
               jlayers.rms_head_norm(jnp.asarray(scale), jnp.asarray(x)), OP_TOL)
        # Angles up to 3000 rad: cos/sin of the same f32 angle differ by ulps.
        _close(players.apply_rope(_t(x), _t(pos), 1e6),
               jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6), OP_TOL)

    @pytest.mark.parametrize("act,bias", [("silu", False), ("gelu", True)])
    def test_mlp(self, act, bias):
        rng = np.random.default_rng(3)
        jp = jlayers.init_mlp(jax.random.key(3), 16, 40, act, bias, jnp.float32)
        if bias:
            jp = dict(jp, b_up=jnp.asarray(rng.normal(size=40), jnp.float32),
                      b_down=jnp.asarray(rng.normal(size=16), jnp.float32))
        mlp = players.MLP(16, 40, act, bias, dtype=torch.float32)
        mlp.load_state_dict({k: _t(v) for k, v in jp.items()})
        x = rng.normal(size=(2, 5, 16)).astype(np.float32)
        _close(mlp(_t(x)), jlayers.apply_mlp(jp, jnp.asarray(x), act), OP_TOL)

    @pytest.mark.parametrize("tie,softcap", [(True, 0.0), (False, 30.0)])
    def test_embed_unembed(self, tie, softcap):
        jp = jlayers.init_embed(jax.random.key(4), 50, 24, jnp.float32, tie=tie)
        emb = players.Embed(50, 24, tie=tie, dtype=torch.float32)
        emb.load_state_dict({k: _t(v) for k, v in jp.items()})
        tok = np.random.default_rng(4).integers(0, 50, (2, 6))
        x = players.embed_tokens(emb, _t(tok))
        jx = jlayers.embed_tokens(jp, jnp.asarray(tok))
        _close(x, jx, OP_TOL)
        _close(players.unembed(emb, x, softcap=softcap),
               jlayers.unembed(jp, jx, softcap=softcap), OP_TOL)

    def test_truncated_normal_moments(self):
        gen = torch.Generator().manual_seed(0)
        x = players.truncated_normal(gen, (200_000,), 0.5, torch.float32)
        assert x.abs().max() <= 1.0
        # Std of a unit normal truncated to +-2 is 0.8796; times 0.5.
        assert abs(x.mean().item()) < 5e-3 and abs(x.std().item() - 0.4398) < 5e-3


class TestAttention:
    KW = dict(num_heads=4, num_kv_heads=2, head_dim=32, qk_norm=True, rope_theta=1e6)

    def _params(self):
        jp = jattn.init_attention(jax.random.key(5), 128, 4, 2, 32, qk_norm=True,
                                  use_bias=False, dtype=jnp.float32)
        rng = np.random.default_rng(5)
        jp = dict(jp, q_norm=jnp.asarray(rng.uniform(0.5, 1.5, 32), jnp.float32),
                  k_norm=jnp.asarray(rng.uniform(0.5, 1.5, 32), jnp.float32))
        pp = pattn.Attention(128, 4, 2, 32, qk_norm=True, use_bias=False,
                             dtype=torch.float32)
        pp.load_state_dict({k: _t(v) for k, v in jp.items()})
        return jp, pp

    @pytest.mark.parametrize("s,window", [(40, 0), (70, 16)])
    def test_self_attention_kv(self, s, window):
        jp, pp = self._params()
        x = np.random.default_rng(s).normal(size=(2, s, 128)).astype(np.float32)
        want = jax.jit(lambda p, x: jattn.self_attention_kv(p, x, window=window, **self.KW))(
            jp, jnp.asarray(x))
        got = pattn.self_attention_kv(pp, _t(x), window=window, **self.KW)
        for g, w in zip(got, want):
            _close(g, w, OP_TOL)

    def test_sdpa(self):
        rng = np.random.default_rng(6)
        q = rng.normal(size=(2, 4, 9, 32)).astype(np.float32)
        k = rng.normal(size=(2, 2, 13, 32)).astype(np.float32)
        v = rng.normal(size=(2, 2, 13, 32)).astype(np.float32)
        for kw in (dict(causal=True, window=5, q_offset=4), dict(causal=False, window=0),
                   dict(causal=True, window=0, q_offset=4, kv_valid_len=11)):
            _close(pattn._sdpa(_t(q), _t(k), _t(v), **kw),
                   jattn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw), OP_TOL)

    @pytest.mark.parametrize("window,pos", [(0, 5), (8, 5), (8, 13)])
    def test_decode_self_attention(self, window, pos):
        jp, pp = self._params()
        rng = np.random.default_rng(pos + window)
        size = window or 16
        ck = rng.normal(size=(2, 2, size, 32)).astype(np.float32)
        cv = rng.normal(size=(2, 2, size, 32)).astype(np.float32)
        x = rng.normal(size=(2, 1, 128)).astype(np.float32)
        want, wc = jax.jit(lambda *a: jattn.decode_self_attention(*a, window=window, **self.KW))(
            jp, jnp.asarray(x), {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
            jnp.asarray(pos, jnp.int32))
        got, gc = pattn.decode_self_attention(pp, _t(x), {"k": _t(ck), "v": _t(cv)}, pos,
                                              window=window, **self.KW)
        _close(got, want, OP_TOL)
        _close(gc["k"], wc["k"], OP_TOL)
        _close(gc["v"], wc["v"], OP_TOL)


def test_init_matches_reference_scales(pair):
    """``init_model`` (and ``init_block`` / ``init_attention``) draw every
    parameter at the reference's scale: same names and shapes as the
    reference's pytree, ones and zeros where it has them (the cross blocks'
    gates, which the fixture set to 0.5, are 0 at init), and truncated
    normals whose std is within 5 % of the reference's draw, or for a leaf
    of fewer than 6400 elements (the MoE routers, [128, 4]) within
    4 / sqrt(n), four standard errors of the two samples' ratio."""
    jcfg, params, pcfg, ref_model = pair
    model = ptr.init_model(pcfg, seed=1, device="cpu")
    block = ptr.init_block(torch.Generator().manual_seed(2), pcfg, "attn")
    attn = pattn.init_attention(torch.Generator().manual_seed(3), pcfg.d_model,
                                pcfg.num_heads, pcfg.num_kv_heads, pcfg.head_dim,
                                qk_norm=pcfg.qk_norm, use_bias=pcfg.use_bias,
                                dtype=torch.float32)
    pairs = [(model.state_dict(), ref_model.state_dict()),
             (block.state_dict(), ref_model.blocks[0].state_dict()),
             (attn.state_dict(), ref_model.blocks[1].attn.state_dict())]
    if pcfg.cross_attn_interval:
        cross = ptr.init_cross_block(torch.Generator().manual_seed(4), pcfg)
        pairs.append((cross.state_dict(), ref_model.cross_blocks[0].state_dict()))
    for got, want in pairs:
        assert got.keys() == want.keys()
        for name, w in want.items():
            g = got[name]
            assert g.shape == w.shape and g.dtype == w.dtype, name
            if name.rsplit(".", 1)[-1] == "gate":     # a cross block's
                assert torch.all(g == 0) and float(params["cross_blocks"]["gate"][0]) == 0.5
            elif torch.all(w == w.flatten()[0]):
                assert torch.equal(g, w), name       # ones / zeros
            else:
                tol = max(0.05, 4 / w.numel() ** 0.5)
                assert abs(g.std().item() / w.std().item() - 1) < tol, name


def test_forward_matches(pair):
    """Logits, and the aux loss: the MoE layers' summed, 0 for the others."""
    jcfg, params, _, model = pair
    tok = _tokens(jcfg, 2, 80)
    jmem, pmem = _memory(jcfg, 2)
    want, jaux = jax.jit(lambda p, t, m: jtr.forward(p, jcfg, t, memory=m))(
        params, jnp.asarray(tok), jmem)
    got, aux = ptr.forward(model, _t(tok), memory=pmem)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want, STACK_TOL)
    _close(aux, jaux, OP_TOL)
    assert aux.item() > 0 if jcfg.is_moe else aux.item() == 0.0


@pytest.mark.parametrize("impl,s", [("reference", 40), ("reference", 200),
                                    ("pallas_interpret", 200)])
def test_prefill_matches(pair, impl, s):
    """Logits and every layer's cache (ring-rolled for gemma's window-64
    layer at s = 200). The reference's Pallas path is compared at s = 200
    only: its ``ops.mha`` is wrong below 128 queries (ROADMAP.md queue 3)."""
    jcfg, params, _, model = pair
    jcfg = dataclasses.replace(jcfg, attention_impl=impl)
    tok = _tokens(jcfg, 2, s)
    jmem, pmem = _memory(jcfg, 2)
    jl, jc = jax.jit(lambda p, t, m: jdec.prefill(p, jcfg, t, max_len=s + 12, memory=m))(
        params, jnp.asarray(tok), jmem)
    pl_, pc = pdec.prefill(model, _t(tok), max_len=s + 12, memory=pmem)
    _close(pl_, jl, STACK_TOL)
    assert pc["pos"] == int(jc["pos"]) == s
    for got, want in zip(pc["layers"], jc["layers"]):
        assert got["k"].shape == want["k"].shape
        _close(got["k"], want["k"], STACK_TOL)
        _close(got["v"], want["v"], STACK_TOL)


def test_decode_steps_match(pair):
    """Eight decode steps after a 200-token prompt, feeding both packages
    the same tokens; gemma's and mixtral's ring buffers wrap."""
    jcfg, params, _, model = pair
    tok = _tokens(jcfg, 2, 200)
    jmem, pmem = _memory(jcfg, 2)
    _, jc = jax.jit(lambda p, t, m: jdec.prefill(p, jcfg, t, max_len=216, memory=m))(
        params, jnp.asarray(tok), jmem)
    jstep = jax.jit(lambda p, c, t: jdec.decode_step(p, jcfg, c, t))
    _, pc = pdec.prefill(model, _t(tok), max_len=216, memory=pmem)
    feed = _tokens(jcfg, 2, 8, seed=1)
    for i in range(8):
        jl, jc = jstep(params, jc, jnp.asarray(feed[:, i:i + 1]))
        pl_, pc = pdec.decode_step(model, pc, _t(feed[:, i:i + 1]))
        _close(pl_, jl, STACK_TOL)
    assert pc["pos"] == int(jc["pos"]) == 208
    for got, want in zip(pc["layers"], jc["layers"]):
        _close(got["k"], want["k"], STACK_TOL)


def test_gemma3_head_dim_240_matches_reference():
    """gemma3-12b's smoke config at its full config's head dim, 240 (d_model
    128, 4 q heads of 240; the override of the card's small gemma runs):
    forward logits, a 200-token prefill across the window-64 layer's ring
    buffer against both the reference's plain attention and its Pallas kernel
    (interpret mode), every layer's cache, 8 decode steps and greedy tokens."""
    jcfg = jconfigs.get_config("gemma3-12b", "smoke", head_dim=240)
    params = jax.jit(jtr.init_model, static_argnums=1)(jax.random.key(0), jcfg)
    pcfg = pconfigs.get_config("gemma3-12b", "smoke", head_dim=240)
    model = lm_params_from_jax(jax.tree.map(np.asarray, params), pcfg, "cpu")
    assert pcfg.head_dim == 240 and model.blocks[0].attn.wq.shape == (128, 960)
    tok = _tokens(jcfg, 2, 80)
    want, _ = jax.jit(lambda p, t: jtr.forward(p, jcfg, t))(params, jnp.asarray(tok))
    got, _ = ptr.forward(model, _t(tok))
    _close(got, want, STACK_TOL)
    tok = _tokens(jcfg, 2, 200)
    for impl in ("reference", "pallas_interpret"):
        icfg = dataclasses.replace(jcfg, attention_impl=impl)
        jl, jc = jax.jit(lambda p, t: jdec.prefill(p, icfg, t, max_len=216))(
            params, jnp.asarray(tok))
        pl_, pc = pdec.prefill(model, _t(tok), max_len=216)
        _close(pl_, jl, STACK_TOL)
        for g, w in zip(pc["layers"], jc["layers"]):
            _close(g["k"], w["k"], STACK_TOL)
            _close(g["v"], w["v"], STACK_TOL)
    jstep = jax.jit(lambda p, c, t: jdec.decode_step(p, jcfg, c, t))
    feed = _tokens(jcfg, 2, 8, seed=1)
    for i in range(8):
        jl, jc = jstep(params, jc, jnp.asarray(feed[:, i:i + 1]))
        pl_, pc = pdec.decode_step(model, pc, _t(feed[:, i:i + 1]))
        _close(pl_, jl, STACK_TOL)
    short = _tokens(jcfg, 3, 40)
    np.testing.assert_array_equal(
        PServeEngine(model, max_len=64).generate(short, steps=8),
        JServeEngine(jcfg, params, max_len=64).generate(short, steps=8))


def test_every_full_config_that_attends_has_a_kernel_head_dim():
    """Each full config whose decoder blocks attend (attention, hybrid or
    encoder-decoder blocks, by the config's block kinds) has a head dim the
    flash kernels have an instance of: on the card there is no other route.
    xlstm-125m's blocks (mLSTM, sLSTM) never reach the kernel."""
    attending = []
    for arch in pconfigs.ARCH_IDS:
        cfg = pconfigs.get_config(arch, "full")
        kinds = {ptr._block_kind(cfg, i) for i in range(cfg.num_layers)}
        if kinds & {"attn", "hybrid", "encdec_dec"}:
            attending.append(arch)
            assert cfg.head_dim in pfa.HEAD_DIMS, (arch, cfg.head_dim, pfa.HEAD_DIMS)
    assert "gemma3-12b" in attending and "xlstm-125m" not in attending


def test_generate_greedy_tokens_identical(pair):
    jcfg, params, _, model = pair
    tok = _tokens(jcfg, 3, 40)
    mem, _ = _memory(jcfg, 3)
    want = JServeEngine(jcfg, params, max_len=64).generate(tok, steps=8, memory=mem)
    got = PServeEngine(model, max_len=64).generate(tok, steps=8, memory=mem)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_sampling_uses_the_generator(pair):
    _, _, _, model = pair
    tok = _tokens(model.cfg, 2, 12)
    mem, _ = _memory(model.cfg, 2)
    eng = PServeEngine(model, max_len=32)
    a = eng.generate(tok, steps=6, temperature=1.0, seed=3, memory=mem)
    b = eng.generate(tok, steps=6, temperature=1.0, seed=3, memory=mem)
    np.testing.assert_array_equal(a, b)
    assert ((0 <= a) & (a < model.cfg.vocab_size)).all()


def test_convert_round_trip(pair):
    """``lm_params_to_jax`` gives the reference's tree back leaf for leaf
    (the MoE experts and the vlm's stacked cross blocks included), and
    ``lm_params_from_jax`` of it the same model."""
    jcfg, params, pcfg, model = pair
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), lm_params_to_jax(model)))[0]
    want = {jax.tree_util.keystr(p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert sorted(jax.tree_util.keystr(p) for p, _ in got) == sorted(want)
    for path, leaf in got:
        np.testing.assert_array_equal(leaf, np.asarray(want[jax.tree_util.keystr(path)]))
    back = lm_params_from_jax(lm_params_to_jax(model), pcfg, "cpu").state_dict()
    for name, t in model.state_dict().items():
        assert torch.equal(back[name], t), name


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_moe_blocks_hold_experts(arch):
    """An MoE config's blocks hold ``moe`` (router f32) and no ``mlp``."""
    model = ptr.init_model(pconfigs.get_config(arch, "smoke", dtype="bfloat16"), device="cpu")
    for bp in model.blocks:
        assert not hasattr(bp, "mlp") and bp.moe.router.dtype == torch.float32
        assert bp.moe.w_up.dtype == torch.bfloat16


def test_olmoe_drop_shares_by_layer_match_reference(monkeypatch, capsys):
    """OLMoE-1B-7B at full depth (16 layers, 64 experts top-8, capacity
    factor 1.25, groups of 512) with the width cut to d 512 (4 heads of 128,
    expert d_ff 256), f32, the port's weights from seed 0 carried into the
    reference: a 2 x 512 prompt drops the same share of (token, k) slots in
    each layer in both packages, within 2 of a layer's 8192 slots (a near
    tie may swap one assignment). Printed beside the reference's: the mean
    cosine of two router inputs of a group, layer by layer."""
    over = dict(d_model=512, num_heads=4, num_kv_heads=4, d_ff=256, dtype="float32",
                remat=False)
    pcfg = pconfigs.get_config("olmoe-1b-7b", "full", **over)
    jcfg = jconfigs.get_config("olmoe-1b-7b", "full", scan_layers=False, **over)
    model = ptr.init_model(pcfg, seed=0, device="cpu")
    params = jax.tree.map(jnp.asarray, lm_params_to_jax(model))
    tok = _tokens(pcfg, 2, 512)
    want, cos, apply_moe = [], [], jmoe.apply_moe

    def logged(p, x, *, num_experts, top_k, capacity_factor, act, group_len=512):
        # The reference's gates, top-k and slot positions, recomputed eagerly.
        xt = x.reshape(-1, min(group_len, x.shape[1]), x.shape[2]).astype(jnp.float32)
        g, t, _ = xt.shape
        _, topi = jax.lax.top_k(jax.nn.softmax(xt @ p["router"], axis=-1), top_k)
        onehot = jax.nn.one_hot(topi, num_experts, dtype=jnp.int32).reshape(g, t * top_k, -1)
        pos = jnp.sum((jnp.cumsum(onehot, 1) - onehot) * onehot, -1)
        cap = max(1, int(capacity_factor * t * top_k / num_experts))
        want.append(1.0 - float(jnp.mean(pos < cap)))
        u = xt / jnp.linalg.norm(xt, axis=-1, keepdims=True)
        cos.append(float(jnp.mean(jnp.sum(u.mean(1) ** 2, -1))))
        return apply_moe(p, x, num_experts=num_experts, top_k=top_k,
                         capacity_factor=capacity_factor, act=act, group_len=group_len)

    monkeypatch.setattr(jmoe, "apply_moe", logged)
    jtr.forward(params, jcfg, jnp.asarray(tok))          # eager: one call a layer
    got = log_drops(monkeypatch, pcfg.capacity_factor)
    with torch.no_grad():
        ptr.forward(model, torch.from_numpy(tok).long())
    with capsys.disabled():
        print(f"\nolmoe-1b-7b (d 512) dropped share by layer: port {[round(x, 4) for x in got]}"
              f"; reference {[round(x, 4) for x in want]}; mean cosine of two router inputs "
              f"of a group {[round(x, 4) for x in cos]}")
    assert len(got) == len(want) == pcfg.num_layers and max(want) > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=2 / (2 * 512 * 8))


def test_vlm_logits_depend_on_memory(pair):
    """With nonzero gates the memory reaches the logits; with the gates at 0
    (as at init) it does not, in both packages."""
    jcfg, params, pcfg, model = pair
    if not jcfg.cross_attn_interval:
        assert not hasattr(model, "cross_blocks")
        return
    tok = _tokens(jcfg, 2, 40)
    (m1, p1), (m2, p2) = _memory(jcfg, 2, seed=1), _memory(jcfg, 2, seed=2)
    a, _ = ptr.forward(model, _t(tok), memory=p1)
    b, _ = ptr.forward(model, _t(tok), memory=p2)
    assert (a - b).abs().max() > 1e-3
    closed = lm_params_from_jax(jax.tree.map(np.asarray, _with_gates(params, 0.0)), pcfg,
                               "cpu")
    a, _ = ptr.forward(closed, _t(tok), memory=p1)
    b, _ = ptr.forward(closed, _t(tok), memory=p2)
    assert torch.equal(a, b)
    want, _ = jtr.forward(_with_gates(params, 0.0), jcfg, jnp.asarray(tok), memory=m1)
    _close(a, want, STACK_TOL)
    with pytest.raises(ValueError, match="memory"):
        ptr.forward(model, _t(tok))


@pytest.mark.parametrize("arch", pconfigs.ARCH_IDS)
def test_every_config_builds(arch):
    """Each of the ten configs builds at its smoke size, and its forward gives
    finite logits (with memory_stub's image embeddings or frames)."""
    cfg = pconfigs.get_config(arch, "smoke")
    model = ptr.init_model(cfg, device="cpu")
    mem = pdata.memory_stub(cfg, 2)
    with torch.no_grad():
        logits, _ = ptr.forward(model, _t(_tokens(cfg, 2, 16)).long(),
                                memory=None if mem is None else _t(mem))
    assert logits.shape == (2, 16, cfg.vocab_size) and torch.isfinite(logits).all()


def test_configs_copy_the_reference():
    for arch in jconfigs.ARCH_IDS:
        for variant in ("full", "smoke"):
            j = dataclasses.asdict(jconfigs.get_config(arch, variant))
            j.pop("attention_impl")
            assert dataclasses.asdict(pconfigs.get_config(arch, variant)) == j
    assert pconfigs.INPUT_SHAPES.keys() == jconfigs.INPUT_SHAPES.keys()


@pytest.mark.parametrize("arch", ["qwen3-4b", "whisper-medium", "llama-3.2-vision-11b"])
def test_lm_data_copies_the_reference(arch):
    jcfg, pcfg = jconfigs.get_config(arch, "smoke"), pconfigs.get_config(arch, "smoke")
    jit, pit = (jdata.token_batches(jcfg, batch=3, seq_len=17, seed=5),
                pdata.token_batches(pcfg, batch=3, seq_len=17, seed=5))
    for _ in range(2):
        j, p = next(jit), next(pit)
        assert j.keys() == p.keys()
        for key in j:
            np.testing.assert_array_equal(p[key], j[key])
    j, p = jdata.memory_stub(jcfg, 2), pdata.memory_stub(pcfg, 2)
    assert (j is None) == (p is None) and (j is None or np.array_equal(j, p))


def test_serve_launcher_needs_cuda_or_cpu_flag():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        pserve.main(["--steps", "2"])
    with pytest.raises(FileNotFoundError):      # --checkpoint reads the file it names
        pserve.main(["--device", "cpu", "--checkpoint", "no-such-checkpoint.npz"])
    before = pfa.launches
    out = pserve.main(["--device", "cpu", "--arch", "gemma3-12b", "--batch", "2",
                       "--prompt-len", "70", "--steps", "3"])
    assert out["tokens"].shape == (2, 3) and pfa.launches == before
    assert out["logits"].shape == (2, 512) and torch.isfinite(out["logits"]).all()


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b", "llama-3.2-vision-11b"])
def test_serve_launcher_runs_moe_and_vlm(arch):
    """The launcher on the CPU: the vlm attends to ``memory_stub``'s
    embeddings, as the reference's launcher passes them."""
    out = pserve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                       "--prompt-len", "64", "--steps", "3"])
    assert out["tokens"].shape == (2, 3) and torch.isfinite(out["logits"]).all()
