"""Parity of the port's LM training path with the JAX package.

At the qwen3-4b and gemma3-12b smoke configs (f32; gemma's first layer has
a 64-token window), at the olmoe-1b-7b, mixtral-8x7b (MoE, with the aux
loss in the total) and llama-3.2-vision-11b ones (its cross-block gates set
to 0.5, and ``token_batches``' image memory), and at the whisper-medium
(its frames), hymba-1.5b and xlstm-125m ones, the reference's
``transformer.init_model`` weights are
carried into the port by ``convert.lm_params_from_jax`` and the same
``token_batches`` tokens go through both packages on the CPU, where the
port's attention runs the plain versions of the CUDA forward and backward
kernels (``ops.mha`` -> ``FlashAttention``).

Tolerances: optimizer helpers 1e-6; the loss and one step's gradients 1e-5
(f32 sums in other orders); three optimizer steps, their losses and final
parameters, 1e-4, and each step's change of each parameter within 1e-2 of
the largest change of its leaf in the reference's step (see
``_assert_updates_close``); a checkpoint's logits through the reference
1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import io as jio
from repro.data.lm_data import token_batches
from repro.models import transformer as jtr
from repro.optim import adam as jadam
from repro.train import step as jstep
from repro_torch import configs as pconfigs
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax
from repro_torch.kernels import flash_attention as pfa
from repro_torch.launch import train as ptrain
from repro_torch.models import transformer as ptr
from repro_torch.optim import adam as padam
from repro_torch.train import step as pstep
from torch_parity import log_drops

ARCHS = ("qwen3-4b", "gemma3-12b")
NEW_ARCHS = ("olmoe-1b-7b", "mixtral-8x7b", "llama-3.2-vision-11b")
# The audio, hybrid and ssm families (whisper's batches carry its frames).
FAMILY_ARCHS = ("whisper-medium", "hymba-1.5b", "xlstm-125m")


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


def _pair(arch, **overrides):
    """(jax cfg, jax params, port cfg, port model) from the same weights."""
    jcfg = jconfigs.get_config(arch, "smoke", **overrides)
    params = jax.jit(jtr.init_model, static_argnums=1)(jax.random.key(0), jcfg)
    if "cross_blocks" in params:    # tanh(0) = 0 at init would remove the memory
        params = dict(params, cross_blocks=dict(
            params["cross_blocks"], gate=jnp.full_like(params["cross_blocks"]["gate"], 0.5)))
    pcfg = pconfigs.get_config(arch, "smoke", **overrides)
    return jcfg, params, pcfg, lm_params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                                                  "cpu")


def _jbatch(batch):
    """A ``token_batches`` batch for the reference: tokens, and memory if any."""
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _batches(cfg, n, batch=4, seq=80):
    it = token_batches(cfg, batch=batch, seq_len=seq, seed=1)
    return [next(it) for _ in range(n)]


def _assert_params_close(model, params, tol):
    """The port's parameters, in the reference's layout, against its tree."""
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), lm_params_to_jax(model)))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert len(got) == len(want)
    for path, leaf in got:
        _close(leaf, want[path], tol)


def _flat(tree):
    """{leaf path: float64 array} of a reference-layout tree."""
    return {jax.tree_util.keystr(path): np.asarray(leaf, np.float64)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_flat(model):
    return _flat(jax.tree.map(lambda t: t.numpy(), lm_params_to_jax(model)))


def _assert_updates_close(step, before, after, ref_before, ref_after, kept):
    """One optimizer step's change of every parameter against the
    reference's: within 1e-2 of the largest change of its leaf (about the
    step's learning rate for Adam), on the elements ``kept`` (see
    ``_kept``)."""
    for name, want in ref_after.items():
        delta, ref_delta = after[name] - before[name], want - ref_before[name]
        scale = np.abs(ref_delta).max()
        err = np.abs(delta - ref_delta)[kept[name]]
        assert err.size == 0 or err.max() <= 1e-2 * scale, (step, name, err.max(), scale)


def _kept(grads, kept=None, adam=True):
    """The elements whose reference gradient was at least 1e-5 of its
    leaf's largest, or exactly 0, at every step so far (over 99 % of them
    here). Adam's first steps move a parameter by about the learning rate
    whatever its gradient's size, so where a gradient is within f32 rounding
    of 0 its sign, and the move, may differ between the packages; an exact 0
    (an embedding row no token uses, an expert no token reached) is 0 in
    both. SGD moves a parameter by lr times its gradient, so without
    ``adam`` every element is kept. An attention key bias (whisper's
    ``bk``) is left out under either: its gradient is 0 in exact arithmetic
    (q . bk shifts all of a query's logits alike, which the softmax
    ignores), so both packages' values are rounding noise, and so are the
    steps it drives (its final value is still held, at 1e-4)."""
    new = {name: ((np.abs(g) >= 1e-5 * np.abs(g).max()) | (g == 0) | (not adam))
           & (not name.endswith("['bk']")) for name, g in grads.items()}
    return new if kept is None else {name: kept[name] & new[name] for name in new}


def _reference_grads(jcfg, params, batch, microbatch):
    """The reference's gradients as its step takes them: the mean over
    ``microbatch`` chunks of the batch (the MoE aux loss is not linear in the
    batch, so the whole batch's gradient differs)."""
    grad = jax.grad(lambda p, b: jstep.lm_loss(p, jcfg, b)[0])
    chunks = [jax.tree.map(lambda x: x.reshape(microbatch, -1, *x.shape[1:])[i], batch)
              for i in range(microbatch)]
    return jax.tree.map(lambda *g: sum(g) / microbatch, *(grad(params, c) for c in chunks))


class TestOptimHelpers:
    def _tree(self):
        rng = np.random.default_rng(0)
        return {"a": rng.normal(size=(3, 4)).astype(np.float32) * 3,
                "b": [rng.normal(size=7).astype(np.float32)]}

    def test_global_norm_and_clip(self):
        tree = self._tree()
        ttree = {"a": torch.from_numpy(tree["a"]), "b": [torch.from_numpy(tree["b"][0])]}
        jtree = jax.tree.map(jnp.asarray, tree)
        _close(padam.global_norm(ttree), jadam.global_norm(jtree), 1e-6)
        for max_norm in (1.0, 100.0):
            got = padam.clip_by_global_norm(ttree, max_norm)
            want = jadam.clip_by_global_norm(jtree, max_norm)
            _close(got["a"], want["a"], 1e-6)
            _close(got["b"][0], want["b"][0], 1e-6)

    @pytest.mark.parametrize("warmup,total", [(1, 3), (5, 50), (10, 10)])
    def test_cosine_schedule(self, warmup, total):
        steps = np.arange(0, total + 3, dtype=np.int32)
        got = padam.cosine_schedule(warmup, total)(torch.from_numpy(steps))
        want = jax.vmap(jadam.cosine_schedule(warmup, total))(jnp.asarray(steps))
        _close(got, want, 1e-6)

    @pytest.mark.parametrize("kind", ["adam_wd_clip_cosine", "sgd", "sgd_momentum_clip"])
    def test_optimizer_steps(self, kind):
        tree = self._tree()
        opts = {"adam_wd_clip_cosine": lambda m: m.Adam(
                    lr=0.05, weight_decay=0.1, clip_norm=0.5,
                    schedule=m.cosine_schedule(1, 4)),
                "sgd": lambda m: m.SGD(lr=0.1),
                "sgd_momentum_clip": lambda m: m.SGD(lr=0.1, momentum=0.9, clip_norm=0.5)}
        jopt, popt = opts[kind](jadam), opts[kind](padam)
        jp = jax.tree.map(jnp.asarray, tree)
        pp = {"a": torch.from_numpy(tree["a"].copy()), "b": [torch.from_numpy(tree["b"][0].copy())]}
        js, ps = jopt.init(jp), popt.init(pp)
        rng = np.random.default_rng(1)
        for _ in range(4):
            g = {"a": rng.normal(size=(3, 4)).astype(np.float32),
                 "b": [rng.normal(size=7).astype(np.float32)]}
            jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
            ps = popt.update_({"a": torch.from_numpy(g["a"]), "b": [torch.from_numpy(g["b"][0])]},
                              ps, pp)
        _close(pp["a"], jp["a"], 1e-6)
        _close(pp["b"][0], jp["b"][0], 1e-6)

    def test_update_is_update_in_place_on_copies(self):
        tree = self._tree()
        opt = padam.Adam(lr=0.01, clip_norm=1.0, weight_decay=0.01)
        params = {"a": torch.from_numpy(tree["a"])}
        grads = {"a": torch.ones(3, 4)}
        state = opt.init(params)
        new, new_state = opt.update(grads, state, params)
        assert torch.equal(params["a"], torch.from_numpy(tree["a"]))   # untouched
        assert torch.all(state.mu["a"] == 0) and int(state.step) == 0
        opt.update_(grads, state, params)
        assert torch.equal(new["a"], params["a"]) and torch.equal(new_state.mu["a"], state.mu["a"])


@pytest.mark.parametrize("arch", ARCHS + NEW_ARCHS + FAMILY_ARCHS)
def test_loss_and_grads_match(arch):
    _loss_and_grads_match(arch)


def _loss_and_grads_match(arch, **overrides):
    jcfg, params, pcfg, model = _pair(arch, **overrides)
    batch = _batches(jcfg, 1)[0]
    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jstep.lm_loss(p, jcfg, b), has_aux=True))(params, _jbatch(batch))
    state = pstep.init_state(pcfg, padam.Adam(), model=model)
    total, metrics, grads = pstep.loss_and_grads(state.params, pcfg, batch)
    _close(total, jtotal, 1e-5)
    _close(metrics["loss"], jmetrics["loss"], 1e-5)
    _close(metrics["aux"], jmetrics["aux"], 1e-5)
    assert (float(metrics["aux"]) > 0) == pcfg.is_moe
    model.load_state_dict(grads, strict=True)       # the gradients as a model's weights
    _assert_params_close(model, jgrads, 1e-5)


# (optimizer, remat, microbatch): the launcher's optimizer (clipping, cosine
# schedule) with and without the per-layer recompute, weight decay with
# gradient accumulation, SGD with momentum.
RUNS = [("adam_clip_cosine", False, 1), ("adam_clip_cosine", True, 1),
        ("adamw", False, 2), ("sgd_momentum", True, 2)]


def _optimizer(m, kind, arch=""):
    """At the launcher's lr 3e-4: Adam's first steps move each parameter by
    about lr whatever its gradient's size, so a gradient within f32 rounding
    of 0 moves it by up to 2 lr between the packages (``_kept``). SGD with
    momentum at lr 0.3, or 0.1 for xlstm: at 0.3 its loss rises step by
    step in both packages (6.08, 6.36, 6.88) and the step-0 gradients'
    5e-6 difference grows ~30x a step, as between any two f32 orders of
    the same sums; at 0.1 it falls back (6.08, 6.16, 6.13)."""
    if kind == "adam_clip_cosine":
        return m.Adam(lr=3e-4, clip_norm=1.0, schedule=m.cosine_schedule(1, 3))
    if kind == "adamw":
        return m.Adam(lr=3e-4, weight_decay=0.1)
    return m.SGD(lr=0.1 if arch == "xlstm-125m" else 0.3, momentum=0.9)


@pytest.mark.parametrize("kind,remat,microbatch", RUNS)
@pytest.mark.parametrize("arch", ARCHS + NEW_ARCHS + FAMILY_ARCHS)
def test_three_steps_match(arch, kind, remat, microbatch):
    _three_steps_match(arch, kind, remat, microbatch)


# gemma3-12b's smoke config at its full config's head dim, 240 (d_model 128,
# 4 q heads of 240): the card's small gemma runs take this override, which
# runs the flash kernels' D = 240 instances on a model's path.
GEMMA_D240 = {"head_dim": 240}


def test_gemma3_head_dim_240_loss_and_grads_match():
    _loss_and_grads_match("gemma3-12b", **GEMMA_D240)


@pytest.mark.parametrize("kind,remat,microbatch", RUNS[1::2])
def test_gemma3_head_dim_240_three_steps_match(kind, remat, microbatch):
    _three_steps_match("gemma3-12b", kind, remat, microbatch, **GEMMA_D240)


def _three_steps_match(arch, kind, remat, microbatch, **overrides):
    jcfg, params, pcfg, model = _pair(arch, remat=remat, **overrides)
    jopt, popt = _optimizer(jadam, kind, arch), _optimizer(padam, kind, arch)
    jfn = jax.jit(jstep.make_train_step(jcfg, jopt, microbatch=microbatch))
    jstate = jstep.TrainState(params=params, opt_state=jopt.init(params),
                              step=jnp.zeros((), jnp.int32))
    jgrad = jax.jit(lambda p, b: _reference_grads(jcfg, p, b, microbatch))
    pfn = pstep.make_train_step(pcfg, popt, microbatch=microbatch)
    pstate = pstep.init_state(pcfg, popt, model=model)
    kept, ours, theirs = None, _port_flat(pstate.params), _flat(jstate.params)
    for i, batch in enumerate(_batches(jcfg, 3)):
        jbatch = _jbatch(batch)
        kept = _kept(_flat(jgrad(jstate.params, jbatch)), kept, adam=kind != "sgd_momentum")
        jstate, jm = jfn(jstate, jbatch)
        pstate, pm = pfn(pstate, batch)
        _close(pm["loss"], jm["loss"], 1e-4)
        _close(pm["total"], jm["total"], 1e-4)
        _close(pm["aux"], jm["aux"], 1e-4)
        new_ours, new_theirs = _port_flat(pstate.params), _flat(jstate.params)
        _assert_updates_close(i, ours, new_ours, theirs, new_theirs, kept)
        ours, theirs = new_ours, new_theirs
    share = sum(k.sum() for k in kept.values()) / sum(k.size for k in kept.values())
    # The elements left out stay few. xlstm's tied 512 x 128 table is 16 % of
    # its parameters, and the rows of tokens no batch holds get only the
    # softmax's gradient, below 1e-5 of the leaf's largest: 5 % of the
    # table, so 98.99 % of its elements are kept.
    assert share >= (0.98 if arch == "xlstm-125m" else 0.99), share
    assert int(pstate.step) == int(jstate.step) == 3
    _assert_params_close(pstate.params, jstate.params, 1e-4)


def test_remat_changes_nothing_but_memory():
    """With and without the per-layer recompute the gradients are equal to
    f32 rounding, and the recompute runs each layer's attention forward
    twice."""
    grads = {}
    for remat in (False, True):
        cfg = pconfigs.get_config("gemma3-12b", "smoke", remat=remat)
        model = ptr.init_model(cfg, seed=3, device="cpu")
        state = pstep.init_state(cfg, padam.Adam(), model=model)
        calls = []
        fwd = pfa.FlashAttention.forward
        pfa.FlashAttention.forward = staticmethod(lambda *a: calls.append(1) or fwd(*a))
        try:
            _, _, grads[remat] = pstep.loss_and_grads(state.params, cfg,
                                                      _batches(cfg, 1, batch=2)[0])
        finally:
            pfa.FlashAttention.forward = staticmethod(fwd)
        assert len(calls) == cfg.num_layers * (2 if remat else 1)
    for name, g in grads[False].items():
        _close(grads[True][name], g, 1e-6)


@pytest.mark.parametrize("cf", [0.5, 2.0])
def test_moe_remat_routes_the_same_tokens(monkeypatch, cf):
    """olmoe's smoke config, with a capacity that drops slots and one that
    does not: the recompute of remat routes and drops as the forward did
    (each layer's dropped share is logged twice, equal), the aux is counted once,
    and the gradients equal those without remat to f32 rounding. The aux
    reaches the gradients: without its weight the router's change."""
    out = {}
    for remat in (False, True):
        cfg = pconfigs.get_config("olmoe-1b-7b", "smoke", remat=remat, capacity_factor=cf)
        model = ptr.init_model(cfg, seed=3, device="cpu")
        state = pstep.init_state(cfg, padam.Adam(), model=model)
        batch = _batches(cfg, 1, batch=2)[0]
        logged = log_drops(monkeypatch, cf)
        total, metrics, grads = pstep.loss_and_grads(state.params, cfg, batch)
        monkeypatch.undo()
        out[remat] = (total, metrics["aux"], grads, logged)
    (t0, a0, g0, d0), (t1, a1, g1, d1) = out[False], out[True]
    assert len(d0) == cfg.num_layers and d1 == d0 + d0
    assert (max(d0) > 0) == (cf < 1)
    _close(t1, t0, 1e-6)
    _close(a1, a0, 1e-6)
    for name, g in g0.items():
        _close(g1[name], g, 1e-6)
    with torch.enable_grad():
        plain, _ = pstep.lm_loss(state.params, cfg, batch, aux_weight=0.0)
        router = state.params.blocks[0].moe.router
        g_plain, = torch.autograd.grad(plain, [router])
    assert (g1["blocks.0.moe.router"] - g_plain).abs().max() > 1e-6


@pytest.mark.parametrize("arch", NEW_ARCHS + FAMILY_ARCHS)
def test_checkpoint_of_moe_and_vlm_restores_in_the_reference(tmp_path, arch):
    """As below, for the MoE, vlm, audio, hybrid and ssm configs: the
    experts, the stacked cross blocks, the encoder and its positions and the
    ssm family's per-layer list restore into ``init_model``'s template, and
    the JAX forward of the restored weights (with the same memory) gives the
    port's logits."""
    path = tmp_path / "params.npz"
    out = ptrain.main(["--device", "cpu", "--arch", arch, "--steps", "2", "--batch",
                       "2", "--seq", "64", "--checkpoint", str(path)])
    model = out["state"].params
    jcfg = jconfigs.get_config(arch, "smoke")
    restored = jio.restore(path, jtr.init_model(jax.random.key(9), jcfg))
    tok = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    mem = next(token_batches(jcfg, batch=2, seq_len=8, seed=4)).get("memory")
    want, _ = jax.jit(lambda p, t, m: jtr.forward(p, jcfg, t, memory=m))(
        restored, jnp.asarray(tok), mem)
    with torch.no_grad():
        got, _ = ptr.forward(model, torch.from_numpy(tok).long(),
                             memory=None if mem is None else torch.from_numpy(mem))
    _close(got, want, 1e-4)


def test_checkpoint_restores_in_the_reference(tmp_path):
    """A port-written ``--checkpoint`` restores through the JAX package's
    ``checkpoint.io.restore`` into ``init_model``'s template, and the JAX
    forward of the restored weights gives the port's logits."""
    path = tmp_path / "params.npz"
    out = ptrain.main(["--device", "cpu", "--arch", "gemma3-12b", "--steps", "2", "--batch",
                       "2", "--seq", "70", "--checkpoint", str(path)])
    model = out["state"].params
    jcfg = jconfigs.get_config("gemma3-12b", "smoke")
    template = jtr.init_model(jax.random.key(9), jcfg)
    restored = jio.restore(path, template)
    tok = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 70)).astype(np.int32)
    want, _ = jax.jit(lambda p, t: jtr.forward(p, jcfg, t))(restored, jnp.asarray(tok))
    with torch.no_grad():
        got, _ = ptr.forward(model, torch.from_numpy(tok).long())
    _close(got, want, 1e-4)


def test_launcher_runs_and_refuses():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ptrain.main(["--arch", "qwen3-4b", "--steps", "1"])
    with pytest.raises(ValueError, match="aggregation"):
        pstep.make_train_step(pconfigs.get_config("qwen3-4b", "smoke"), padam.Adam(),
                              aggregation="gossip")
    # One pod and no process group: spread is the plain step.
    small = ["--device", "cpu", "--arch", "qwen3-4b", "--steps", "2", "--batch", "2",
             "--seq", "16"]
    plain = ptrain.main(small)
    spread = ptrain.main(small + ["--aggregation", "spread", "--pods", "1",
                                  "--gossip-every", "1"])
    assert spread["losses"] == plain["losses"]
    out = ptrain.main(["--device", "cpu", "--arch", "qwen3-4b", "--steps", "3", "--batch",
                       "4", "--seq", "33", "--microbatch", "2", "--remat"])
    assert len(out["losses"]) == len(out["seconds"]) == 3
    assert all(np.isfinite(out["losses"])) and out["state"].params.cfg.remat
