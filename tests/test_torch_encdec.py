"""Parity of the port's encoder-decoder (audio) family with the JAX package.

At the whisper-medium smoke config (f32, 2 encoder and 2 decoder layers,
LayerNorm, GELU, biases; 32 frames, a 64-row table of learned decoder
positions), the reference's ``transformer.init_model`` weights are carried
into the port by ``convert.lm_params_from_jax`` and ``memory_stub``'s frames
and the same numpy-seeded tokens go through both packages on the CPU: one
encoder block and one decoder block (self-attention, then the per-layer
cross-attention over the memory) per op; the encoder's output; forward
logits; prefill logits, every layer's k/v and the encoded memory in the
cache; 8 decode steps (past the 64 positions, which wrap as in the
reference); greedy tokens. With bf16 weights the encoder still runs in f32
on the f32 frames, as jnp promotes.

Tolerances: 1e-5 per op (f32 sums in other orders) and for the encoder's
output; 1e-4 after a whole stack; greedy tokens identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import lm_data as jdata
from repro.models import decoding as jdec
from repro.models import transformer as jtr
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs as pconfigs
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import flash_attention as pfa
from repro_torch.launch import serve as pserve
from repro_torch.models import decoding as pdec
from repro_torch.models import transformer as ptr
from repro_torch.serve.engine import ServeEngine as PServeEngine
from torch_parity import assert_init_like, assert_round_trip

OP_TOL = 1e-5
STACK_TOL = 1e-4
ARCH = "whisper-medium"


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=tol, rtol=tol)


def _pair(**over):
    jcfg = jconfigs.get_config(ARCH, "smoke", **over)
    params = jax.jit(jtr.init_model, static_argnums=1)(jax.random.key(0), jcfg)
    pcfg = pconfigs.get_config(ARCH, "smoke", **over)
    model = lm_params_from_jax(jax.tree.map(np.asarray, params), pcfg, "cpu")
    return jcfg, params, model


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax params, port model) from the same weights, f32."""
    return _pair()


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _frames(cfg, b, seed=0):
    return jdata.memory_stub(cfg, b, rng=np.random.default_rng(seed))


def _layer(params, i, stacked="blocks"):
    """Layer ``i`` of the reference's stacked encoder (or decoder) blocks."""
    tree = params["encoder"]["blocks"] if stacked == "encoder" else params["blocks"][0]
    return jax.tree.map(lambda t: t[i], tree)


def test_encoder_block(pair):
    jcfg, params, model = pair
    x = np.random.default_rng(1).normal(size=(2, jcfg.encoder_seq, jcfg.d_model)
                                        ).astype(np.float32)
    want, _ = jax.jit(lambda p, x: jtr.apply_block(p, x, jcfg, "encoder", window=0,
                                                   causal=False))(
        _layer(params, 1, "encoder"), jnp.asarray(x))
    got, aux = ptr.apply_block(model.encoder.blocks[1], _t(x), model.cfg, "encoder", window=0)
    assert aux is None
    _close(got, want, OP_TOL)


def test_decoder_block(pair):
    """Causal self-attention without RoPE, then cross-attention over the
    memory, then the GELU MLP."""
    jcfg, params, model = pair
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 24, jcfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(2, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
    want, _ = jax.jit(lambda p, x, m: jtr.apply_block(p, x, jcfg, "encdec_dec", window=0,
                                                      memory=m))(
        _layer(params, 1), jnp.asarray(x), jnp.asarray(mem))
    got, _ = ptr.apply_block(model.blocks[1], _t(x), model.cfg, "encdec_dec", window=0,
                             memory=_t(mem))
    _close(got, want, OP_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_output(dtype):
    """The encoder's output over memory_stub's f32 frames; with bf16 weights
    every product still runs in f32 (frames + positions is f32), so it holds
    1e-5 there too."""
    jcfg, params, model = _pair(dtype=dtype)
    frames = _frames(jcfg, 2)
    want = jax.jit(lambda p, f: jtr._encode_memory(p, jcfg, f))(params, jnp.asarray(frames))
    got = ptr.encode_memory(model, _t(frames))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, OP_TOL)


@pytest.mark.parametrize("s", [40, 80])
def test_forward_matches(pair, s):
    """Logits; at 80 tokens the decoder's positions wrap past its 64 rows."""
    jcfg, params, model = pair
    tok, frames = _tokens(jcfg, 2, s), _frames(jcfg, 2)
    want, _ = jax.jit(lambda p, t, m: jtr.forward(p, jcfg, t, memory=m))(
        params, jnp.asarray(tok), frames)
    got, aux = ptr.forward(model, _t(tok).long(), memory=_t(frames))
    assert got.shape == want.shape and aux.item() == 0.0
    _close(got, want, STACK_TOL)


@pytest.mark.parametrize("s", [40, 60])
def test_prefill_and_decode_match(pair, s):
    """Prefill logits, each layer's k/v and the encoded memory in the cache;
    then 8 decode steps fed the same tokens (at 60 they pass position 64)."""
    jcfg, params, model = pair
    tok, frames = _tokens(jcfg, 2, s), _frames(jcfg, 2)
    jl, jc = jax.jit(lambda p, t, m: jdec.prefill(p, jcfg, t, max_len=s + 12, memory=m))(
        params, jnp.asarray(tok), frames)
    with torch.no_grad():
        pl_, pc = pdec.prefill(model, _t(tok).long(), max_len=s + 12, memory=_t(frames))
    _close(pl_, jl, STACK_TOL)
    _close(pc["memory"], jc["memory"], OP_TOL)
    for got, want in zip(pc["layers"], jc["layers"]):
        assert set(got) == set(want) == {"k", "v"}
        _close(got["k"], want["k"], STACK_TOL)
        _close(got["v"], want["v"], STACK_TOL)
    jstep = jax.jit(lambda p, c, t: jdec.decode_step(p, jcfg, c, t))
    feed = _tokens(jcfg, 2, 8, seed=1)
    for i in range(8):
        jl, jc = jstep(params, jc, jnp.asarray(feed[:, i:i + 1]))
        with torch.no_grad():
            pl_, pc = pdec.decode_step(model, pc, _t(feed[:, i:i + 1]).long())
        _close(pl_, jl, STACK_TOL)
    assert pc["pos"] == int(jc["pos"]) == s + 8


def test_generate_greedy_tokens_identical(pair):
    jcfg, params, model = pair
    tok, frames = _tokens(jcfg, 3, 40), _frames(jcfg, 3)
    want = JServeEngine(jcfg, params, max_len=64).generate(tok, steps=12, memory=frames)
    got = PServeEngine(model, max_len=64).generate(tok, steps=12, memory=frames)
    np.testing.assert_array_equal(got, want)


def test_logits_depend_on_the_frames(pair):
    _, _, model = pair
    tok = _t(_tokens(model.cfg, 2, 24)).long()
    a, _ = ptr.forward(model, tok, memory=_t(_frames(model.cfg, 2, seed=1)))
    b, _ = ptr.forward(model, tok, memory=_t(_frames(model.cfg, 2, seed=2)))
    assert (a - b).abs().max() > 1e-3
    with pytest.raises(ValueError, match="frames"):
        ptr.forward(model, tok)


def test_init_matches_reference_scales(pair):
    """``init_model`` draws the encoder's positions and blocks and the
    decoder's positions and cross blocks at the reference's scales."""
    _, _, ref_model = pair
    model = ptr.init_model(ref_model.cfg, seed=1, device="cpu")
    assert_init_like(model.state_dict(), ref_model.state_dict())


def test_convert_round_trip(pair):
    """The encoder's blocks stacked along ``[encoder_layers]``, its
    positions, and ``embed.positions``, leaf for leaf."""
    _, params, model = pair
    assert_round_trip(model, params)


def test_serve_launcher_encodes_the_frames():
    """``launch.serve --arch whisper-medium`` on the CPU: memory_stub's frames
    go through the encoder; the decoder's prefill runs the kernel's plain
    version, no launch."""
    before = pfa.launches
    out = pserve.main(["--device", "cpu", "--arch", ARCH, "--batch", "2", "--prompt-len",
                       "24", "--steps", "4"])
    assert out["memory"].shape == (2, 32, 128) and pfa.launches == before
    assert out["tokens"].shape == (2, 4) and torch.isfinite(out["logits"]).all()
