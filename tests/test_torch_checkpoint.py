"""The port's ``.npz`` checkpoints (``repro_torch.checkpoint.io``).

Round trips of every kind of leaf and node, the reference's errors (missing
leaf, shape mismatch) and its leaf names; the port's own save and resume
bit for bit, through the trainer and through the launcher; and files the
JAX package wrote: an FGL state that ``fgl_train --resume`` continues, and
a smoke LM that ``serve --checkpoint`` serves.
"""
import dataclasses
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import io as jio
from repro.core import registry as jreg
from repro.models import transformer as jtr
from repro_torch import configs as pconfigs
from repro_torch import convert
from repro_torch.checkpoint import io as pio
from repro_torch.core import registry as preg
from repro_torch.launch import fgl_train, serve
from repro_torch.serve.engine import ServeEngine
from torch_fgl_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_fgl_parity import assert_histories_close, port_batch, port_state, replay_noises


class Pair(NamedTuple):
    a: torch.Tensor
    b: list


def _tree():
    g = torch.Generator().manual_seed(3)
    return {"w": torch.randn(3, 4, generator=g), "n": 7, "lr": 0.5,
            "pair": Pair(torch.arange(5, dtype=torch.int32), [torch.ones(2), (1.5, 2)]),
            "half": torch.randn(4, generator=g).to(torch.bfloat16), "gen": g}


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, torch.Generator):
        assert torch.equal(a.get_state(), b.get_state())
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name))
    else:
        assert a == b


class TestIO:
    def test_round_trip_of_every_leaf_and_node(self, tmp_path):
        tree = _tree()
        pio.save(tmp_path / "deep" / "t.npz", tree)       # parent directories made
        names = set(np.load(tmp_path / "deep" / "t.npz").files)
        assert names == {"w", "n", "lr", "pair/a", "pair/b/0", "pair/b/1/0", "pair/b/1/1",
                         "half", "gen"}
        template = _tree()
        template["w"] = torch.zeros(3, 4)
        template["gen"] = torch.Generator().manual_seed(99)
        _same(pio.restore(tmp_path / "deep" / "t.npz", template), _tree())

    def test_python_scalars_stay_python_scalars(self, tmp_path):
        pio.save(tmp_path / "s.npz", {"round": 7, "lr": 0.25})
        out = pio.restore(tmp_path / "s.npz", {"round": 0, "lr": 0.0})
        assert out == {"round": 7, "lr": 0.25} and type(out["round"]) is int

    def test_bare_leaf_is_root(self, tmp_path):
        pio.save(tmp_path / "r.npz", torch.arange(3.0))
        assert np.load(tmp_path / "r.npz").files == ["_root"]
        torch.testing.assert_close(pio.restore(tmp_path / "r.npz", torch.zeros(3)),
                                   torch.arange(3.0))
        torch.testing.assert_close(pio.load(tmp_path / "r.npz"), torch.arange(3.0))

    def test_missing_leaf_names_the_path(self, tmp_path):
        pio.save(tmp_path / "m.npz", {"a": {"b": torch.zeros(2)}})
        with pytest.raises(KeyError, match="a/c"):
            pio.restore(tmp_path / "m.npz", {"a": {"b": torch.zeros(2), "c": torch.zeros(1)}})

    def test_shape_mismatch_names_the_path(self, tmp_path):
        pio.save(tmp_path / "m.npz", {"a": [torch.zeros(2, 3)]})
        with pytest.raises(ValueError, match="a/0"):
            pio.restore(tmp_path / "m.npz", {"a": [torch.zeros(3, 2)]})

    def test_restore_casts_to_template_dtype(self, tmp_path):
        pio.save(tmp_path / "d.npz", {"x": torch.arange(4, dtype=torch.int64)})
        out = pio.restore(tmp_path / "d.npz", {"x": torch.zeros(4, dtype=torch.float32)})
        assert out["x"].dtype == torch.float32

    def test_load_rebuilds_the_nesting_from_names(self, tmp_path):
        pio.save(tmp_path / "n.npz", {"blocks": [{"w": torch.ones(1)}] * 12, "e": torch.ones(2)})
        out = pio.load(tmp_path / "n.npz")
        assert isinstance(out["blocks"], list) and len(out["blocks"]) == 12
        assert set(out) == {"blocks", "e"}


@pytest.fixture(scope="module")
def spread(small):
    """The reference and the port's SpreadFGL under partial participation
    and gossip every 2 rounds, and the reference's state after 2 rounds."""
    batch, cfg = small
    cfg = dataclasses.replace(cfg, participation=0.5)
    jtr_ = jreg.build("spreadfgl_gossip", cfg, batch, num_servers=2, gossip_every=2)
    ptr = preg.build("spreadfgl_gossip", cfg, batch, num_servers=2, gossip_every=2,
                     device="cpu")
    j2, _ = jtr_.fit(jax.random.key(0), batch, rounds=2)
    return jtr_, ptr, j2


def test_leaf_names_are_the_references(spread, tmp_path):
    _, _, j2 = spread
    jio.save(tmp_path / "j.npz", j2)
    pio.save(tmp_path / "p.npz", port_state(j2))
    jnames, pnames = set(np.load(tmp_path / "j.npz").files), set(np.load(tmp_path / "p.npz").files)
    assert jnames == pnames - {"gen"}     # the port writes the reference's key too


def test_own_save_and_resume_is_bit_for_bit(spread, tmp_path):
    _, ptr, j2 = spread
    pb = port_batch(j2.batch)
    _, full = ptr.fit(pb, rounds=4)
    state, first = ptr.fit(pb, rounds=2)
    pio.save(tmp_path / "s.npz", state)
    restored = fgl_train.resume_state(tmp_path / "s.npz", ptr.init(pb))
    assert restored.round == 2 and type(restored.round) is int
    _, second = ptr.fit(state=restored, rounds=2)
    for k in ("round", "loss", "acc", "f1"):
        assert first[k] + second[k] == full[k], k


def test_resume_reads_a_jax_written_fgl_checkpoint(spread, tmp_path):
    """Every leaf but the key comes across exactly; the continuation,
    handed the reference's noise and masks, follows the reference's."""
    jtr_, ptr, j2 = spread
    jio.save(tmp_path / "j.npz", j2)
    restored = fgl_train.resume_state(tmp_path / "j.npz", ptr.init(port_batch(j2.batch)))
    want = port_state(j2)
    for f in ("params", "opt_state", "ae_params", "ae_opt", "as_params", "as_opt", "batch"):
        _same(getattr(restored, f), getattr(want, f))
    assert restored.round == 2
    noises = replay_noises(jtr_, j2, 2)
    _, jh = jtr_.fit(state=j2, rounds=2)
    _, ph = ptr.fit(state=restored, rounds=2, noise=noises.get,
                    mask=lambda r: torch.from_numpy(np.array(jtr_._participation_mask(r))))
    assert_histories_close(ph, jh)


def test_jax_package_resumes_a_port_checkpoint(spread, tmp_path):
    """A state the port saved is restored by the JAX package's
    ``checkpoint.io.restore``, its key derived from the seed and the round,
    and continued by the reference's ``FGLTrainer.fit(state=)``; the port,
    continuing from the same file with the reference's noise and masks,
    follows it."""
    jtr_, ptr, j2 = spread
    pstate, _ = ptr.fit(state=port_state(j2), rounds=1,
                        noise=replay_noises(jtr_, j2, 1).get,
                        mask=lambda r: torch.from_numpy(np.array(jtr_._participation_mask(r))))
    pio.save(tmp_path / "p.npz", pstate)
    restored = jio.restore(tmp_path / "p.npz", jtr_.init(jax.random.key(5), j2.batch))
    assert restored.round == 3 and type(restored.round) is int
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(restored.key)),
                                  np.array([3, jtr_.cfg.seed], np.uint32))
    np.testing.assert_array_equal(  # at round 0 the key is jax.random.key(seed)'s
        pio.save(tmp_path / "r0.npz", dataclasses.replace(pstate, round=0)) or
        np.load(tmp_path / "r0.npz")["key"], jax.random.key_data(jax.random.key(jtr_.cfg.seed)))
    _same(port_state(restored), dataclasses.replace(pstate, gen=port_state(restored).gen))
    noises = replay_noises(jtr_, restored, 2)
    _, jh = jtr_.fit(state=restored, rounds=2)
    assert jh["round"] == [3, 4] and np.all(np.isfinite(jh["loss"]))
    resumed = fgl_train.resume_state(tmp_path / "p.npz", ptr.init(port_batch(j2.batch)))
    _, ph = ptr.fit(state=resumed, rounds=2, noise=noises.get,
                    mask=lambda r: torch.from_numpy(np.array(jtr_._participation_mask(r))))
    assert_histories_close(ph, jh)


def test_cli_save_then_resume_equals_one_run(tmp_path, capsys):
    base = ["--device", "cpu", "--dataset", "cora", "--scale", "0.06", "--clients", "4",
            "--servers", "2", "--local-rounds", "1", "-K", "2", "--top-k", "3",
            "--participation", "0.5"]
    full = fgl_train.main(base + ["--rounds", "3"])
    first = fgl_train.main(base + ["--rounds", "2", "--save-state", str(tmp_path / "c.npz")])
    second = fgl_train.main(base + ["--rounds", "1", "--resume", str(tmp_path / "c.npz")])
    assert "[fgl] resumed" in capsys.readouterr().out
    for k in ("round", "loss", "acc", "f1"):
        assert first[k] + second[k] == full[k], k


def test_serve_reads_a_jax_written_lm_checkpoint(tmp_path):
    jcfg = jconfigs.get_config("qwen3-4b", "smoke")
    params = jtr.init_model(jax.random.key(0), jcfg)
    jio.save(tmp_path / "lm.npz", params)
    args = ["--device", "cpu", "--arch", "qwen3-4b", "--batch", "2", "--prompt-len", "12",
            "--steps", "3"]
    got = serve.main(args + ["--checkpoint", str(tmp_path / "lm.npz")])
    pcfg = pconfigs.get_config("qwen3-4b", "smoke")
    want_model = convert.lm_params_from_jax(jax.tree.map(np.asarray, params), pcfg, "cpu")
    loaded = convert.lm_params_from_jax(pio.load(tmp_path / "lm.npz"), pcfg, "cpu")
    for (k, a), (_, b) in zip(want_model.state_dict().items(), loaded.state_dict().items()):
        assert torch.equal(a, b), k
    prompts = np.random.default_rng(0).integers(0, pcfg.vocab_size, (2, 12))
    want_logits, _ = ServeEngine(want_model, max_len=12 + 3 + 8).prefill(prompts)
    torch.testing.assert_close(got["logits"], want_logits, rtol=0, atol=0)
    random = serve.main(args)          # the port's own random weights differ
    assert not torch.equal(random["logits"], got["logits"])
