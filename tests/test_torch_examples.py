"""The port's examples (``examples_torch/``) against the JAX package's.

Each script of ``examples/`` has a counterpart of the same name in
``examples_torch/`` that imports ``torch``, ``numpy`` and ``repro_torch``
only; its ``run`` takes the sizes that ``main`` passes, so the tests run it
small, on the CPU.

- The numpy-made parts of ``quickstart`` and ``spreadfgl_multiserver`` (the
  SBM stand-ins, the client split, the deleted links, the label entropy)
  equal the JAX package's on the same seeds.
- ``quickstart``'s lifecycle (steps, then ``fit(state=)``) from the
  reference's initial state matches the JAX trainer's within 1e-4 a round,
  the port handed the reference's imputation noise
  (``tests/torch_fgl_parity.py``).
- ``serve_lm`` serves every arch id; for qwen3-4b (its default) and
  hymba-1.5b (head dim 20, which the card runs zero-padded to 32) its greedy
  tokens equal the JAX ``ServeEngine``'s from the same weights
  (``repro_torch.convert``).
- ``train_lm_gossip`` runs its pods as 2 gloo ranks on the CPU; their
  reports show the pods' parameters identical after every all-reduce step,
  changed by every gossip exchange, and their mean kept by every exchange.
- Every script raises on ``--device cuda`` without a card.
"""
import dataclasses
import importlib
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.core import registry as jreg
from repro.core.partition import count_missing_links as jcount_missing_links
from repro.core.partition import label_skew_entropy as jlabel_skew_entropy
from repro.core.partition import make_partitioner as jmake_partitioner
from repro.core.partition import partition_graph as jpartition_graph
from repro.core.types import FGLConfig as JFGLConfig
from repro.data.synthetic_graphs import DATASETS as JDATASETS
from repro.data.synthetic_graphs import make_sbm_graph as jmake_sbm_graph
from repro.serve.engine import ServeEngine as JServeEngine
from torch_fgl_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_fgl_parity import FIT_TOL, port_state, replay_noises

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:       # examples_torch, here and in the ranks
    sys.path.insert(0, str(ROOT))

from examples_torch import quickstart, serve_lm, spreadfgl_multiserver  # noqa: E402
from examples_torch import train_lm_gossip  # noqa: E402
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.core.partition import count_missing_links as pcount_missing_links  # noqa: E402
from repro_torch.core.partition import label_skew_entropy as plabel_skew_entropy  # noqa: E402
from repro_torch.tree import tree_fingerprint  # noqa: E402

SCRIPTS = ("quickstart", "spreadfgl_multiserver", "serve_lm", "train_lm_gossip")


def _jax_split(dataset, scale, clients, **part):
    graph = jmake_sbm_graph(JDATASETS[dataset], scale=scale, seed=1, feature_noise=3.0,
                            signal_ratio=0.5)
    batch, assign = jpartition_graph(graph, num_clients=clients, aug_max=12, seed=0, **part)
    return graph, batch, assign


def _same_split(port, ref):
    (pg, pb, pa), (jg, jb, ja) = port, ref
    assert (pg.num_nodes, pg.num_edges, pg.num_classes) == (jg.num_nodes, jg.num_edges,
                                                            jg.num_classes)
    np.testing.assert_array_equal(pg.x, np.asarray(jg.x))
    np.testing.assert_array_equal(pa, np.asarray(ja))
    assert pcount_missing_links(pg, pa) == jcount_missing_links(jg, ja)
    for name in ("x", "adj", "y", "node_mask", "train_mask", "test_mask", "global_id"):
        np.testing.assert_array_equal(getattr(pb, name), np.asarray(getattr(jb, name)), name)


def test_quickstart_data_equals_the_references():
    port = quickstart.data(0.15, 6)
    _same_split(port, _jax_split("cora", 0.15, 6, label_ratio=0.3))
    assert (port[0].num_nodes, port[0].num_classes) == (406, 7)


@pytest.mark.parametrize("partitioner,alpha", [("label_prop", 1.0), ("dirichlet", 0.1)])
def test_multiserver_data_equals_the_references(partitioner, alpha):
    port = spreadfgl_multiserver.data(0.15, partitioner, alpha)
    ref = _jax_split("citeseer", 0.15, 6,
                     partitioner=jmake_partitioner(partitioner, alpha=alpha))
    _same_split(port, ref)
    np.testing.assert_allclose(
        plabel_skew_entropy(port[2], port[0].y, 6),
        jlabel_skew_entropy(np.asarray(ref[2]), np.asarray(ref[0].y), 6), rtol=0, atol=1e-12)


def test_quickstart_lifecycle_matches_the_reference():
    """Two steps, then fit(state=, rounds=2), both packages from the
    reference's initial state; each round's loss, accuracy and F1 within
    1e-4."""
    scale, clients = 0.08, 4
    _, jbatch, _ = _jax_split("cora", scale, clients, label_ratio=0.3)
    jcfg = JFGLConfig(**dataclasses.asdict(quickstart.CONFIG), kernel_impl="reference")
    jtr = jreg.build("FedGL", jcfg, jbatch)
    jstate = jtr.init(jax.random.key(0), jbatch)
    noises = replay_noises(jtr, jstate, 4)
    out = quickstart.run(scale=scale, clients=clients, steps=2, rounds=2, device="cpu",
                         state=port_state(jstate), noise=noises.get)
    want = {"round": [], "loss": [], "acc": [], "f1": []}
    st = jstate
    for _ in range(2):
        st, m = jtr.step(st)
        for key in want:
            want[key].append(int(m[key]) if key == "round" else float(m[key]))
    _, jh = jtr.fit(state=st, rounds=2)
    got = {key: out["step"][key] + out["fit"][key] for key in want}
    assert got["round"] == [0, 1, 2, 3] == want["round"] + jh["round"]
    for key in ("loss", "acc", "f1"):
        np.testing.assert_allclose(got[key], want[key] + jh[key], atol=FIT_TOL, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("arch", pconfigs.ARCH_IDS)
def test_serve_lm_serves_every_arch(arch, capsys):
    out = serve_lm.run(arch, steps=2, batch=1, device="cpu")
    cfg = pconfigs.get_config(arch, "smoke")
    assert out["tokens"].shape == (1, 2) and out["tokens"].dtype == np.int32
    assert ((0 <= out["tokens"]) & (out["tokens"] < cfg.vocab_size)).all()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"[serve] {cfg.name}: 1 requests × 16 prompt tokens -> 2 new tokens"
    assert lines[1] == f"  request 0: {out['tokens'][0].tolist()}"


@pytest.mark.parametrize("arch", ["qwen3-4b", "hymba-1.5b"])
def test_serve_lm_greedy_tokens_equal_the_references(arch):
    from repro import configs as jconfigs
    from repro.models import transformer as jtr

    jcfg = jconfigs.get_config(arch, "smoke")
    params = jax.jit(jtr.init_model, static_argnums=1)(jax.random.key(0), jcfg)
    model = lm_params_from_jax(jax.tree.map(np.asarray, params),
                               pconfigs.get_config(arch, "smoke"), "cpu")
    batch, prompt_len, steps = 2, 16, 8
    out = serve_lm.run(arch, steps=steps, batch=batch, prompt_len=prompt_len, device="cpu",
                       model=model)
    want = JServeEngine(jcfg, params, max_len=prompt_len + steps + 8).generate(
        out["prompts"], steps=steps)
    np.testing.assert_array_equal(out["tokens"], np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_fingerprint_sees_a_changed_or_moved_element(dtype):
    """The fingerprint the gossip pods report: equal trees, equal numbers;
    one element changed, two swapped, or two leaves swapped, another."""
    import torch

    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(3, 5, generator=gen).to(getattr(torch, dtype)),
            "b": [torch.randn(5, generator=gen).to(getattr(torch, dtype))]}
    fp = tree_fingerprint(tree)
    assert fp == tree_fingerprint({"a": tree["a"].clone(), "b": [tree["b"][0].clone()]})
    changed = tree["a"].clone()
    changed[1, 2] = -changed[1, 2]
    swapped = tree["a"].clone()
    swapped[0, [0, 1]] = swapped[0, [1, 0]]
    others = [{"a": changed, "b": tree["b"]}, {"a": swapped, "b": tree["b"]},
              {"a": tree["b"][0], "b": [tree["a"]]}]
    assert all(tree_fingerprint(t) != fp for t in others)


def test_train_lm_gossip_pods_on_gloo(monkeypatch):
    """Two pods on the CPU over gloo at the xLSTM smoke config (f32), 3
    steps a mode, gossip every 2 steps: in mode allreduce an exchange after
    every step, after which the pods' parameters have one fingerprint; in
    mode spread one exchange (step 1), which changed each pod's parameters;
    every exchange keeps, leaf by leaf, the pods' summed parameters within
    1e-5 of their summed |p|. Pods still running after 120 s are killed."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")      # the ranks' torch threads
    out = train_lm_gossip.run(steps=3, batch=4, seq=32, gossip_every=2, variant="smoke",
                              pods=2, device="cpu", timeout=120)
    ranks = out["ranks"]
    for rank in ranks:
        losses = rank["allreduce"] + rank["spread"]
        assert len(losses) == 6 and np.isfinite(losses).all()
        assert [e["step"] for e in rank["exchanges"]["allreduce"]] == [0, 1, 2]
        assert [e["step"] for e in rank["exchanges"]["spread"]] == [1]
    for mode in ("allreduce", "spread"):
        for each in zip(*(rank["exchanges"][mode] for rank in ranks)):
            if mode == "allreduce":
                assert each[0]["print_after"] == each[1]["print_after"]
            else:
                assert all(e["print_after"] != e["print_before"] for e in each)
            before, after, scale = (np.sum([e[key] for e in each], axis=0)
                                    for key in ("sum_before", "sum_after", "abs_before"))
            assert (np.abs(after - before) <= 1e-5 * scale).all()
    assert ranks[1]["allreduce"] == out["allreduce"]     # the pods' mean loss
    assert out["allreduce"][0] == out["spread"][0]      # the same start, no exchange yet


@pytest.mark.parametrize("script", SCRIPTS)
def test_scripts_raise_without_a_card(script):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    module = importlib.import_module(f"examples_torch.{script}")
    for argv in (["--device", "cuda"], []):
        with pytest.raises(RuntimeError, match="CUDA"):
            module.main(argv)
