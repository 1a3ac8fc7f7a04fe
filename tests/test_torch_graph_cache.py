"""The classifier's graph inputs, prepared once per batch (``FGLTrainer._graph``).

- Bit for bit: ``fit`` over two K-periods gives the same params, optimizer
  and generator states, batch and history as a run whose ``_logits``
  prepares the graph afresh in every forward, for SpreadFGL, FedGL,
  FedSage+, the GCN and GAT kinds, and across a resume from a mid-run state.
- The counters ``fgl.graph_built`` and ``fgl.graph_reused``: one build and
  (forwards - 1) reuses per K-period once the first has passed.
- Lifetime: no prepared graph is alive while the generator trains or
  FedSage+ generates; after an imputation the evaluation's logits are those
  of the new batch.
- ``fix_graphs`` and ``_local_generation`` return new tensors, which the
  cache's identity key relies on.
- ``chip_smoke.py``'s expected launch counts are the calls a run makes.
"""
import dataclasses

import pytest
import torch

from repro_torch import trace
from repro_torch.core import fedgl, gnn, patcher, strategies
from repro_torch.core.baselines import FedSagePlus
from repro_torch.core.partition import partition_graph
from repro_torch.core.spreadfgl import make_fedgl, make_spreadfgl
from repro_torch.core.types import FGLConfig
from repro_torch.data.synthetic_graphs import DATASETS, make_sbm_graph
from repro_torch.kernels import ops
from repro_torch.launch import fgl_train

K, LOCAL = 2, 2


@pytest.fixture(scope="module")
def batch():
    g = make_sbm_graph(DATASETS["cora"], scale=0.04, seed=1)
    return partition_graph(g, 4, aug_max=3, seed=0)[0]


def _trainer(method, batch, kind="sage"):
    cfg = FGLConfig(hidden_dim=8, local_rounds=LOCAL, imputation_interval=K, top_k_links=2,
                    aug_max=3, ae_iters=1, assessor_iters=1, ae_outer_iters=1, seed=3,
                    gnn_kind=kind)
    if method == "SpreadFGL":
        return make_spreadfgl(cfg, batch, num_servers=2, device="cpu")
    if method == "FedGL":
        return make_fedgl(cfg, batch, device="cpu")
    return FedSagePlus(cfg, batch, gen_steps=2, device="cpu")


def _fresh_logits(self, params_m, batch):
    """The forward as it was before the cache: prepared in every call."""
    return gnn.apply_classifier(params_m, self.cfg.gnn_kind, batch.x, batch.adj,
                                batch.node_mask)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    raise TypeError(type(tree))


def _state_leaves(state):
    b = state.batch
    return _leaves([state.params, state.opt_state, state.ae_params, state.ae_opt,
                    state.as_params, state.as_opt, b.x, b.adj, b.node_mask, b.y,
                    state.gen.get_state()])


def _run(method, batch, kind, resume):
    if not resume:
        return _trainer(method, batch, kind).fit(batch, rounds=2 * K)
    state, first = _trainer(method, batch, kind).fit(batch, rounds=1)
    state, rest = _trainer(method, batch, kind).fit(state=state, rounds=2 * K - 1)
    return state, {key: first[key] + rest[key] for key in first}


@pytest.mark.parametrize("method,kind,resume", [
    ("SpreadFGL", "sage", False), ("FedGL", "sage", False), ("fedsage_plus", "sage", False),
    ("SpreadFGL", "gcn", False), ("SpreadFGL", "gat", False), ("SpreadFGL", "sage", True),
])
def test_cached_graph_is_bitwise_a_fresh_one(batch, monkeypatch, method, kind, resume):
    cached, cached_hist = _run(method, batch, kind, resume)
    monkeypatch.setattr(fedgl.FGLTrainer, "_logits", _fresh_logits)
    fresh, fresh_hist = _run(method, batch, kind, resume)
    got, want = _state_leaves(cached), _state_leaves(fresh)
    assert len(got) == len(want) > 10
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert cached.round == fresh.round == 2 * K
    for key in ("round", "loss", "acc", "f1"):
        assert cached_hist[key] == fresh_hist[key], key


@pytest.mark.parametrize("method", ["SpreadFGL", "FedGL", "fedsage_plus"])
def test_graph_built_once_a_period(batch, method):
    tr = _trainer(method, batch)
    with trace.recording():
        tr.fit(batch, rounds=2 * K)
    counters = trace.drain().counters
    built, reused = counters["fgl.graph_built"], counters.get("fgl.graph_reused", {})
    embeds = 1 if method != "fedsage_plus" else 0      # the imputation's embedding pass
    forwards = K * (LOCAL + 1) + embeds
    # The first period also builds for the trainer's first forward.
    assert sum(built.get(t, 0) for t in range(K)) == 2
    assert sum(reused.get(t, 0) for t in range(K)) == forwards - 2
    assert sum(built.get(t, 0) for t in range(K, 2 * K)) == 1
    assert sum(reused.get(t, 0) for t in range(K, 2 * K)) == forwards - 1


@pytest.mark.parametrize("method", ["SpreadFGL", "fedsage_plus"])
def test_no_graph_alive_while_imputing(batch, monkeypatch, method):
    tr = _trainer(method, batch)
    seen = []
    if method == "SpreadFGL":
        orig = fedgl.FGLTrainer._train_generator

        def spy(self, *args):
            seen.append(self._prepared)
            return orig(self, *args)
        monkeypatch.setattr(fedgl.FGLTrainer, "_train_generator", spy)
    else:
        orig = strategies._local_generation

        def spy(*args):
            seen.append(tr._prepared)
            return orig(*args)
        monkeypatch.setattr(strategies, "_local_generation", spy)
    state = tr.init(batch)
    for _ in range(K + 1):
        state, _ = tr.step(state)
    assert seen == [None, None]
    assert tr._prepared is not None         # the evaluation built it again


@pytest.mark.parametrize("method", ["SpreadFGL", "fedsage_plus"])
def test_evaluation_after_imputation_reads_the_new_batch(batch, monkeypatch, method):
    tr = _trainer(method, batch)
    state = tr.init(batch)                                      # no aug slot filled yet
    calls = []
    orig = gnn.forward

    def spy(params, kind, g):
        out = orig(params, kind, g)
        calls.append((params, out))
        return out
    monkeypatch.setattr(gnn, "forward", spy)
    new, _ = tr.step(state)                                     # round 0 imputes
    assert not torch.equal(new.batch.adj, state.batch.adj)
    params, logits = calls[-1]                                  # the evaluation's
    kind = tr.cfg.gnn_kind
    want = gnn.apply_classifier(params, kind, new.batch.x, new.batch.adj, new.batch.node_mask)
    stale = gnn.apply_classifier(params, kind, state.batch.x, state.batch.adj,
                                 state.batch.node_mask)
    assert torch.equal(logits, want) and not torch.equal(logits, stale)
    assert all(a is b for a, b in zip(tr._prepared[0],
                                      (new.batch.x, new.batch.adj, new.batch.node_mask)))


def _storage(t):
    return t.untyped_storage().data_ptr()


@pytest.mark.parametrize("fix", ["fix_graphs", "_local_generation"])
def test_graph_fixing_returns_new_tensors(batch, fix):
    tr = _trainer("SpreadFGL", batch)
    state = tr.init(batch)
    if fix == "fix_graphs":
        out = tr.imputation.server_outputs(tr, state)
        scores, idx, x_bar = patcher.stitch_server_links(*out[4:])
        new = patcher.fix_graphs(state.batch, scores, idx, x_bar)
    else:
        new = strategies._local_generation(state.batch, 2)
    for name in ("x", "adj", "node_mask"):
        old_t, new_t = getattr(state.batch, name), getattr(new, name)
        assert new_t is not old_t and _storage(new_t) != _storage(old_t), name


def test_another_batch_misses_the_cache(batch):
    """The identity key alone, with no release between: each batch gets its
    own graph, and the first is reused until another comes."""
    tr = _trainer("SpreadFGL", batch)
    state = tr.init(batch)
    other = state.batch.replace(x=state.batch.x * 2.0)
    with trace.recording():
        for b in (state.batch, state.batch, other, state.batch):
            got = tr._logits(state.params, b)
            want = gnn.apply_classifier(state.params, "sage", b.x, b.adj, b.node_mask)
            assert torch.equal(got, want)
    counters = trace.drain().counters
    assert counters["fgl.graph_built"][None] == 3 and counters["fgl.graph_reused"][None] == 1


SMOKE_ARGS = ["--device", "cpu", "--dataset", "cora", "--scale", "0.04", "--clients", "4",
              "--servers", "2", "--local-rounds", "2", "--rounds", "3"]


@pytest.mark.parametrize("extra,kind", [
    ([], "sage"), (["--method", "FedGL"], "sage"), (["--method", "fedsage_plus"], "sage"),
    (["--method", "local"], "sage"), (["--gossip-every", "2"], "sage"),
    (["--async-buffer", "2", "--delay-dist", "uniform", "--dropout-rate", "0.1"], "sage"),
    ([], "gcn"), ([], "gat"), (["--resume"], "sage"),
])
def test_chip_smoke_expected_launches_are_the_calls(monkeypatch, tmp_path, extra, kind):
    from chip_smoke import _expected_launches

    calls = {"sage_aggregate": 0, "sim_topk": 0}

    def counted(name):
        orig = getattr(ops, name)

        def fn(*args, **kw):
            calls[name] += 1
            return orig(*args, **kw)
        monkeypatch.setattr(ops, name, fn)
    counted("sage_aggregate")
    counted("sim_topk")
    argv, start = SMOKE_ARGS + extra, 0
    if extra == ["--resume"]:
        path = str(tmp_path / "state.npz")
        fgl_train.main(SMOKE_ARGS + ["--rounds", "2", "--save-state", path])
        calls.update(sage_aggregate=0, sim_topk=0)
        argv, start = SMOKE_ARGS + ["--rounds", "1", "--resume", path], 2
    flags = fgl_train.parse(argv)
    if kind == "sage":
        fgl_train.main(argv)
    else:
        cfg = dataclasses.replace(fgl_train.config(flags), gnn_kind=kind)
        batch = fgl_train.build_data(flags)[0]
        make_spreadfgl(cfg, batch, num_servers=flags.servers, device="cpu").fit(
            batch, rounds=flags.rounds)
    assert calls == _expected_launches(flags, start=start, gnn_kind=kind)
