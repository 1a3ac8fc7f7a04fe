"""The port's spans and counters (``repro_torch.trace``) in the FGL round.

- Off (no profiler, no recorder) a span is one shared no-op object, opens
  no ``record_function`` and records nothing.
- The recorder sees every layer of a round under its parent and round, the
  imputation's parts only on imputation rounds, the classifier's graph built
  (``fgl.graph``) in the first forward of each batch, and the two link
  counters agree with the patched batch; the states it leaves are bitwise
  those of a run without it.
- Under ``torch.profiler`` the ranges nest in the Chrome trace as the
  layers do, and the ranges that moved onto ``trace.span``
  (``ring_topk.fold``, ``gossip.exchange``) still appear.
- ``fgl_train --trace`` prints the spans and the link counters;
  ``launch/profile.py``'s busy time is the union of the kernels' intervals.
- On the card (marker ``cuda``) the kernels' spans carry device time.
"""
import ast
import json
from pathlib import Path

import pytest
import torch

from repro_torch import trace
from repro_torch.core import gossip
from repro_torch.core.baselines import FedSagePlus
from repro_torch.core.partition import partition_graph
from repro_torch.core.spreadfgl import make_fedgl, make_spreadfgl
from repro_torch.core.types import FGLConfig
from repro_torch.data.synthetic_graphs import DATASETS, make_sbm_graph
from repro_torch.launch import fgl_train
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import profile as profile_lib
from repro_torch.tree import tree_leaves

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
IMPUTE_PARTS = ("fgl.impute.embed", "fgl.impute.generator", "fgl.impute.encode",
                "fgl.impute.topk", "fgl.impute.patch")
PARENT = {"fgl.round": None, "fgl.local": "fgl.round", "fgl.impute": "fgl.round",
          "fgl.aggregate": "fgl.round", "fgl.evaluate": "fgl.round",
          **{name: "fgl.impute" for name in IMPUTE_PARTS}}


@pytest.fixture(scope="module")
def batch():
    g = make_sbm_graph(DATASETS["cora"], scale=0.04, seed=1)
    return partition_graph(g, 4, aug_max=3, seed=0)[0]


def _trainer(method, batch, k=1, **kw):
    cfg = FGLConfig(hidden_dim=8, local_rounds=2, imputation_interval=k, top_k_links=2,
                    aug_max=3, ae_iters=1, assessor_iters=1, ae_outer_iters=1, seed=3)
    if method == "SpreadFGL":
        return make_spreadfgl(cfg, batch, num_servers=2, device="cpu", **kw)
    if method == "FedGL":
        return make_fedgl(cfg, batch, device="cpu", **kw)
    return FedSagePlus(cfg, batch, gen_steps=2, device="cpu", **kw)


def _rounds(tr, batch, n):
    state = tr.init(batch)
    for _ in range(n):
        state, _ = tr.step(state)
    return state


def test_off_span_is_one_shared_object_and_records_nothing(batch, monkeypatch):
    trace.drain()
    assert not trace.recording_on()
    assert trace.span("fgl.local") is trace.span("kernel.sim_topk")

    def refused(name):
        raise AssertionError(f"record_function({name!r}) opened with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    _rounds(_trainer("SpreadFGL", batch), batch, 2)
    rec = trace.drain()
    assert rec.spans == [] and rec.counters == {}


def test_no_direct_record_function_left_in_the_port():
    """Every range of the port goes through ``trace.span``."""
    direct = []
    for path in sorted(PORT.rglob("*.py")):
        if path.name == "trace.py" and path.parent == PORT:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute) and node.attr == "record_function":
                direct.append(str(path))
            elif isinstance(node, ast.Name) and node.id == "record_function":
                direct.append(str(path))
            elif isinstance(node, ast.ImportFrom) and any(
                    a.name == "record_function" for a in node.names):
                direct.append(str(path))
    assert not direct, direct


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("method", ["SpreadFGL", "FedGL"])
def test_recorder_sees_each_layer_under_its_parent_and_round(batch, method, k):
    tr = _trainer(method, batch, k=k)
    state = tr.init(batch)
    with trace.recording():
        for _ in range(2):
            state, _ = tr.step(state)
    rec = trace.drain()
    assert trace.drain().spans == []
    for t in range(2):
        got = [(s.name, s.parent) for s in rec.spans if s.round == t]
        # The graph is built by a trainer's first forward and by the first
        # after each imputation, which replaces the batch.
        want = [(n, PARENT[n]) for n in ("fgl.round", "fgl.local")]
        if t == 0:
            want.append(("fgl.graph", "fgl.local"))
        if t % k == 0:
            want += [(n, PARENT[n]) for n in ("fgl.impute", *IMPUTE_PARTS)]
        want += [(n, PARENT[n]) for n in ("fgl.aggregate", "fgl.evaluate")]
        if t % k == 0:
            want.append(("fgl.graph", "fgl.evaluate"))
        assert got == want, (t, got)
    for s in rec.spans:
        assert s.device_ms is None and s.host_end_ns >= s.host_start_ns
    imputed = [t for t in range(2) if t % k == 0]
    assert sorted(rec.counters["fgl.links_wired"]) == imputed


def test_fedsage_imputation_is_one_span(batch):
    tr = _trainer("fedsage_plus", batch)
    with trace.recording():
        _rounds(tr, batch, 1)
    names = [s.name for s in trace.drain().spans]
    assert names == ["fgl.round", "fgl.local", "fgl.graph", "fgl.impute", "fgl.aggregate",
                     "fgl.evaluate", "fgl.graph"]


@pytest.mark.parametrize("method", ["SpreadFGL", "FedGL"])
def test_links_wired_are_the_filled_aug_slots(batch, method):
    tr = _trainer(method, batch)
    state = tr.init(batch)
    with trace.recording():
        new, _ = tr.step(state)
    counters = trace.drain().counters
    wired, proposed = counters["fgl.links_wired"][0], counters["fgl.links_proposed"][0]
    n_local = batch.n_local_max
    filled = float(new.batch.node_mask[:, n_local:].sum())
    assert wired == filled and 0 < wired <= batch.num_clients * batch.aug_max
    assert proposed >= wired


@pytest.mark.parametrize("method", ["SpreadFGL", "FedGL"])
def test_states_bitwise_equal_with_recorder_on_and_off(batch, method):
    off = _rounds(_trainer(method, batch), batch, 3)
    with trace.recording():
        on = _rounds(_trainer(method, batch), batch, 3)
    assert len(trace.drain().spans) > 0
    for field in ("params", "ae_params", "as_params"):
        for a, b in zip(tree_leaves(getattr(off, field)), tree_leaves(getattr(on, field))):
            assert torch.equal(a, b), field
    for a, b in ((off.batch.x, on.batch.x), (off.batch.adj, on.batch.adj),
                 (off.batch.node_mask, on.batch.node_mask)):
        assert torch.equal(a, b)


def test_counters_outside_a_round_and_nested_spans():
    with trace.recording():
        trace.count("c", 2)
        trace.count("c", torch.tensor(3.0))
        with trace.span("fgl.round", round=7):
            with trace.span("inner"):
                trace.count("c", 1)
        with trace.span("after"):
            pass
    rec = trace.drain()
    assert rec.counters == {"c": {None: 5.0, 7: 1.0}}
    assert [(s.name, s.parent, s.round) for s in rec.spans] == [
        ("fgl.round", None, 7), ("inner", "fgl.round", 7), ("after", None, None)]
    trace.count("c", 1)                      # off: nothing kept
    assert trace.drain().counters == {}


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _inside(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_profiler_ranges_nest_as_the_layers(batch, tmp_path):
    tr = _trainer("SpreadFGL", batch, sim_mesh=mesh_lib.make_sim_mesh())
    state = tr.init(batch)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        state, _ = tr.step(state)
        gossip.all_average(state.params, None)
    ann = _annotations(prof, tmp_path)
    by_name = {}
    for e in ann:
        by_name.setdefault(e["name"], []).append(e)
    (rnd,) = by_name["fgl.round"]
    layers = [by_name[n][0] for n in ("fgl.local", "fgl.impute", "fgl.aggregate",
                                      "fgl.evaluate")]
    assert all(_inside(e, rnd) for e in layers)
    assert [e["ts"] for e in layers] == sorted(e["ts"] for e in layers)
    parts = [by_name[n][0] for n in IMPUTE_PARTS]
    assert all(_inside(e, layers[1]) for e in parts)
    assert [e["ts"] for e in parts] == sorted(e["ts"] for e in parts)
    folds = by_name["ring_topk.fold"]
    assert folds and all(_inside(e, by_name["fgl.impute.topk"][0]) for e in folds)
    assert by_name["gossip.exchange"]
    assert not trace.recording_on() and trace.drain().spans == []


def test_fgl_train_trace_prints_spans_and_links(capsys):
    fgl_train.main(["--device", "cpu", "--dataset", "cora", "--scale", "0.04", "--clients", "4",
                    "--servers", "2", "--rounds", "3", "-K", "2", "--local-rounds", "1",
                    "--trace"])
    out = capsys.readouterr().out
    assert "[fgl] span fgl.round: 3 calls, host " in out
    assert "[fgl] span fgl.impute.generator: 2 calls, host " in out
    assert "device n/a ms a round" in out
    assert "[fgl] links per imputation round (2): proposed " in out
    # 8 forwards: 3 rounds of one local step and an evaluation, 2 embeddings;
    # built by the first and after each of the 2 imputations.
    assert "[fgl] classifier graph: built 3, reused 5 (62.5 % of forwards)" in out
    assert not trace.recording_on() and trace.drain().spans == []


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (5, 15)], 15.0),                 # overlap counts once
    ([(0, 10), (2, 4), (10, 12)], 12.0),         # nested, then touching
    ([(20, 25), (0, 10), (8, 9), (30, 31)], 16.0),  # unsorted, with gaps
])
def test_profile_busy_time_is_the_union_of_kernel_intervals(intervals, want):
    assert profile_lib.busy_us(intervals) == want
    assert "fgl." in profile_lib._RANGES and "kernel." in profile_lib._RANGES


@pytest.mark.cuda
def test_kernel_spans_carry_device_time(batch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = FGLConfig(hidden_dim=8, local_rounds=2, imputation_interval=1, top_k_links=2,
                    aug_max=3, ae_iters=1, assessor_iters=1, ae_outer_iters=1, seed=3)
    tr = make_spreadfgl(cfg, batch, num_servers=2, device="cuda")
    state = tr.init(batch)
    state, _ = tr.step(state)                 # builds the kernels
    with trace.recording():
        state, _ = tr.step(state)
    rec = trace.drain()
    by_name = {}
    for s in rec.spans:
        by_name.setdefault(s.name, []).append(s)
    assert {s.parent for s in by_name["kernel.sim_topk"]} == {"fgl.impute.topk"}
    assert "fgl.local" in {s.parent for s in by_name["kernel.sage_aggregate"]}
    assert all(s.device_ms is not None and s.device_ms >= 0 for s in rec.spans)
    (rnd,) = by_name["fgl.round"]
    inner = sum(by_name[n][0].device_ms for n in ("fgl.local", "fgl.impute", "fgl.aggregate",
                                                   "fgl.evaluate"))
    assert 0 < inner <= rnd.device_ms * 1.001
    assert rec.counters["fgl.links_wired"][1] > 0
