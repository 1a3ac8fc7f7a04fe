"""``generator_ms`` and the span reading it stands on.

- The reader on a synthetic context gives known numbers, and nothing where
  the span or an imputation round is missing.
- Its span is wired into a traced run of each cell, one call an imputation
  round, at the program's ``fgl.impute.generator`` boundary.
- ``trace.read`` gives fixed fields for a fixed event list: busy time as
  the union of device operations, device time by span through the launch's
  correlation id, the operations by time, the idle gaps by host event, and
  the operations no launch accounts for."""
import json
import time
from pathlib import Path

import pytest

from portbench import harness, trace
from portbench.tests import tiny

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
WORKLOADS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _reader():
    return harness.load_module(HERE / "metrics" / "generator_ms.py")


def _ctx(device_s, flags):
    spans = {"generator": [trace.Span("generator", i, (), device_s=d)
                           for i, d in enumerate(device_s)]} if device_s else {}
    return {"trace": trace.Trace(spans=spans, busy_s=0.0, window_s=1.0, device_ops=[],
                                 idle_gaps=[], unattributed=0),
            "trace_flags": flags}


def test_generator_ms_reads_device_time_per_imputation_round():
    read = _reader().read
    assert read(_ctx([0.080, 0.070], [True, False, False, False, False] * 2)) == \
        pytest.approx(75.0)
    assert read(_ctx([0.09], [True, False, False])) == pytest.approx(90.0)
    assert read(_ctx([], [True, False])) is None               # no such span
    assert read(_ctx([0.0], [True])) is None                   # no device time (CPU)
    assert read(_ctx([0.05], [False, False])) is None          # no imputation round


@pytest.mark.parametrize("workload", WORKLOADS)
def test_generator_span_is_wired_into_the_traced_run(workload):
    cell = tiny.cell(workload)
    readers = cell.readers(trace=True)
    assert "generator_ms" in readers
    ctx = cell.driver.run(cell, seed=31, seconds=0.2, trace=True, device="cpu",
                     start=time.perf_counter(), readers=readers)
    gen = ctx["trace"].spans["generator"]
    assert len(gen) == sum(ctx["trace_flags"]) == len(ctx["trace"].spans["impute"])
    for g, imp in zip(gen, ctx["trace"].spans["impute"]):
        assert imp.start <= g.start < g.end <= imp.end
    assert readers["generator_ms"].read(ctx) is None           # the CPU has no device time


class _FixedProfile:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        Path(path).write_text(json.dumps({"traceEvents": self.events}))


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


EVENTS = [
    _x("user_annotation", "pb.impute#0", 0, 100),
    _x("user_annotation", "pb.generator#1", 10, 40),
    _x("cpu_op", "aten::mm", 12, 5),
    _x("cuda_runtime", "cudaLaunchKernel", 14, 2, correlation=1),
    _x("cuda_runtime", "cudaLaunchKernel", 60, 2, correlation=2),
    _x("cuda_driver", "cuLaunchKernel", 120, 2, correlation=3),
    _x("kernel", "gemm", 20, 30, correlation=1),
    _x("kernel", "gemm", 40, 20, correlation=2),                # overlaps the first
    _x("kernel", "topk", 130, 10, correlation=3),               # launched after both spans
    _x("gpu_memcpy", "Memcpy HtoD", 200, 5, correlation=99),    # no launch seen
    _x("gpu_memcpy", "Memcpy DtoH", 300, 1),                     # no correlation at all
    _x("python_function", "step", 55, 100),
]


def test_trace_read_fields_on_a_fixed_event_list():
    calls = [trace.Span("impute", 0, ()), trace.Span("generator", 1, ())]
    t = trace.read(_FixedProfile(EVENTS), calls, window_s=0.5)
    assert (calls[0].start, calls[0].end, calls[1].start, calls[1].end) == (0, 100, 10, 50)
    assert calls[0].device_s == pytest.approx(50e-6)           # both gemms
    assert calls[1].device_s == pytest.approx(30e-6)           # the first gemm alone
    assert t.busy_s == pytest.approx((40 + 10 + 5 + 1) * 1e-6)  # union: 20-60, 130-140, ...
    assert t.window_s == 0.5 and t.unattributed == 2
    assert t.spans == {"impute": [calls[0]], "generator": [calls[1]]}
    assert [n for n, _ in t.device_ops] == ["gemm", "topk", "Memcpy HtoD", "Memcpy DtoH"]
    assert t.device_ops[0][1] == pytest.approx(50e-6)
    gaps = dict(t.idle_gaps)
    # 60-130: the widest open events tie, the earlier wins; 140-200: only "step".
    assert gaps == pytest.approx({"pb.impute": 70e-6, "step": 60e-6,
                                  "(no host event)": 95e-6})
