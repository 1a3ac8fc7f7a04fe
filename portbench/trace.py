"""Spans around the port's calls, and the device time the profiler saw in them.

The benchmark records its spans from its own files: :func:`wrapped` swaps a
module attribute or a class's method for one that runs the original inside
``torch.profiler.record_function("pb.<span>#<i>")`` and notes the call's
tensor shapes, and puts the original back on exit. Nothing of the port is
edited. :func:`read` parses the profiler's Chrome trace: each device
operation is given to the spans whose host interval holds the host call
that launched it (runtime or driver launch, joined by the correlation id),
and the device's busy time is the union of the operations' intervals, so
that overlapping kernels count once.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib
import json
import os
import re
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_SPAN = re.compile(r"^pb\.(?P<name>[^#]+)#(?P<i>\d+)$")


@dataclasses.dataclass
class Span:
    name: str
    i: int
    shapes: Tuple
    start: float = 0.0       # host interval, µs on the trace's clock
    end: float = 0.0
    device_s: float = 0.0    # device time of the operations launched inside


@dataclasses.dataclass
class Trace:
    spans: Dict[str, List[Span]]
    busy_s: float
    window_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    unattributed: int


def _resolve(target: str):
    """``"pkg.module:Class.attr"`` -> (owner object, attribute name)."""
    mod, _, path = target.partition(":")
    owner = importlib.import_module(mod)
    *parents, attr = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, attr


def _shapes(args) -> Tuple:
    return tuple(tuple(a.shape) if isinstance(a, torch.Tensor) else None for a in args)


@contextlib.contextmanager
def wrapped(targets: Dict[str, str], calls: List[Span]):
    """Within the block, every call of each ``targets[span]`` runs inside a
    ``pb.<span>#<i>`` range and appends a :class:`Span` to ``calls``."""
    saved = []
    try:
        for name, target in targets.items():
            owner, attr = _resolve(target)
            orig = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)

            def wrapper(*args, __orig=orig, __name=name, **kw):
                span = Span(__name, len(calls), _shapes(args))
                calls.append(span)
                with torch.profiler.record_function(f"pb.{__name}#{span.i}"):
                    return __orig(*args, **kw)

            saved.append((owner, attr, orig))
            setattr(owner, attr, wrapper)
        yield calls
    finally:
        for owner, attr, orig in reversed(saved):
            setattr(owner, attr, orig)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def read(prof, calls: Sequence[Span], window_s: float, top: int = 10) -> Trace:
    """Device time by span, busy time and the breakdown of ``prof``'s trace."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    by_key = {(s.name, s.i): s for s in calls}
    launch_ts: Dict[int, float] = {}
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch_ts[e["args"]["correlation"]] = float(e["ts"])
        elif cat in ("user_annotation", "cpu_op", "python_function"):
            host.append(e)
            m = _SPAN.match(e.get("name", ""))
            if cat == "user_annotation" and m:
                span = by_key.get((m["name"], int(m["i"])))
                if span is not None:
                    span.start, span.end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
    timed = [s for s in calls if s.end > s.start]
    starts = sorted((s.start, k) for k, s in enumerate(timed))
    unattributed = 0
    op_time: Dict[str, float] = {}
    for e in device:
        dur = float(e["dur"]) * 1e-6
        op_time[e["name"]] = op_time.get(e["name"], 0.0) + dur
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        if ts is None:
            unattributed += 1
            continue
        hi = bisect.bisect_right(starts, (ts, len(timed)))
        for _, k in starts[:hi]:
            if timed[k].end >= ts:
                timed[k].device_s += dur
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device])
    gaps = _gaps(busy, host)
    spans: Dict[str, List[Span]] = {}
    for s in calls:
        spans.setdefault(s.name, []).append(s)
    return Trace(spans=spans, busy_s=sum(b - a for a, b in busy) * 1e-6, window_s=window_s,
                 device_ops=sorted(op_time.items(), key=lambda kv: -kv[1])[:top],
                 idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:top],
                 unattributed=unattributed)


def _gaps(busy: List[Tuple[float, float]], host: List[dict]) -> Dict[str, float]:
    """Idle seconds between device operations, summed by the innermost host
    event (a span, an aten op or a Python frame) open where each gap begins."""
    host = sorted(host, key=lambda e: float(e["ts"]))
    host_ts = [float(e["ts"]) for e in host]
    out: Dict[str, float] = {}
    for (_, a), (b, _) in zip(busy[:-1], busy[1:]):
        if b <= a:
            continue
        name = "(no host event)"
        best: Optional[float] = None
        for e in host[:bisect.bisect_right(host_ts, a)][-2000:]:
            end = float(e["ts"]) + float(e["dur"])
            if end >= a and (best is None or float(e["dur"]) < best):
                best, name = float(e["dur"]), _SPAN.sub(r"pb.\g<name>", e["name"])
        out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    return out
