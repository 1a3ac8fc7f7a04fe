"""The port's own spans and counters, off unless a profiler or the recorder asks.

  with trace.span("fgl.local"):
      ...                                   # a layer of the round
  trace.count("fgl.links_wired", ok.sum())  # only where trace.recording_on()

  with trace.recording():
      state, _ = trainer.step(state)
  rec = trace.drain()      # rec.spans: [Record], rec.counters: {name: {round: value}}

A span costs one flag check while nothing listens: :func:`span` then returns
one shared no-op context. Under ``torch.profiler`` it also opens
``torch.profiler.record_function(name)``, so the range sits on the
profiler's timeline beside the kernels it launched. Inside
:func:`recording` it appends a :class:`Record` to an in-memory list: its
name, the span open when it began (``parent``), the round that the
enclosing ``fgl.round`` span set, its host interval
(``time.perf_counter_ns``) and, where CUDA is initialised, two timing
events recorded on the current stream at entry and exit. :func:`drain`
synchronises once and gives each record ``device_ms``, the events' elapsed
time: the device's own time from the stream reaching the span to its
finishing the span's work, busy and idle alike (``None`` on the CPU).

Counters (:func:`count`) add up only while the recorder is on, and a
device tensor stays on the device until :func:`drain`; a call site computes
its value only when :func:`recording_on` is true, so nothing is launched
or synchronised with tracing off. Spans nest on one thread.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


@dataclasses.dataclass
class Record:
    """One span as the recorder saw it."""

    name: str
    parent: Optional[str]
    round: Optional[int]
    host_start_ns: int
    host_end_ns: int = 0
    device_ms: Optional[float] = None
    events: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def host_ms(self) -> float:
        return (self.host_end_ns - self.host_start_ns) * 1e-6


@dataclasses.dataclass
class Recording:
    """What :func:`drain` returns: the spans in the order they began, and
    each counter's sum per round (``None``: counted outside any round)."""

    spans: List[Record]
    counters: Dict[str, Dict[Optional[int], float]]


class _Recorder:
    def __init__(self, events: bool):
        self.events = events
        self.spans: List[Record] = []
        self.counts: Dict[str, Dict[Optional[int], list]] = {}
        self.open: List[Record] = []
        self.round: Optional[int] = None


_recorder: Optional[_Recorder] = None   # the recorder while on
_pending: List[_Recorder] = []          # recorders not yet drained


def recording_on() -> bool:
    """True inside :func:`recording`."""
    return _recorder is not None


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record every span and counter of the block, with CUDA timing events
    at each span's ends where CUDA is initialised."""
    global _recorder
    events = torch.cuda.is_available() and torch.cuda.is_initialized()
    outer, _recorder = _recorder, _Recorder(events)
    _pending.append(_recorder)
    try:
        yield
    finally:
        _recorder = outer


def drain() -> Recording:
    """The records and counters of every :func:`recording` block since the
    last drain, after one synchronisation of the device."""
    recs = list(_pending)
    _pending.clear()
    if any(r.events and r.spans for r in recs):
        torch.cuda.synchronize()
    spans: List[Record] = []
    counters: Dict[str, Dict[Optional[int], float]] = {}
    for r in recs:
        for s in r.spans:
            if s.events is not None:
                s.device_ms = float(s.events[0].elapsed_time(s.events[1]))
                s.events = None
            spans.append(s)
        for name, by_round in r.counts.items():
            out = counters.setdefault(name, {})
            for rnd, values in by_round.items():
                out[rnd] = out.get(rnd, 0.0) + sum(float(v) for v in values)
    return Recording(spans=spans, counters=counters)


def count(name: str, value) -> None:
    """Add ``value`` (a number or a device tensor) to counter ``name`` of the
    current round, while the recorder is on."""
    rec = _recorder
    if rec is None:
        return
    if isinstance(value, torch.Tensor):
        value = value.detach()
    rec.counts.setdefault(name, {}).setdefault(rec.round, []).append(value)


class _Span:
    __slots__ = ("name", "round", "rf", "record", "outer_round")

    def __init__(self, name: str, round: Optional[int]):
        self.name, self.round = name, round
        self.rf = self.record = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        rec = _recorder
        if rec is not None:
            self.outer_round = rec.round
            if self.round is not None:
                rec.round = self.round
            r = Record(self.name, rec.open[-1].name if rec.open else None, rec.round,
                       time.perf_counter_ns())
            if rec.events:
                r.events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                r.events[0].record()
            rec.spans.append(r)
            rec.open.append(r)
            self.record = (rec, r)
        return self

    def __exit__(self, *exc):
        if self.record is not None:
            rec, r = self.record
            if r.events is not None:
                r.events[1].record()
            r.host_end_ns = time.perf_counter_ns()
            rec.open.pop()
            rec.round = self.outer_round
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, *, round: Optional[int] = None):
    """A context for the layer ``name``; ``round`` (given by ``fgl.round``)
    is shared by every span opened inside it."""
    if _recorder is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, round)
