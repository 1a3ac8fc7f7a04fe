"""What one step of the port costs, counted while it runs on ``meta`` tensors.

Counterpart of ``repro.roofline.hlo_cost``, which parses the compiled HLO
text of the reference's step with loop multipliers. The port has no HLO: it
runs eagerly, op by op, so its step is counted as it runs. ``count()`` is a
context manager over a step run on ``meta`` tensors (shapes and dtypes, no
data, nothing computed); it counts

- **FLOPs**: every aten op's, by the formulas of ``FlopCounterMode``
  (``torch.utils.flop_counter.flop_registry``: matrix products, dense
  counted in full), plus what the hand-written kernels charge through
  ``kernels.meta`` (their plain versions' products);
- **bytes of the eager program**: every aten op reads its tensor inputs and
  writes its outputs once. Ops that only alias their inputs count zero, as
  the reference's ``_FREE_OPS`` do: views, ``detach``, ``split`` and the
  like, known by their outputs sharing an input's storage (not by a list of
  names), unless the schema's alias annotation says the op writes it (an
  in-place op); so do the ``empty*`` allocations, which write nothing. The
  kernels add their inputs and outputs. This is an upper bound of the HBM traffic:
  eager PyTorch writes every op's result to memory, so each unfused pass
  shows;
- **peak live bytes**: each storage from its creation until it is freed
  (a finalizer on the storage), at the largest sum reached, with the
  tensors the step found alive (``hold``) counted from the start;
- **bytes saved for the backward pass**: the storages autograd packs
  (``saved_tensors_hooks``), each once.

With ``meta_only`` (the dry-run's setting) any tensor on another device
raises, except CPU scalars and empty tensors (constants, and the empty
placeholder ``torch.utils.checkpoint`` makes), so a dry-run never computes
on the CPU by mistake. ``on_op`` sees every op after it ran (the cost
model's hook for tensor-parallel collectives).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Callable, Dict, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import meta

_EMPTY = {"aten::empty", "aten::empty_like", "aten::empty_strided", "aten::new_empty",
          "aten::new_empty_strided"}


@dataclasses.dataclass(eq=False)
class Counter:
    """The counts of one step; ``charge`` is what ``kernels.meta`` calls."""

    attention: Optional[Callable] = None   # replaces the attention kernel (``--attention-impl``)
    on_op: Optional[Callable] = None       # on_op(func, args, kwargs, out) after each op
    flops: float = 0.0
    kernel_flops: float = 0.0
    hbm_bytes: float = 0.0
    kernel_bytes: float = 0.0
    ops: int = 0
    live_bytes: float = 0.0
    peak_bytes: float = 0.0
    saved_bytes: float = 0.0
    _live: Dict[int, float] = dataclasses.field(default_factory=dict)
    _saved: set = dataclasses.field(default_factory=set)
    _open: bool = True

    def charge(self, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.kernel_flops += flops
        self.hbm_bytes += nbytes
        self.kernel_bytes += nbytes

    def hold(self, t: torch.Tensor, share: float = 1.0) -> None:
        """Count ``t``'s storage as live from now on, at ``share`` of its
        bytes (a sharded leaf's stored part of the tensor the local program
        computes with)."""
        self._track(t.untyped_storage(), share)

    def rescale(self, t: torch.Tensor, share: float) -> None:
        """Count an already live storage at ``share`` of its bytes."""
        key = t.untyped_storage()._cdata
        if key in self._live:
            new = t.untyped_storage().nbytes() * share
            self.live_bytes += new - self._live[key]
            self._live[key] = new

    def _track(self, storage, share: float = 1.0) -> None:
        key = storage._cdata
        if key in self._live:
            return
        nbytes = storage.nbytes() * share
        self._live[key] = nbytes
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(storage, self._free, key).atexit = False

    def _free(self, key: int) -> None:
        if self._open:
            self.live_bytes -= self._live.pop(key, 0.0)

    def _pack(self, t: torch.Tensor) -> torch.Tensor:
        key = t.untyped_storage()._cdata
        if key not in self._saved:
            self._saved.add(key)
            self.saved_bytes += t.untyped_storage().nbytes()
        return t


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _hashable(x):
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise TypeError
        return ("T", tuple(x.shape), x.stride(), x.storage_offset(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_hashable(v) for v in x)
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype, torch.device,
                                   torch.memory_format, torch.layout)):
        return (type(x), x)
    raise TypeError


def _signature(func, args, kwargs):
    """A key of the op and its inputs' layouts, or None for ops whose result
    may alias or write an input, or inputs that are not meta tensors or
    plain values."""
    if any(r.alias_info is not None for r in func._schema.returns):
        return None
    try:
        return func, _hashable(args), _hashable(tuple(sorted(kwargs.items())))
    except TypeError:
        return None


def _layout(args, kwargs, out):
    """The outputs' layouts if they are fresh meta tensors, else None."""
    if type(out) not in (torch.Tensor, tuple, list):
        return None
    outs = out if isinstance(out, (tuple, list)) else (out,)
    if not all(isinstance(t, torch.Tensor) and t.device.type == "meta" for t in outs):
        return None
    ins = {t.untyped_storage()._cdata for t in _tensors((args, kwargs))}
    if any(t.untyped_storage()._cdata in ins for t in outs):
        return None
    return (type(out), [(tuple(t.shape), t.stride(), t.dtype) for t in outs])


def _made(layout):
    kind, specs = layout
    ts = [torch.empty_strided(s, st, dtype=dt, device="meta") for s, st, dt in specs]
    return kind(ts) if kind in (tuple, list) else ts[0]


class _Mode(TorchDispatchMode):
    def __init__(self, counter: Counter, meta_only: bool):
        super().__init__()
        self.counter, self.meta_only = counter, meta_only
        # Output layouts by op and input layouts: a meta op's result depends on
        # nothing else, and PyTorch computes many in Python (its refs), so a
        # loop's steps reuse the first step's.
        self.outputs: Dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = _signature(func, args, kwargs) if self.meta_only else None
        layout = self.outputs.get(key) if key is not None else None
        if layout is not None:
            out = _made(layout)
        else:
            out = func(*args, **kwargs)
            if key is not None and key not in self.outputs:
                self.outputs[key] = _layout(args, kwargs, out)
        c = self.counter
        c.ops += 1
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if self.meta_only:
            for t in ins + outs:
                if t.device.type != "meta" and t.numel() > 1:
                    raise RuntimeError(f"step_cost: {func} met a tensor on {t.device}; a "
                                       f"dry-run builds only meta tensors")
        packet = func._overloadpacket
        if packet in flop_registry:
            c.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        schema = func._schema
        writes = any(r.alias_info is not None and r.alias_info.is_write for r in schema.returns)
        inputs = {t.untyped_storage()._cdata for t in ins}
        fresh = [t for t in outs if t.untyped_storage()._cdata not in inputs]
        if schema.name not in _EMPTY and (fresh or writes):
            seen = {id(t): t for t in ins}
            c.hbm_bytes += sum(_nbytes(t) for t in seen.values()) + sum(
                _nbytes(t) for t in outs)
        for t in fresh:
            c._track(t.untyped_storage())
        if c.on_op is not None:
            c.on_op(func, args, kwargs, out)
        return out


@contextlib.contextmanager
def count(*, meta_only: bool = True, attention: Optional[Callable] = None,
          on_op: Optional[Callable] = None, hold=()) -> Iterator[Counter]:
    """Count the ops run inside; ``hold``: tensors alive before the step (or
    ``(tensor, share)`` pairs), counted as live from the start."""
    c = Counter(attention=attention, on_op=on_op)
    for item in hold:
        t, share = item if isinstance(item, tuple) else (item, 1.0)
        c.hold(t, share)
    meta.counters.append(c)
    try:
        with torch.autograd.graph.saved_tensors_hooks(c._pack, lambda t: t), \
                _Mode(c, meta_only):
            yield c
    finally:
        meta.counters.remove(c)
        c._open = False
