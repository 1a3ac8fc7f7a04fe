"""Roofline terms of one device's step on the H100: counterpart of ``repro.roofline.analysis``.

Three terms per (arch x shape x mesh), in seconds, from ``roofline.hw``:

  compute    = FLOPs / bf16 peak
  memory     = bytes of the eager program / HBM bandwidth
  collective = sum over mesh axes of that axis's bytes / its link's bandwidth

FLOPs and bytes are one device's, counted while the port's own step runs
at the local program's shapes on ``meta`` tensors (``roofline.step_cost``,
``sharding.specs.local_program``): the eager ops, plus the hand-written
kernels charged their own work. ``memory_per_device`` is the counted peak
of live bytes, with parameters, their gradients, Adam's moments and the
decode cache at their stored (sharded) share, plus the largest layer's
gathered weights.

The collectives are those of the scheme ``sharding.rules`` encodes, each
sized from local shapes, as bytes one device sends (a ring all-reduce of X
bytes over n devices sends 2 (n-1)/n X; an all-gather to X, a reduce-scatter
from X and an all-to-all of X each (n-1)/n X):

- FSDP all-gathers of ``embed``-sharded weights over ``data`` before use
  (again in the backward pass), and reduce-scatters of their gradients;
  weights the local program computes whole though ``model`` shards them
  (heads that do not divide the axis, the xLSTM mixers) are gathered over
  ``model`` the same way;
- the gradient all-reduce of the other leaves over ``data``, then ``pod``;
- tensor-parallel all-reduces of every product that contracts a dim split
  over ``model`` (the attention-out and MLP-down products forward, the
  q/kv/up projections' input gradients backward, the vocab-parallel
  embedding lookup): seen in the trace (``on_op``), so each is sized by the
  activation it reduces. Under ``seq_parallel_activations`` the same bytes
  move as an all-gather and a reduce-scatter;
- the vocab-parallel loss's row statistics, and the all-gather of logits
  from prefill and decode;
- expert parallelism's all-to-alls (tokens to their experts' devices and
  back) when ``experts`` shard over ``model``;
- in decode, the combine of the sequence-sharded cache's partial attention.

The reference's ``collective_bytes(hlo_text)``, which parses collectives out
of XLA's post-SPMD HLO, has no counterpart: the port has no HLO to parse.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import InputShape
from repro_torch.models import decoding
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adam import Adam
from repro_torch.roofline import hw, step_cost
from repro_torch.sharding import constraints, rules, specs
from repro_torch.train import step as train_step

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_aten = torch.ops.aten
_PRODUCTS = {_aten.mm: (0, 1), _aten.bmm: (0, 1), _aten.addmm: (1, 2), _aten.baddbmm: (1, 2)}


@dataclasses.dataclass
class RooflineRecord:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float                 # one device's FLOPs
    hbm_bytes: float             # one device's bytes of the eager program
    coll_bytes: Dict[str, float]  # one device's collective bytes by kind
    model_flops: float           # analytic 6 N_active D (global)
    memory_per_device: Optional[float] = None
    axis_bytes: Optional[Dict[str, float]] = None    # collective bytes by mesh axis
    axis_bw: Optional[Dict[str, float]] = None       # each axis's link, bytes/s
    hw: str = hw.NAME
    extra: Optional[Dict[str, Any]] = None

    @property
    def coll_total(self) -> float:
        return sum(self.coll_bytes.values())

    @property
    def compute_s(self) -> float:
        return self.flops / hw.PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / hw.HBM_BW

    @property
    def axis_seconds(self) -> Dict[str, float]:
        return {a: b / self.axis_bw[a] for a, b in (self.axis_bytes or {}).items()}

    @property
    def collective_s(self) -> float:
        return sum(self.axis_seconds.values())

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs (per-device comparison)."""
        if self.flops <= 0:
            return 0.0
        return (self.model_flops / self.chips) / self.flops

    def to_json(self) -> Dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh, "hw": self.hw,
            "chips": self.chips, "flops": self.flops,
            "hbm_bytes": self.hbm_bytes, "coll_bytes": self.coll_bytes,
            "coll_total": self.coll_total, "axis_bytes": self.axis_bytes,
            "axis_seconds": self.axis_seconds, "model_flops": self.model_flops,
            "memory_per_device": self.memory_per_device,
            "fits_hbm": (self.memory_per_device or 0) <= hw.HBM_BYTES,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "extra": self.extra or {},
        }


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """Analytic 6·N·D (training) / 2·N·D (inference), N = active params."""
    n = cfg.active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch      # decode: one token per sequence


class _Ledger:
    """Collective bytes one device sends, by kind and by mesh axis."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.kinds = {k: 0.0 for k in _COLLECTIVES}
        self.axes = {a: 0.0 for a in mesh.shape}

    def n(self, axis: str) -> int:
        return int(self.mesh.shape.get(axis, 1))

    def add(self, kind: str, axis: str, nbytes: float) -> None:
        if nbytes > 0 and self.n(axis) > 1:
            self.kinds[kind] += nbytes
            self.axes[axis] += nbytes

    def all_reduce(self, axis: str, x: float) -> None:
        n = self.n(axis)
        self.add("all-reduce", axis, 2.0 * (n - 1) / n * x)


class _TensorParallel:
    """``on_op``: the collectives of products with a weight split over
    ``model``, sized from the activations the trace shows."""

    def __init__(self, prog: specs.LocalProgram, ledger: _Ledger, seq_parallel: bool):
        self.ledger, self.seq_parallel = ledger, seq_parallel
        self.by_storage = {p.untyped_storage()._cdata: (p, prog.leaves[name])
                           for name, p in prog.model.named_parameters()}

    def _leaf(self, t):
        if not isinstance(t, torch.Tensor):
            return None, None
        return self.by_storage.get(t.untyped_storage()._cdata, (None, None))

    def _reduce(self, x: float) -> None:
        if self.seq_parallel:       # the residual stream sharded over its sequence
            n = self.ledger.n("model")
            self.ledger.add("all-gather", "model", (n - 1) / n * x)
            self.ledger.add("reduce-scatter", "model", (n - 1) / n * x)
        else:
            self.ledger.all_reduce("model", x)

    def __call__(self, func, args, kwargs, out) -> None:
        if func._overloadpacket is _aten.index and args[0].ndim >= 2:
            p, leaf = self._leaf(args[0])
            if leaf is not None and leaf.tp_dim == -args[0].ndim:
                self._reduce(_nbytes(out))      # vocab-parallel lookup
            return
        pos = _PRODUCTS.get(func._overloadpacket)
        if pos is None:
            return
        operands = [args[i] for i in pos]
        for side, t in enumerate(operands):
            p, leaf = self._leaf(t)
            if leaf is None:
                continue
            plain = (tuple(t.shape[-2:]) == tuple(p.shape[-2:])
                     and tuple(t.stride()[-2:]) == tuple(p.stride()[-2:]))
            # the weight dim this operand contracts: a's last, b's second last
            contracted = (-1 if plain else -2) if side == 0 else (-2 if plain else -1)
            if leaf.expert_parallel:
                name = leaf.name.rsplit(".", 1)[-1]
                if name == "w_up":         # tokens to their experts' devices, and back
                    self.ledger.add("all-to-all", "model", (1 - 1 / self.ledger.n("model"))
                                    * _nbytes(operands[0] if plain else out))
                elif name == "w_down":
                    self.ledger.add("all-to-all", "model", (1 - 1 / self.ledger.n("model"))
                                    * _nbytes(out if plain else operands[0]))
            elif leaf.tp_dim is not None and leaf.tp_dim == contracted:
                self._reduce(_nbytes(out))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _param_collectives(prog: specs.LocalProgram, kind: str, ledger: _Ledger,
                       microbatch: int, seq_parallel: bool) -> None:
    """FSDP gathers and, in training, the gradient reductions of every leaf."""
    m = ledger.n("model")
    for leaf in prog.leaves.values():
        size = leaf.nbytes(leaf.stored)
        for axis in ("data", "model"):
            f = leaf.gather.get(axis)
            if f:
                ledger.add("all-gather", axis, (2 if kind == "train" else 1) * (f - 1) * size)
                size *= f
        if kind != "train":
            continue
        x = leaf.nbytes(leaf.compute) * (2 if microbatch > 1 and leaf.dtype != torch.float32
                                         else 1) / (m if leaf.expert_parallel else 1)
        f = leaf.gather.get("model")
        if f:
            ledger.add("reduce-scatter", "model", (f - 1) / f * x)
            x /= f
        elif seq_parallel and leaf.tp_dim is None and not leaf.expert_parallel:
            ledger.all_reduce("model", x)
        f = leaf.gather.get("data")
        if f:
            ledger.add("reduce-scatter", "data", (f - 1) / f * x)
            x /= f
        else:
            ledger.all_reduce("data", x)
            x /= ledger.n("data")
        ledger.all_reduce("pod", x)


def _gathered_layer_bytes(prog: specs.LocalProgram) -> float:
    """The most bytes one layer's gathered weights add over their stored shards."""
    per: Dict[str, float] = {}
    for leaf in prog.leaves.values():
        if leaf.gather:
            layer = re.match(r"(.*?\.\d+)\.", leaf.name)      # blocks.3, encoder.blocks.3
            key = layer.group(1) if layer else leaf.name.split(".")[0]
            per[key] = per.get(key, 0.0) + leaf.nbytes(leaf.compute) - leaf.nbytes(leaf.stored)
    return max(per.values(), default=0.0)


def analyze(cfg: ModelConfig, shape: InputShape, mesh, *, arch: Optional[str] = None,
            microbatch: int = 1, attention=None,
            extra: Optional[Dict[str, Any]] = None) -> RooflineRecord:
    """Count one device's step of ``cfg`` at ``shape`` on ``mesh``: a
    training step (``train/step.py``'s ``make_train_step``, the port's Adam,
    remat as the config says), a prefill (``decoding.prefill``) or one decode
    step (``decoding.decode_step`` after a full context). ``attention``
    replaces the attention kernel on meta tensors (``kernels.meta``)."""
    prog = specs.local_program(cfg, shape, mesh)
    ledger = _Ledger(mesh)
    model, b, s = prog.model, prog.batch, shape.seq_len
    batch = {k: torch.empty(rules.local_shape(shp, spec, mesh), dtype=dt, device="meta")
             for k, (shp, dt, spec) in specs.batch_specs(cfg, shape, mesh).items()}
    memory = batch.get("memory")
    held = [(t, 1.0) for t in batch.values()] if shape.kind != "decode" else []
    hook = _TensorParallel(prog, ledger, cfg.seq_parallel_activations)
    shares = {name: leaf.share for name, leaf in prog.leaves.items()}
    if shape.kind == "train":
        opt = Adam(lr=1e-4, clip_norm=1.0)
        state = train_step.init_state(prog.local, opt, model=model)
        step = train_step.make_train_step(prog.local, opt, microbatch=microbatch)
        for name, p in model.named_parameters():
            held += [(p, shares[name]), (state.opt_state.mu[name], shares[name]),
                     (state.opt_state.nu[name], shares[name])]
        with step_cost.count(attention=attention, on_op=hook, hold=held) as c:
            hooks = [p.register_hook(lambda g, share=shares[name]: c.rescale(g, share))
                     for name, p in model.named_parameters()]
            try:
                step(state, batch)
            finally:
                for h in hooks:
                    h.remove()
    else:
        held += [(p, shares[name]) for name, p in model.named_parameters()]
        if shape.kind == "prefill":
            run = lambda: decoding.prefill(model, batch["tokens"], memory=memory)  # noqa: E731
        else:
            cache, cache_held = specs.local_cache(prog, shape, mesh)
            held += cache_held
            token = torch.empty((b, 1), dtype=torch.int32, device="meta")
            held.append((token, 1.0))
            run = lambda: decoding.decode_step(model, cache, token)  # noqa: E731
        with torch.no_grad(), step_cost.count(attention=attention, on_op=hook,
                                              hold=held) as c:
            run()
    _param_collectives(prog, shape.kind, ledger, microbatch, cfg.seq_parallel_activations)
    m = ledger.n("model")
    v_local = prog.local.vocab_size
    logits = (shape.global_batch, s if shape.kind == "train" else 1, cfg.vocab_size)
    if constraints.activation_spec(logits, ("batch", None, "vocab"), mesh)[2] == "model":
        if shape.kind == "train":      # max, sum of exp and the target's logit, per row
            ledger.all_reduce("model", 3 * b * s * 4)
        else:
            ledger.add("all-gather", "model", (m - 1) * b * v_local * 4)
    if shape.kind == "decode":
        full = specs.cache_specs(cfg, shape, mesh)
        for entry in full["layers"]:
            if "k" in entry and entry["k"][2][2] == "model":
                ledger.all_reduce("model", b * cfg.num_heads * (cfg.head_dim + 2) * 4)
    record_extra = dict(extra or {})
    record_extra.update(
        ops=c.ops, kernel_flops=c.kernel_flops, kernel_bytes=c.kernel_bytes,
        saved_bytes=c.saved_bytes, local_batch=b,
        local_config={k: getattr(prog.local, k) for k in
                      ("num_heads", "num_kv_heads", "d_ff", "vocab_size", "num_experts")},
        gathered_layer_bytes=_gathered_layer_bytes(prog),
        links={a: mesh.links[a][0] for a in mesh.shape})
    return RooflineRecord(
        arch=arch or cfg.name, shape=shape.name, mesh=mesh.name, chips=mesh.chips,
        flops=c.flops, hbm_bytes=c.hbm_bytes, coll_bytes=ledger.kinds,
        model_flops=model_flops(cfg, shape),
        memory_per_device=c.peak_bytes + record_extra["gathered_layer_bytes"],
        axis_bytes=ledger.axes, axis_bw={a: mesh.links[a][1] for a in mesh.shape},
        extra=record_extra)
