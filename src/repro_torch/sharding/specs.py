"""Meta builds and specs of the parameters, optimizer state, batch and cache.

Counterpart of ``repro.sharding.specs``: everything here is allocation-free.
Where the reference builds trees of ``ShapeDtypeStruct`` with
``jax.eval_shape`` and attaches ``NamedSharding``\\ s, the port builds its own
modules and tensors on PyTorch's ``meta`` device and gives each leaf a spec
(``sharding.rules``) and its **local shape**, one device's share. Adam's
moments take their parameter's spec.

Cache sharding, as ``_cache_entry_sharding``: the k/v caches shard their
sequence dim over ``model`` (the GQA configs' kv heads are fewer than the
axis and would replicate a multi-GB cache per device); a mamba state shards
its inner dim; the mLSTM state and the rest only their batch.

:func:`local_program` is what one device runs: the model built from the
**local config** (per-device q and kv heads, d_ff, vocab; the batch split
over ``(pod, data)``), so the step the cost model counts is the port's own
code at local shapes. Weights' ``embed`` dims (FSDP over ``data``) are
gathered before use, so their compute shapes are the tensor-parallel ones.
Per leaf it records the stored shape, the compute shape and what the
difference costs: the factor gathered over each axis, or expert parallelism
(``experts`` over ``model``: the local program routes its tokens over all
experts, the same products as the experts of one device on every device's
tokens, with all-to-alls in place of a gather).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs import InputShape
from repro_torch.models import decoding, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import rules

Spec = Tuple


def _collapse(axes: Tuple[str, ...]):
    return axes if len(axes) > 1 else axes[0]


def _batch_spec(mesh, batch: int):
    axes = rules.batch_axes(mesh)
    if axes and batch % rules.axis_size(mesh, axes) == 0:
        return _collapse(axes)
    return None


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Every parameter's (shape, dtype) at full size, from a meta build."""
    model = transformer.Transformer(cfg, device="meta")
    return {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}


def param_specs(cfg: ModelConfig, mesh) -> Dict[str, Spec]:
    shapes = {n: s for n, (s, _) in param_shapes(cfg).items()}
    return rules.spec_tree(transformer.model_axes(cfg), shapes, mesh)


def memory_shape(cfg: ModelConfig, batch: int) -> Optional[Tuple[int, int, int]]:
    """The vlm's image memory or whisper's frames of a batch, or None."""
    if cfg.is_encdec:
        return (batch, cfg.encoder_seq, cfg.d_model)
    if cfg.cross_attn_interval:
        return (batch, cfg.num_image_tokens, cfg.d_model)
    return None


def batch_specs(cfg: ModelConfig, shape: InputShape, mesh) -> Dict[str, Tuple]:
    """Training / prefill batch: ``{name: (shape, dtype, spec)}``, tokens and
    the modality's memory (in the model's dtype, as the reference's stub)."""
    b, s = shape.global_batch, shape.seq_len
    ba = _batch_spec(mesh, b)
    out = {"tokens": ((b, s), torch.int32, (ba, None))}
    mem = memory_shape(cfg, b)
    if mem is not None:
        out["memory"] = (mem, getattr(torch, cfg.dtype), (ba, None, None))
    return out


def cache_entry_spec(entry: Dict[str, Tuple[int, ...]], mesh, batch: int) -> Dict[str, Spec]:
    """``_cache_entry_sharding``'s decisions for one layer's cache entry."""
    ba = _batch_spec(mesh, batch)
    m = mesh.shape.get("model")
    out = {}
    for key, s in entry.items():
        if key in ("k", "v"):
            out[key] = (ba, None, "model" if m and s[2] % m == 0 else None, None)
        elif key == "h" and len(s) == 3:      # mamba state [B, di, n]
            out[key] = (ba, "model" if m and s[1] % m == 0 else None, None)
        elif key == "c" and len(s) == 4:      # mlstm state [B, H, Dh, Dh]
            out[key] = (ba, None, None, None)
        else:
            out[key] = (ba,) + (None,) * (len(s) - 1)
    return out


def cache_specs(cfg: ModelConfig, shape: InputShape, mesh) -> Dict:
    """The decode cache of ``shape`` (``decoding.init_cache`` on meta):
    ``{"layers": [{key: (shape, dtype, spec)}], "memory": (...)}``."""
    b, s = shape.global_batch, shape.seq_len
    mem = memory_shape(cfg, b)
    memory = (torch.empty(mem, dtype=getattr(torch, cfg.dtype), device="meta")
              if mem is not None else None)
    cache = decoding.init_cache(cfg, b, s, device="meta", memory=memory)
    layers = []
    for entry in cache["layers"]:
        specs = cache_entry_spec({k: tuple(t.shape) for k, t in entry.items()}, mesh, b)
        layers.append({k: (tuple(t.shape), t.dtype, specs[k]) for k, t in entry.items()})
    out = {"layers": layers}
    if mem is not None:
        out["memory"] = (mem, memory.dtype, (_batch_spec(mesh, b), None, None))
    return out


# ---------------------------------------------------------------------------
# The local program
# ---------------------------------------------------------------------------

def _kv_needed(hq: int, hkv: int, m: int) -> int:
    """kv heads one device's ``hq / m`` q heads read (the most any device
    reads), rounded up to a divisor of its q heads."""
    local, group = hq // m, hq // hkv
    need = max(len({h // group for h in range(i * local, (i + 1) * local)}) for i in range(m))
    return next(k for k in range(need, local + 1) if local % k == 0)


def local_config(cfg: ModelConfig, mesh) -> ModelConfig:
    """The config of one device's program: q heads, kv heads (those its q
    heads need), d_ff and vocab divided over ``model`` where they divide;
    MoE experts stay whole (expert parallelism, see the module note)."""
    m = int(mesh.shape.get("model", 1))
    kw = {"head_dim": cfg.head_dim}
    if m > 1 and cfg.arch_type != "ssm" and cfg.num_heads % m == 0:
        kw.update(num_heads=cfg.num_heads // m,
                  num_kv_heads=(cfg.num_kv_heads // m if cfg.num_kv_heads % m == 0 else
                                _kv_needed(cfg.num_heads, cfg.num_kv_heads, m)))
    if not (cfg.is_moe and cfg.num_experts % m == 0) and cfg.d_ff % m == 0:
        kw["d_ff"] = cfg.d_ff // m
    if cfg.vocab_size % m == 0:
        kw["vocab_size"] = cfg.vocab_size // m
    return dataclasses.replace(cfg, **kw)


def local_batch(shape: InputShape, mesh) -> int:
    """Sequences per device: the batch split over ``(pod, data)`` where it
    divides, as the batch spec; all of it otherwise."""
    b = shape.global_batch
    return b // rules.axis_size(mesh, _batch_spec(mesh, b))


@dataclasses.dataclass
class Leaf:
    """One parameter: full shape, spec, stored (local) shape, the shape the
    local program computes with, and per mesh axis the factor it is
    gathered by before use (1: used as stored)."""

    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Spec
    stored: Tuple[int, ...]
    compute: Tuple[int, ...]
    gather: Dict[str, int]
    expert_parallel: bool = False
    tp_dim: Optional[int] = None     # the dim split over ``model`` as the local program uses it

    @property
    def share(self) -> float:
        """The stored part of the compute tensor."""
        return math.prod(self.stored) / max(math.prod(self.compute), 1)

    def nbytes(self, shape) -> int:
        return math.prod(shape) * torch.empty((), dtype=self.dtype).element_size()


def _swap(module: nn.Module, name: str, shape: Tuple[int, ...]) -> None:
    old = getattr(module, name)
    setattr(module, name, nn.Parameter(torch.empty(shape, dtype=old.dtype, device="meta"),
                                       requires_grad=False))


def _mamba_local(model: transformer.Transformer, m: int) -> None:
    """A hybrid's mamba mixers split over ``model`` on their inner dim
    (channels are independent: in_proj column-, out_proj row-parallel)."""
    for bp in model.blocks:
        mb = getattr(bp, "mamba", None)
        if mb is None:
            continue
        d, di, n = mb.in_proj.shape[0], mb.a_log.shape[0], mb.a_log.shape[1]
        dl = di // m
        for name, shape in (("in_proj", (d, 2 * dl)), ("w_bc", (dl, 2 * n)), ("w_dt", (dl, 1)),
                            ("a_log", (dl, n)), ("d_skip", (dl,)), ("out_proj", (dl, d))):
            _swap(mb, name, shape)


@dataclasses.dataclass
class LocalProgram:
    cfg: ModelConfig           # the full config
    local: ModelConfig         # the local program's
    batch: int                 # sequences per device
    model: transformer.Transformer
    leaves: Dict[str, Leaf]


def local_program(cfg: ModelConfig, shape: InputShape, mesh) -> LocalProgram:
    """One device's model on meta and what each of its leaves costs."""
    m = int(mesh.shape.get("model", 1))
    local = local_config(cfg, mesh)
    model = transformer.Transformer(local, device="meta")
    di = cfg.ssm_expand * cfg.d_model
    mamba_tp = cfg.arch_type == "hybrid" and m > 1 and di % m == 0
    if mamba_tp:
        _mamba_local(model, m)
    full = param_shapes(cfg)
    axes = transformer.model_axes(cfg)
    specs = rules.spec_tree(axes, {n: s for n, (s, _) in full.items()}, mesh)
    leaves = {}
    for name, p in model.named_parameters():
        shape_, dtype = full[name]
        spec = specs[name]
        stored = rules.local_shape(shape_, spec, mesh)
        compute = tuple(p.shape)
        gather, ep, tp_dim = {}, False, None
        for j, entry in enumerate(spec):
            if entry is None:
                if compute[j] != shape_[j]:
                    raise ValueError(f"{name}: dim {j} is replicated but computed at "
                                     f"{compute[j]} of {shape_[j]}")
                continue
            if isinstance(entry, tuple):
                raise ValueError(f"{name}: a parameter dim over several axes ({entry})")
            f, r = divmod(compute[j], stored[j])
            if r or not 1 <= f <= mesh.shape[entry]:
                raise ValueError(f"{name}: dim {j} computed at {compute[j]}, stored at "
                                 f"{stored[j]} of {shape_[j]}")
            if mesh.shape[entry] == 1:
                continue
            if entry == "model" and axes[name][j] == "experts":
                ep = True
            elif f > 1:
                gather[entry] = f
            elif entry == "model":
                tp_dim = j - len(compute)
        leaves[name] = Leaf(name, shape_, dtype, spec, stored, compute, gather, ep, tp_dim)
    return LocalProgram(cfg, local, local_batch(shape, mesh), model, leaves)


def local_cache(prog: LocalProgram, shape: InputShape, mesh) -> Tuple[Dict, List[Tuple]]:
    """The decode cache of the local program on meta, and ``(tensor,
    stored share)`` for each entry: k/v at the local kv heads over the whole
    sequence (the work of all q heads over the stored sequence shard when
    the kv heads divide ``model``), a mamba state at the local inner dim."""
    full = cache_specs(prog.cfg, shape, mesh)
    mem = full.get("memory")
    memory = (torch.empty((prog.batch,) + mem[0][1:], dtype=mem[1], device="meta")
              if mem else None)
    cache = decoding.init_cache(prog.local, prog.batch, shape.seq_len, device="meta",
                                memory=memory)
    mamba_in = {bp.mamba.a_log.shape[0] for bp in prog.model.blocks if hasattr(bp, "mamba")}
    held = [] if memory is None else [(memory, 1.0)]
    for entry, spec_entry in zip(cache["layers"], full["layers"]):
        for key, t in list(entry.items()):
            if key == "h" and t.ndim == 3 and mamba_in:
                t = entry[key] = torch.zeros((t.shape[0], min(mamba_in), t.shape[2]),
                                             dtype=t.dtype, device="meta")
            stored = rules.local_shape(spec_entry[key][0], spec_entry[key][2], mesh)
            held.append((t, math.prod(stored) / max(t.numel(), 1)))
    # Every layer attends its whole cache: the step after a full context.
    cache["pos"] = max(e["k"].shape[2] for e in cache["layers"] if "k" in e) - 1 \
        if any("k" in e for e in cache["layers"]) else shape.seq_len - 1
    return cache, held
