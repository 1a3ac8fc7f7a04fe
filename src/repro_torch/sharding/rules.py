"""Logical-axis -> mesh-axis sharding rules (MaxText-style, divisibility-aware).

Counterpart of ``repro.sharding.rules``, with the same rules and the same
fallbacks. Each parameter leaf carries a tuple of logical axis names (the
``axes_*`` functions beside each module of ``repro_torch.models``);
``logical_to_spec`` maps them to a spec given the mesh, falling back to
replication when a dimension does not divide its mesh axis, and sharding
each mesh axis on one dimension at most. A spec is a tuple with one entry
per dimension: ``None``, a mesh axis name, or a tuple of names. A mesh is
anything with a ``.shape`` mapping axis names to sizes
(``launch.mesh.ProductionMesh``). The reference's ``sharding_tree``, which
only wraps specs into ``NamedSharding``\\ s, has no counterpart.

Default rules (tensor parallel on "model", data parallel on ("pod","data")):
  vocab, heads, kv_heads, ff, expert_ff, experts, inner -> model
  embed  -> data   (FSDP / ZeRO-3: the d_model dim of weights shards over data)
  layers -> None   (the reference's scan stack dim; the port has none)
  batch  -> (pod, data)
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

Spec = Tuple

DEFAULT_RULES: Dict[str, Optional[str]] = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "expert_ff": "model",
    "experts": "model",
    "inner": "model",
    "embed": "data",   # FSDP: the d_model dim of weights shards over data
    "layers": None,
    "batch": "data",   # expanded to ("pod","data") when the mesh has pods
}


def axis_size(mesh, name) -> int:
    """The number of devices along a spec entry (None, a name or a tuple)."""
    if name is None:
        return 1
    if isinstance(name, tuple):
        return math.prod(int(mesh.shape[n]) for n in name)
    return int(mesh.shape[name])


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def logical_to_spec(axes: Tuple, shape: Tuple[int, ...], mesh,
                    rules: Optional[Mapping[str, Optional[str]]] = None) -> Spec:
    """Map one leaf's logical axes to a spec (divisibility fallback)."""
    rules = rules or DEFAULT_RULES
    entries = []
    used = set()
    for dim, name in zip(shape, axes):
        target = rules.get(name) if name is not None else None
        if name == "batch":
            target = batch_axes(mesh)
        if not target:
            entries.append(None)
            continue
        target_t = (target,) if isinstance(target, str) else tuple(target)
        if any(t not in mesh.shape for t in target_t):
            entries.append(None)
            continue
        if any(t in used for t in target_t):
            entries.append(None)  # an axis can shard only one dim
            continue
        if dim % axis_size(mesh, target_t) != 0:
            entries.append(None)  # divisibility fallback -> replicate
            continue
        used.update(target_t)
        entries.append(target_t if len(target_t) > 1 else target_t[0])
    return tuple(entries)


def spec_tree(axes: Mapping[str, Tuple], shapes: Mapping[str, Tuple[int, ...]], mesh,
              rules: Optional[Mapping[str, Optional[str]]] = None) -> Dict[str, Spec]:
    """Specs of a flat ``{name: shape}`` tree of leaves from their ``{name:
    logical axes}``; both hold the same names."""
    if set(axes) != set(shapes):
        raise KeyError(f"axes and shapes name different leaves: "
                       f"{sorted(set(axes) ^ set(shapes))[:8]}")
    return {name: logical_to_spec(axes[name], tuple(shapes[name]), mesh, rules)
            for name in shapes}


def local_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """One device's share of a leaf of ``shape`` laid out by ``spec``."""
    return tuple(d // axis_size(mesh, s) for d, s in zip(shape, spec)) + tuple(
        shape[len(spec):])
