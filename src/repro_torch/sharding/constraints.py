"""Activation specs at module boundaries: counterpart of ``repro.sharding.constraints``.

The reference pins the canonical activation layout with
``with_sharding_constraint`` where its modules meet (the residual stream in
``transformer.forward``, the decode cache, the loss), so that GSPMD does not
pick batch-replicated layouts. The port has no SPMD compiler, so nothing is
constrained: the cost model (``roofline.analysis``) reads these specs to size
activations per device and to tell when the tensor-parallel products must be
all-reduced (or all-gathered and reduce-scattered, with the residual
stream's sequence sharded over ``model``).

Pattern entries: "batch" -> ("pod", "data") | "seq", "vocab", "model",
"heads", "ff" -> "model" | None -> replicated; each where it divides.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from repro_torch.sharding import rules


def activation_spec(shape: Sequence[int], pattern: Sequence[Optional[str]], mesh) -> Tuple:
    """The spec ``constraints.constrain(x, *pattern)`` resolves to for a
    tensor of ``shape`` on ``mesh``."""
    names = set(mesh.shape)
    entries = []
    for dim, p in zip(shape, pattern):
        if p == "batch":
            axes = tuple(a for a in ("pod", "data") if a in names)
            ok = axes and dim % rules.axis_size(mesh, axes) == 0
            entries.append((axes if len(axes) > 1 else axes[0]) if ok else None)
        elif p in ("seq", "vocab", "model", "heads", "ff"):
            ok = "model" in names and dim % int(mesh.shape["model"]) == 0
            entries.append("model" if ok else None)
        else:
            entries.append(None)
    return tuple(entries)
