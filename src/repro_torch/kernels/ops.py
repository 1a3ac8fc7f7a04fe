"""Public kernel wrappers, dispatched by the tensors' device.

Counterpart of ``repro.kernels.ops``. A tensor on the CPU runs the plain
version in ``ref``; a CUDA tensor launches the hand-written kernel, or the
launch raises. There is no fallback from one to the other, and no other
device is accepted.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import sage_aggregate as _sage
from repro_torch.kernels import sim_topk as _sim


def _route(t: torch.Tensor, name: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no implementation for device {t.device}")
    return t.device.type


def sage_aggregate(adj: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Row-normalized neighbor mean ``(A @ H) / max(rowsum(A), 1)``.

    adj: [M, n, n]; h: [M, n, d] (the plain version also takes any other
    leading axes). Differentiable in both.
    """
    if _route(h, "sage_aggregate") == "cpu":
        return ref.sage_aggregate(adj, h)
    return _sage.SageAggregate.apply(adj, h)


def sim_topk(h: torch.Tensor, client_ids: torch.Tensor, target_mask: torch.Tensor,
             k: int, *, col_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused masked top-k similarity, batched over a leading [N] axis.

    h: [N, n, c] or [n, c]; client_ids: [n] or [N, n]; target_mask: like h
    without c. Per row of h: the k most similar rows of h whose client id
    differs and whose target mask is set. Returns (vals [.., n, k] f32 with
    -inf on missing candidates, idx [.., n, k] int32 with -1 there).
    """
    if _route(h, "sim_topk") == "cpu":
        return ref.sim_topk(h, client_ids, target_mask, k, col_offset)
    if h.ndim == 2:
        vals, idx = _sim.launch(h[None], client_ids, target_mask, k, col_offset)
        return vals[0], idx[0]
    return _sim.launch(h, client_ids, target_mask, k, col_offset)
