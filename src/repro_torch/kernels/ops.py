"""Public kernel wrappers, dispatched by the tensors' device.

Counterpart of ``repro.kernels.ops``. A tensor on the CPU runs the plain
version in ``ref``; a CUDA tensor launches the hand-written kernel, or the
launch raises. There is no fallback from one to the other. ``mha`` also
takes ``meta`` tensors (``kernels.meta``: the kernel's output shapes, its
work charged to the dry-run's counter); no other device is accepted. The
CUDA launches of ``sage_aggregate`` (its forward) and ``sim_topk`` run
inside the spans ``kernel.sage_aggregate`` and ``kernel.sim_topk``
(``repro_torch.trace``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import trace
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import meta, ref
from repro_torch.kernels import sage_aggregate as _sage
from repro_torch.kernels import sim_topk as _sim


def _route(t: torch.Tensor, name: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no implementation for device {t.device}")
    return t.device.type


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
        window: Optional[int] = None) -> torch.Tensor:
    """Causal multi-head attention with grouped kv heads (prefill).

    q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] with Hq % Hkv == 0. Returns
    [B, Hq, Sq, D] in q's dtype. Queries are end-aligned with the keys and
    ``window`` keeps keys at positions > the query's minus ``window``, as
    ``ref.flash_attention``. Counterpart of ``repro.kernels.ops.mha``, without
    its head repeat and padding: the kernel maps heads and masks ragged
    lengths itself. Where a gradient is wanted (grad mode on and one of
    q, k, v requiring it) it runs through ``FlashAttention``: on the card the
    forward kernel keeps each row's log-sum-exp and the backward kernel
    gives the gradients; on the CPU their plain versions; on ``meta``
    tensors (a dry-run) their output shapes, or the active counter's
    replacement (``meta.attention_override``: plain or chunked attention).
    """
    if not causal:
        raise ValueError("mha is causal only; non-causal (cross) attention takes "
                         "the plain path, as in the reference")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"mha: q, k, v on different devices ({q.device}, {k.device}, "
                         f"{v.device})")
    if q.device.type == "meta" and meta.attention_override() is not None:
        return meta.attention_override()(q, k, v, window=window)
    route = "meta" if q.device.type == "meta" else _route(q, "mha")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _fa.FlashAttention.apply(q, k, v, window)
    if route == "cpu":
        return ref.flash_attention(q, k, v, causal=True, window=window)
    if route == "meta":
        return meta.flash_attention(q, k, v)
    return _fa.launch(q, k, v, window=window)


def sage_aggregate(adj: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Row-normalized neighbor mean ``(A @ H) / max(rowsum(A), 1)``.

    adj: [M, n, n]; h: [M, n, d] (the plain version also takes any other
    leading axes). Differentiable in both.
    """
    if _route(h, "sage_aggregate") == "cpu":
        return ref.sage_aggregate(adj, h)
    with trace.span("kernel.sage_aggregate"):
        return _sage.SageAggregate.apply(adj, h)


def sim_topk(h: torch.Tensor, client_ids: torch.Tensor, target_mask: torch.Tensor,
             k: int, *, col_offset: int = 0, rows: Optional[torch.Tensor] = None,
             row_cid: Optional[torch.Tensor] = None,
             run: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused masked top-k similarity, batched over a leading [N] axis.

    h: [N, n, c] or [n, c], the candidates; client_ids: [n] or [N, n];
    target_mask: like h without c. Per query row: the k most similar
    candidates whose client id differs from the row's and whose target mask
    is set, candidate j as index ``col_offset + j``. The query rows are h
    itself (the square call), or ``rows`` [.., q, c] of clients ``row_cid``
    [.., q] (or [q]). ``run``, a running (vals, idx) [.., q, k] with global
    indices, is folded in, ties going to the smallest global index. Returns
    (vals [.., q, k] f32 with -inf on missing candidates, idx [.., q, k]
    int32 with -1 there).
    """
    if (rows is None) != (row_cid is None):
        raise ValueError("sim_topk: pass rows and row_cid together")
    if _route(h, "sim_topk") == "cpu":
        return ref.sim_topk(h, client_ids, target_mask, k, col_offset, rows=rows,
                            row_cid=row_cid, run=run)
    flat = h.ndim == 2
    if flat:
        h = h[None]
        rows = None if rows is None else rows[None]
        run = None if run is None else (run[0][None], run[1][None])
    with trace.span("kernel.sim_topk"):
        if rows is None and run is None:
            vals, idx = _sim.launch(h, client_ids, target_mask, k, col_offset)
        elif rows is None:
            vals, idx = _sim.launch_rows(h, client_ids, h, client_ids, target_mask, k,
                                         col_offset, run)
        else:
            vals, idx = _sim.launch_rows(rows, row_cid, h, client_ids, target_mask, k,
                                         col_offset, run)
    return (vals[0], idx[0]) if flat else (vals, idx)


def sim_block(rows: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Gram slab ``rows @ hᵀ`` [b, n] of rows [b, c] and h [n, c], summed in f32
    and returned in rows' type. Counterpart of ``repro.kernels.ops.sim_block``,
    without its padding: the kernel masks ragged b and n itself."""
    if h.device != rows.device:
        raise ValueError(f"sim_block: rows and h on different devices ({rows.device}, "
                         f"{h.device})")
    if _route(rows, "sim_block") == "cpu":
        return ref.sim_block(rows, h)
    return _sim.launch_block(rows, h)
