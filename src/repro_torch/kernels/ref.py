"""Plain PyTorch versions of the port's kernels (the CPU path and the oracle).

Counterpart of ``repro.kernels.ref`` plus the reference's streaming
``topk_merge``. Each function computes what one CUDA kernel computes, written
as ordinary tensor code: ``ops`` runs it for tensors on the CPU, and the
tests and ``chip_smoke.py`` hold the kernels against it on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch


def sage_aggregate(adj: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Row-normalized neighbor mean: (A @ H) / max(rowsum(A), 1).

    adj: [..., n, n] non-negative weights; h: [..., n, d], with any leading
    batch axes (the [M] client axis on the main path). f32 accumulation.
    """
    a = adj.float()
    agg = a @ h.float()
    deg = torch.sum(a, dim=-1, keepdim=True)
    return (agg / torch.clamp_min(deg, 1.0)).to(h.dtype)


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with ties going to the smallest index.

    ``jax.lax.top_k``'s tie rule. ``torch.topk`` promises no order among
    ties, so this sorts with a stable descending sort and keeps k.
    """
    vals, order = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], order[..., :k]


def sim_topk(h: torch.Tensor, client_ids: torch.Tensor, target_mask: torch.Tensor,
             k: int, col_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked top-k over the gram ``h @ hᵀ``, batched over leading axes.

    h: [..., n, c]; client_ids: [..., n] (or [n], broadcast); target_mask:
    [..., n]. Row r's candidates are the columns of another client whose
    target mask is set. Returns (vals [..., n, k] f32 with -inf on unfilled
    slots, idx [..., n, k] int32 with -1 there); ``col_offset`` shifts the
    emitted indices. Ties go to the smallest index.
    """
    n = h.shape[-2]
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= n, got k={k}, n={n}")
    hf = h.float()
    gram = hf @ hf.transpose(-1, -2)
    cid = client_ids.to(torch.int32)
    keep = (cid[..., :, None] != cid[..., None, :]) & (target_mask[..., None, :] > 0)
    gram = torch.where(keep, gram, -torch.inf)
    vals, idx = stable_topk(gram, k)
    idx = torch.where(vals > -torch.inf, idx.to(torch.int32) + col_offset, -1)
    return vals, idx


def topk_merge(run_v: torch.Tensor, run_i: torch.Tensor, slab_v: torch.Tensor,
               slab_i: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a candidate slab into a running (values, indices) top-k.

    Counterpart of ``repro.kernels.sim_topk.topk_merge``: k argmax passes over
    the k+m candidates, ties going to the smallest candidate index, so the
    result does not depend on the order slabs arrive in. ``run_*`` are
    ``[..., k]`` (-inf / -1 on unfilled slots); ``slab_*`` are ``[..., m]``
    with -inf on masked entries. Exhausted rows emit index -1.
    """
    k = run_v.shape[-1]
    cand_v = torch.cat([run_v, slab_v], dim=-1)
    cand_i = torch.cat([run_i, slab_i], dim=-1)
    new_v, new_i = [], []
    for _ in range(k):
        best = torch.amax(cand_v, dim=-1, keepdim=True)
        at_best = cand_v == best
        sel_i = torch.amin(torch.where(at_best, cand_i, 2**30), dim=-1, keepdim=True)
        sel = at_best & (cand_i == sel_i)
        new_v.append(best)
        new_i.append(torch.where(best > -torch.inf, sel_i, -1))
        cand_v = torch.where(sel, -torch.inf, cand_v)
    return torch.cat(new_v, dim=-1), torch.cat(new_i, dim=-1)
