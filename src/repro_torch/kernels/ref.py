"""Plain PyTorch versions of the port's kernels (the CPU path and the oracle).

Counterpart of ``repro.kernels.ref`` plus the reference's streaming
``topk_merge``. Each function computes what one CUDA kernel computes, written
as ordinary tensor code: ``ops`` runs it for tensors on the CPU, and the
tests and ``chip_smoke.py`` hold the kernels against it on the card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _visible(sq: int, skv: int, causal: bool, window: Optional[int], device) -> torch.Tensor:
    """[Sq, Skv] bool: which keys each end-aligned query sees."""
    qpos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _math_dtype(q: torch.Tensor) -> torch.dtype:
    """f32, or float64 for float64 inputs (the tests' yardstick)."""
    return torch.promote_types(q.dtype, torch.float32)


def _scores(q: torch.Tensor, k: torch.Tensor, scale: Optional[float]) -> torch.Tensor:
    """Scaled scores [B, Hkv, Hq / Hkv, Sq, Skv] in ``_math_dtype``, q heads
    grouped by kv head."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    ct = _math_dtype(q)
    qf = q.to(ct).reshape(b, hkv, hq // hkv, sq, d)
    return (qf @ k.to(ct)[:, :, None].transpose(-1, -2)) * scale


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, with_lse: bool = False):
    """Masked softmax attention with f32 math; the plain flash kernel.

    q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] with ``Hq % Hkv == 0`` (q head
    h reads kv head ``h // (Hq // Hkv)``, with no copy of the kv heads).
    Query i sits at position ``i + Skv - Sq`` (queries end-aligned with the
    keys); with ``causal`` it sees keys at positions <= its own, and with
    ``window`` only keys at positions > its own minus ``window``. Fully
    masked rows give 0. The output has q's dtype. With ``with_lse``, the
    pair (output, ``flash_attention_lse``'s log-sum-exp from the same
    scores), as the forward kernels give it. Counterpart of
    ``repro.kernels.ref.flash_attention``, which takes kv heads already
    repeated to Hq.
    """
    b, hq, sq, d = q.shape
    logits = _scores(q, k, scale)
    mask = _visible(sq, k.shape[2], causal, window, q.device)
    logits = logits.masked_fill(~mask, -torch.inf)
    probs = torch.nan_to_num(torch.softmax(logits, dim=-1), nan=0.0)
    out = (probs @ v.to(probs.dtype)[:, :, None]).reshape(b, hq, sq, d).to(q.dtype)
    if with_lse:
        return out, torch.logsumexp(logits, dim=-1).reshape(b, hq, sq)
    return out


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, *, window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Each row's log-sum-exp of its scaled causal scores, [B, Hq, Sq] f32
    (float64 for float64 inputs; -inf for a fully masked row): what the
    forward kernels keep for the backward pass."""
    b, hq, sq, _ = q.shape
    logits = _scores(q, k, scale).masked_fill(
        ~_visible(sq, k.shape[2], True, window, q.device), -torch.inf)
    return torch.logsumexp(logits, dim=-1).reshape(b, hq, sq)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor, *, window: Optional[int] = None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of causal ``flash_attention``, written out step
    by step in f32 (float64 for float64 inputs, the tests' yardstick); the
    plain backward kernel.

    From the forward's output ``o`` and row log-sum-exp ``lse``
    (``flash_attention_lse``) and the output's gradient ``do``, over the
    (row, key) pairs a row sees: P = exp(S - lse), dP = dO Vᵀ,
    D = rowsum(dO ⊙ O), dS = P ⊙ (dP − D), dq = dS K · scale,
    dk = dSᵀ Q · scale and dv = Pᵀ dO, with dk and dv summed over the q heads
    of each kv head's group. Pairs a row may not see give P = dS = 0, so a
    fully masked row gets dq = 0 and adds nothing to dk or dv. Each gradient
    has its input's dtype.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    mask = _visible(sq, skv, True, window, q.device)
    ct = _math_dtype(q)
    group = lambda t: t.to(ct).reshape(b, hkv, g, sq, d)  # noqa: E731
    qf, of, dof = group(q), group(o), group(do)
    kf, vf = k.to(ct)[:, :, None], v.to(ct)[:, :, None]
    s = _scores(q, k, scale)
    p = torch.where(mask, torch.exp(s - lse.to(ct).reshape(b, hkv, g, sq, 1)), 0.0)
    dp = dof @ vf.transpose(-1, -2)
    delta = torch.sum(dof * of, dim=-1, keepdim=True)
    ds = torch.where(mask, p * (dp - delta), 0.0)
    dq = (ds @ kf) * scale
    dk = torch.sum(ds.transpose(-1, -2) @ qf, dim=2) * scale
    dv = torch.sum(p.transpose(-1, -2) @ dof, dim=2)
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def sage_aggregate(adj: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Row-normalized neighbor mean: (A @ H) / max(rowsum(A), 1).

    adj: [..., n, n] non-negative weights; h: [..., n, d], with any leading
    batch axes (the [M] client axis on the main path). f32 accumulation.
    """
    a = adj.float()
    agg = a @ h.float()
    deg = torch.sum(a, dim=-1, keepdim=True)
    return (agg / torch.clamp_min(deg, 1.0)).to(h.dtype)


def sim_block(rows: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Gram slab ``rows @ hᵀ`` in f32, returned in rows' type; the plain
    ``sim_block`` kernel. rows: [b, c]; h: [n, c]. Counterpart of
    ``repro.kernels.ref.sim_block``."""
    return (rows.float() @ h.float().T).to(rows.dtype)


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with ties going to the smallest index.

    ``jax.lax.top_k``'s tie rule. ``torch.topk`` promises no order among
    ties, so this sorts with a stable descending sort and keeps k.
    """
    vals, order = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], order[..., :k]


def sim_topk(h: torch.Tensor, client_ids: torch.Tensor, target_mask: torch.Tensor,
             k: int, col_offset: int = 0, *, rows: Optional[torch.Tensor] = None,
             row_cid: Optional[torch.Tensor] = None,
             run: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked top-k over the gram ``rows @ hᵀ``, batched over leading axes.

    h: [..., n, c], the candidates; client_ids: [..., n] (or [n],
    broadcast); target_mask: [..., n]. The query rows are h itself (the
    square call, k <= n), or ``rows`` [..., q, c] of clients ``row_cid``
    [..., q] (or [q]). Row r's candidates are the columns of another client
    whose target mask is set. Returns (vals [..., q, k] f32 with -inf on
    unfilled slots, idx [..., q, k] int32 with -1 there); ``col_offset``
    shifts the emitted indices. Ties go to the smallest index. ``run``, a
    running (vals, idx) [..., q, k] with global indices, is folded in by
    :func:`topk_merge`'s rule; with rows or a running list, k may exceed n.
    """
    n = h.shape[-2]
    square = rows is None and run is None
    if square and not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= n, got k={k}, n={n}")
    if rows is None:
        rows, row_cid = h, client_ids
    hf = h.float()
    gram = rows.float() @ hf.transpose(-1, -2)
    keep = ((row_cid.to(torch.int32)[..., :, None] != client_ids.to(torch.int32)[..., None, :])
            & (target_mask[..., None, :] > 0))
    gram = torch.where(keep, gram, -torch.inf)
    vals, idx = stable_topk(gram, min(k, n))
    idx = torch.where(vals > -torch.inf, idx.to(torch.int32) + col_offset, -1)
    if k > n:
        pad = vals.shape[:-1] + (k - n,)
        vals = torch.cat([vals, vals.new_full(pad, -torch.inf)], -1)
        idx = torch.cat([idx, idx.new_full(pad, -1)], -1)
    if run is not None:
        vals, idx = topk_merge(run[0].float(), run[1].to(torch.int32), vals, idx)
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
