"""The kernels on ``meta`` tensors: shapes, and their work charged to a counter.

A ``meta`` tensor has a shape and a dtype and no data, so a step run on
``meta`` tensors (``launch.dryrun``) computes nothing. ``ops.mha`` and
``FlashAttention`` give such tensors outputs of the kernel's shapes and
dtypes and charge the kernel's work to the innermost active counter
(``roofline.step_cost.count`` pushes one onto ``counters``): FLOPs as the
reference's HLO counts attention, every ``Sq x Skv`` product in full
(2 products forward, the 5 the gradient needs backward: exactly what the
plain versions in ``ref`` compute), and bytes as each input read once and
each output written once. With no counter active they only give shapes.
CPU and CUDA tensors never come here.
"""
from __future__ import annotations

from typing import Optional

import torch

# The active counters of steps run on meta tensors, innermost last.
counters: list = []


def _nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _charge(flops: float, nbytes: float) -> None:
    if counters:
        counters[-1].charge(flops, nbytes)


def attention_override():
    """The active counter's replacement of the kernel (the dry-run's
    ``--attention-impl``), or None."""
    return counters[-1].attention if counters else None


def _pair_flops(q: torch.Tensor, k: torch.Tensor) -> float:
    """2 B Hq Sq Skv D: one full ``Sq x Skv`` product."""
    b, hq, sq, d = q.shape
    return 2.0 * b * hq * sq * k.shape[2] * d


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    with_lse: bool = False):
    """The forward kernel on meta tensors: (output[, row log-sum-exp])."""
    out = torch.empty_like(q)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if with_lse else None)
    _charge(2 * _pair_flops(q, k), _nbytes(q, k, v, out, *(() if lse is None else (lse,))))
    return (out, lse) if with_lse else out


def flash_attention_bwd(q, k, v, o, do, lse, *, window: Optional[int] = None):
    """The backward kernel on meta tensors: (dq, dk, dv)."""
    del window
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _charge(5 * _pair_flops(q, k), _nbytes(q, k, v, o, do, lse, dq, dk, dv))
    return dq, dk, dv
