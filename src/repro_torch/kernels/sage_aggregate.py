"""CUDA ``sage_aggregate``: batched row-normalized neighbor mean.

Replaces the TPU kernel ``sage_aggregate`` / ``_sage_kernel`` of
``src/repro/kernels/sage_aggregate.py`` and the custom VJP around it in
``src/repro/kernels/ops.py``. The kernel (``csrc/sage_aggregate.cu``) computes
``(A @ H) / max(rowsum(A), 1)`` for every client of a ``[M, n, n] x [M, n, d]``
batch in one launch; its source note says what bounds it on the H100 and
what its design does about that. Its plain version is
``ref.sage_aggregate``.

``SageAggregate`` mirrors the reference's VJP: kernel forward, plain
backward. ``grad_h = Aᵀ @ (g / max(deg, 1))``, with no n x n temporary, runs
through ``torch.bmm`` only when ``h`` needs a gradient (layer 1's input
features do not, and skipping it saves a second 3 TFLOP product per step at
full size); ``grad_adj`` runs through autograd of the plain version only when
``adj`` needs one.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

launches = 0   # kernel launches made by `launch`, read by chip_smoke.py


def launch(adj: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Run the CUDA kernel on ``adj [M, n, n]``, ``h [M, n, d]`` (float32)."""
    global launches
    if adj.device.type != "cuda" or h.device != adj.device:
        raise ValueError(f"sage_aggregate kernel needs both tensors on one CUDA "
                         f"device, got {adj.device} and {h.device}")
    if adj.dtype != torch.float32 or h.dtype != torch.float32:
        raise TypeError(f"sage_aggregate kernel takes float32, got {adj.dtype}, {h.dtype}")
    if adj.ndim != 3 or h.ndim != 3:
        raise ValueError(f"expected adj [M, n, n] and h [M, n, d], got "
                         f"{tuple(adj.shape)} and {tuple(h.shape)}")
    m, n, n2 = adj.shape
    if n != n2 or h.shape[0] != m or h.shape[1] != n:
        raise ValueError(f"shape mismatch: adj {tuple(adj.shape)}, h {tuple(h.shape)}")
    d = h.shape[2]
    if m > 65535:
        raise ValueError(f"batch {m} exceeds the grid's z limit")
    adj = adj.contiguous()
    h = h.contiguous()
    out = torch.empty((m, n, d), dtype=torch.float32, device=h.device)
    if out.numel() == 0:
        return out
    lib = build.load()
    err = lib.sage_aggregate_f32(adj.data_ptr(), h.data_ptr(), out.data_ptr(),
                                 m, n, d, torch.cuda.current_stream(h.device).cuda_stream)
    build.check(err, "sage_aggregate")
    launches += 1
    return out


class SageAggregate(torch.autograd.Function):
    """Kernel forward, plain backward (the reference's custom VJP)."""

    @staticmethod
    def forward(ctx, adj, h):
        ctx.save_for_backward(adj, h)
        return launch(adj, h)

    @staticmethod
    def backward(ctx, g):
        adj, h = ctx.saved_tensors
        grad_adj = grad_h = None
        if ctx.needs_input_grad[1]:
            deg = torch.clamp_min(torch.sum(adj, dim=-1, keepdim=True), 1.0)
            grad_h = torch.bmm(adj.transpose(-1, -2), g / deg)
        if ctx.needs_input_grad[0]:
            with torch.enable_grad():
                a = adj.detach().requires_grad_(True)
                (grad_adj,) = torch.autograd.grad(ref.sage_aggregate(a, h.detach()), a, g)
        return grad_adj, grad_h
