"""CUDA ``sim_topk``: fused masked similarity top-k over all edge servers.

Replaces the TPU kernel ``sim_topk`` / ``_sim_topk_kernel`` (and its merge
``topk_merge``) of ``src/repro/kernels/sim_topk.py``, wrapper in
``src/repro/kernels/ops.py``. The kernel (``csrc/sim_topk.cu``) scores every
row of ``h[b]`` against every candidate of the same server ``b``, keeps the
cross-client candidates whose target mask is set, and returns the k best,
ties to the smallest index, in one launch for all N servers; its source note
says what bounds it on the H100 and what its design does about that. Its
plain version is ``ref.sim_topk``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

launches = 0   # kernel launches made by `launch`, read by chip_smoke.py

MAX_K = 16     # register top-k depth the kernel is instantiated for
MAX_C = 16     # feature width of the staged candidate tile


def launch(h: torch.Tensor, client_ids: torch.Tensor, target_mask: torch.Tensor,
           k: int, col_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the CUDA kernel on ``h [N, n, c]``, ``client_ids [N, n]`` (or
    ``[n]``), ``target_mask [N, n]``. Returns (vals [N, n, k] float32,
    idx [N, n, k] int32)."""
    global launches
    if h.device.type != "cuda":
        raise ValueError(f"sim_topk kernel needs a CUDA tensor, got {h.device}")
    if h.dtype != torch.float32:
        raise TypeError(f"sim_topk kernel takes float32 h, got {h.dtype}")
    if h.ndim != 3:
        raise ValueError(f"expected h [N, n, c], got {tuple(h.shape)}")
    nb, n, c = h.shape
    if not 1 <= k <= min(n, MAX_K):
        raise ValueError(f"sim_topk kernel needs 1 <= k <= min(n, {MAX_K}), "
                         f"got k={k}, n={n}")
    if not 1 <= c <= MAX_C:
        raise ValueError(f"sim_topk kernel needs 1 <= c <= {MAX_C}, got c={c}")
    if nb > 65535:
        raise ValueError(f"batch {nb} exceeds the grid's y limit")
    cid = client_ids.to(device=h.device, dtype=torch.int32).expand(nb, n).contiguous()
    mask = target_mask.to(device=h.device, dtype=torch.float32).expand(nb, n).contiguous()
    h = h.contiguous()
    vals = torch.empty((nb, n, k), dtype=torch.float32, device=h.device)
    idx = torch.empty((nb, n, k), dtype=torch.int32, device=h.device)
    lib = build.load()
    err = lib.sim_topk_f32(h.data_ptr(), cid.data_ptr(), mask.data_ptr(),
                           vals.data_ptr(), idx.data_ptr(), nb, n, c, k,
                           int(col_offset),
                           torch.cuda.current_stream(h.device).cuda_stream)
    build.check(err, "sim_topk")
    launches += 1
    return vals, idx
