"""CUDA ``flash_attention``: causal, optionally windowed, grouped-kv attention.

Replaces the TPU kernel ``flash_attention`` / ``_flash_kernel`` of
``src/repro/kernels/flash_attention.py`` together with the head repeat and
padding of ``repro.kernels.ops.mha``. The kernel (``csrc/flash_attention.cu``)
takes q ``[B, Hq, Sq, D]`` and k, v ``[B, Hkv, Skv, D]`` as they are: it maps
each q head to its kv head and masks ragged sequence lengths itself. Its
source note says what bounds it on the H100 and what its design does about
that. Its plain version is ``ref.flash_attention``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build

launches = 0   # kernel launches made by `launch`, read by chip_smoke.py

HEAD_DIMS = (32, 64, 80, 128)   # the kernel's template instances
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_Y = 65535                 # query blocks of 64 rows ride the grid's y axis


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned start (the kernel's vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           window: Optional[int] = None, scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention on the card; arguments as ``ref.flash_attention``."""
    global launches
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention kernel needs q, k, v on one CUDA device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 for all of "
                        f"q, k, v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B, Hq, Sq, D] and k, v [B, Hkv, Skv, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not match "
                         f"(batch, head dim, Hq % Hkv == 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel has no head dim {d}; it takes {HEAD_DIMS}")
    if -(-sq // 64) > _GRID_Y:
        raise ValueError(f"Sq={sq} exceeds the grid's limit of {_GRID_Y * 64}")
    if window is not None and window < 1:
        raise ValueError(f"window must be a positive number of keys, got {window}")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build.load()
    err = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                  _DTYPE_CODES[q.dtype], b, hq, hkv, sq, skv, d,
                                  window or 0, scale,
                                  torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    launches += 1
    return out
