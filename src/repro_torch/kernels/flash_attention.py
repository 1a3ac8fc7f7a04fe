"""CUDA ``flash_attention``: causal, optionally windowed, grouped-kv attention.

Replaces the TPU kernel ``flash_attention`` / ``_flash_kernel`` of
``src/repro/kernels/flash_attention.py`` together with the head repeat and
padding of ``repro.kernels.ops.mha``. Two hand-written kernels share one
contract, chosen by the inputs' type, both on the tensor cores with
``mma.sync``: bfloat16 in ``csrc/flash_attention_tc.cu`` (f32 accumulation, P
rounded to bf16), float32 in ``csrc/flash_attention.cu`` (TF32 with the 3-pass
split of ``csrc/tf32.cuh``, which keeps f32 parity at 1e-5). Neither falls
back to the other. Both take q ``[B, Hq, Sq, D]`` and k, v
``[B, Hkv, Skv, D]`` as they are: they map each q head to its kv head and
mask ragged sequence lengths themselves. Each source note says what bounds
it on the H100 and what its design does about that. The plain version of
both is ``ref.flash_attention``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build

# Kernel launches made by `launch`, read by chip_smoke.py: per route, and
# `launches`, their sum.
launches = 0
launches_tc = 0     # bfloat16, tensor cores (flash_attention_tc.cu)
launches_f32 = 0    # float32, 3-pass TF32 (flash_attention.cu)

HEAD_DIMS = (32, 64, 80, 128)   # each kernel's template instances
_GRID_Y = 65535                 # query blocks (64 or 128 rows) ride the grid's y axis


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned start (the kernel's vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           window: Optional[int] = None, scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention on the card; arguments as ``ref.flash_attention``."""
    global launches, launches_tc, launches_f32
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention kernel needs q, k, v on one CUDA device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not q.dtype == k.dtype == v.dtype:
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
    tc = q.dtype == torch.bfloat16
    lib = build.load()
    fn = lib.flash_attention_tc_bf16 if tc else lib.flash_attention_f32
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv, sq, skv, d,
             window or 0, scale, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention (bf16)" if tc else "flash_attention (f32)")
    if tc:
        launches_tc += 1
    else:
        launches_f32 += 1
    launches += 1
    return out
