"""CUDA ``flash_attention``: causal, optionally windowed, grouped-kv attention,
and its backward pass.

Replaces the TPU kernel ``flash_attention`` / ``_flash_kernel`` of
``src/repro/kernels/flash_attention.py`` together with the head repeat and
padding of ``repro.kernels.ops.mha``. Two hand-written forward kernels share
one contract, chosen by the inputs' type, both on the tensor cores:
bfloat16 in ``csrc/flash_attention_tc.cu`` (Hopper's ``wgmma`` fed by TMA
through a ring of shared-memory stages, a producer warpgroup and two consumer
warpgroups; f32 accumulation, P rounded to bf16), float32 in
``csrc/flash_attention.cu`` (TF32 ``wgmma`` fed by TMA with the 3-pass split
of ``csrc/tf32.cuh``, which keeps f32 parity at 1e-5: a pre-pass writes the
split planes of k and v, transposed for v, and a producer warpgroup feeds
them to two consumer warpgroups). Neither falls back to the other. Both take
q ``[B, Hq, Sq, D]`` and k, v
``[B, Hkv, Skv, D]`` as they are: they map each q head to its kv head and
mask ragged sequence lengths themselves. Each source note says what bounds
it on the H100 and what its design does about that. The plain version of
both is ``ref.flash_attention``.

The JAX kernel has no VJP (the reference trains through plain attention).
The port's backward is a kernel of its own, fed by the forward's row
log-sum-exp, with two routes chosen by type like the forward's: bfloat16 on
the tensor cores in ``csrc/flash_attention_bwd_tc.cu`` (``wgmma`` fed by TMA,
a producer warpgroup and two consumer warpgroups, like the forward's; f32
accumulation, P and dS rounded to bf16 before their products), float32 on
the tensor cores in ``csrc/flash_attention_bwd.cu`` (TF32 ``wgmma`` with the
3-pass split of ``csrc/tf32.cuh``, f32-accurate like the forward's f32
route; a pre-pass writes the split planes that TMA feeds to clusters of two
CTAs split by output).
Neither falls back to the other; both are deterministic. Their plain version is
``ref.flash_attention_bwd``. ``FlashAttention`` ties the two passes together
for autograd.

Each kernel has template instances for the head dims in ``HEAD_DIMS``. Any
other head dim d up to the largest runs through the smallest instance
D >= d (``at_kernel_head_dim``, which both ``launch`` and ``launch_bwd`` go
through): q, k, v (and o, dO) are zero-padded to D, the kernel is called
with the scale of the true d, and the outputs are cut back to d. Zero
columns add nothing to any score or to the row log-sum-exp, and their
gradients are zero, so the result is that of attention at d; the call is
one launch. A head dim above the largest instance raises.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, meta, ref

# Kernel launches, read by chip_smoke.py: each forward kernel and
# `launches` (their sum); each backward route and `launches_bwd` (theirs).
launches = 0
launches_tc = 0     # bfloat16, tensor cores (flash_attention_tc.cu, serving kernel)
launches_tc_lse = 0  # bfloat16 keeping the row log-sum-exp (its training kernel)
launches_f32 = 0    # float32, 3-pass TF32 (flash_attention.cu, either use; its pre-pass too)
launches_bwd = 0    # backward, either route
launches_bwd_tc = 0   # backward, bfloat16 on the tensor cores (flash_attention_bwd_tc.cu)
launches_bwd_f32 = 0  # backward, float32, 3-pass TF32 (flash_attention_bwd.cu)

HEAD_DIMS = (32, 64, 80, 128, 240)   # each kernel's template instances
_GRID_Y = 65535                 # query blocks (64 or 128 rows) ride the grid's y axis


def kernel_head_dim(d: int) -> int:
    """The template instance a head dim of ``d`` runs through: the smallest
    of ``HEAD_DIMS`` at or above it."""
    for inst in HEAD_DIMS:
        if 1 <= d <= inst:
            return inst
    raise ValueError(f"flash_attention kernel has no head dim {d}; it takes head dims from 1 "
                     f"to {HEAD_DIMS[-1]} (instances {HEAD_DIMS}, a smaller one zero-padded "
                     f"to the next)")


def at_kernel_head_dim(fn: Callable, q: torch.Tensor, *rest: torch.Tensor,
                       scale: Optional[float] = None, **kw):
    """``fn(q, *rest, scale=scale, **kw)`` at a head dim the kernels have.

    ``fn`` is a pass of attention (a kernel's launch or its plain version)
    whose 4-D arguments and results share q's last axis, the head dim d.
    Where d is an instance, or the arguments do not agree on it (``fn``
    then refuses them), ``fn`` is called as it is. Otherwise every 4-D
    argument is zero-padded along its last axis to ``kernel_head_dim(d)``,
    ``fn`` is called with the scale of d (``scale``, else 1/sqrt(d)), and
    every 4-D result is cut back to d; others (the row log-sum-exp) are
    returned as they are."""
    d = q.shape[-1] if q.ndim == 4 else None
    if d is None or d in HEAD_DIMS or any(t.ndim == 4 and t.shape[-1] != d for t in rest):
        return fn(q, *rest, scale=scale, **kw)
    width = kernel_head_dim(d)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)

    def pad(t):
        return F.pad(t, (0, width - d)) if t.ndim == 4 else t

    def cut(t):
        return t[..., :d].contiguous() if t.ndim == 4 else t

    out = fn(pad(q), *(pad(t) for t in rest), scale=scale, **kw)
    return tuple(cut(t) for t in out) if isinstance(out, tuple) else cut(out)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned start (the kernel's vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: Optional[int],
           scale: Optional[float]) -> Tuple[int, int, int, int, int, int, float]:
    """What both passes refuse; returns (b, hq, hkv, sq, skv, d, scale)."""
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
    return b, hq, hkv, sq, skv, d, scale


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           window: Optional[int] = None, scale: Optional[float] = None,
           with_lse: bool = False):
    """Causal attention on the card; arguments as ``ref.flash_attention``.

    Returns the output, or with ``with_lse`` the pair (output, each row's
    log-sum-exp of its scaled scores ``[B, Hq, Sq]`` f32, -inf for a fully
    masked row), which the backward pass needs. Any head dim up to the
    largest of ``HEAD_DIMS`` (``at_kernel_head_dim``).
    """
    return at_kernel_head_dim(_launch, q, k, v, window=window, scale=scale, with_lse=with_lse)


def _launch(q, k, v, *, window, scale, with_lse):
    global launches, launches_tc, launches_tc_lse, launches_f32
    b, hq, hkv, sq, skv, d, scale = _check(q, k, v, window, scale)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() > 0:
        tc = q.dtype == torch.bfloat16
        lib = build.load()
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if with_lse else None]
        if tc:
            fn = lib.flash_attention_tc_bf16
        else:
            # Scratch for the pre-pass: the TF32 planes of k and v that the
            # kernel streams.
            fn = lib.flash_attention_f32
            scratch = torch.empty(lib.flash_attention_f32_scratch(b, hkv, skv, d),
                                  dtype=torch.float32, device=q.device)
            ptrs.append(scratch.data_ptr())
        err = fn(*ptrs, b, hq, hkv, sq, skv, d, window or 0, scale,
                 torch.cuda.current_stream(q.device).cuda_stream)
        build.check(err, "flash_attention (bf16)" if tc else "flash_attention (f32)")
        if tc and with_lse:
            launches_tc_lse += 1
        elif tc:
            launches_tc += 1
        else:
            launches_f32 += 1
        launches += 1
    return (out, lse) if with_lse else out


def launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
               do: torch.Tensor, lse: torch.Tensor, *, window: Optional[int] = None,
               scale: Optional[float] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) on the card; arguments as ``ref.flash_attention_bwd``.
    Any head dim up to the largest of ``HEAD_DIMS`` (``at_kernel_head_dim``)."""
    return at_kernel_head_dim(_launch_bwd, q, k, v, o, do, lse, window=window, scale=scale)


def _launch_bwd(q, k, v, o, do, lse, *, window, scale):
    global launches_bwd, launches_bwd_tc, launches_bwd_f32
    b, hq, hkv, sq, skv, d, scale = _check(q, k, v, window, scale)
    if -(-skv // 64) > _GRID_Y:      # the backward's key tiles ride the y axis too
        raise ValueError(f"Skv={skv} exceeds the grid's limit of {_GRID_Y * 64}")
    if o.shape != q.shape or do.shape != q.shape or not o.dtype == do.dtype == q.dtype:
        raise ValueError(f"o and do must match q {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(o.shape)} {o.dtype} and {tuple(do.shape)} {do.dtype}")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be [{b}, {hq}, {sq}] float32, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    if any(t.device != q.device for t in (o, do, lse)):
        raise ValueError("flash_attention backward: o, do and lse must be on q's device")
    q, k, v, o, do = (_aligned(t) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    if q.numel() == 0 or k.numel() == 0:     # no (row, key) pair: every gradient is 0
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    tc = q.dtype == torch.bfloat16
    lib = build.load()
    # Scratch: D = rowsum(dO * O) [b, hq, sq], and for f32 the TF32 planes of
    # q, do, k and v that the kernels stream after it.
    n = b * hq * sq if tc else lib.flash_attention_bwd_f32_scratch(b, hq, hkv, sq, skv, d)
    delta = torch.empty(n, dtype=torch.float32, device=q.device)
    fn = lib.flash_attention_bwd_tc_bf16 if tc else lib.flash_attention_bwd_f32
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, hq,
             hkv, sq, skv, d, window or 0, scale, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention backward (bf16)" if tc else "flash_attention backward (f32)")
    if tc:
        launches_bwd_tc += 1
    else:
        launches_bwd_f32 += 1
    launches_bwd += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Causal attention with a gradient: on CUDA tensors the forward kernel
    (keeping each row's log-sum-exp) and the backward kernel; on CPU tensors
    their plain versions, ``ref.flash_attention`` (keeping the log-sum-exp
    too) and ``ref.flash_attention_bwd``; on meta tensors their shapes
    (``kernels.meta``)."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        if q.device.type == "cuda":
            out, lse = launch(q, k, v, window=window, with_lse=True)
        elif q.device.type == "meta":
            out, lse = meta.flash_attention(q, k, v, with_lse=True)
        else:
            out, lse = ref.flash_attention(q, k, v, causal=True, window=window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = {"cuda": launch_bwd, "meta": meta.flash_attention_bwd}.get(
            q.device.type, ref.flash_attention_bwd)
        dq, dk, dv = bwd(q, k, v, out, do, lse, window=ctx.window)
        return dq, dk, dv, None
