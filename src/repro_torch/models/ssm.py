"""Selective SSM (Mamba-style) mixer of the hybrid arch (hymba): counterpart
of ``repro.models.ssm``.

The recurrence
    h_t = exp(A·dt_t) ⊙ h_{t-1} + dt_t·B_t·x_t,   y_t = C_t·h_t + D⊙x_t
runs chunkwise over ``CHUNK`` = 128 steps, as in the reference: within a
chunk, each step's decay products and driven state are scanned from the
chunk's start; across chunks the ``[B, d_inner, n_state]`` state is carried.
The reference scans inside a chunk with ``jax.lax.associative_scan`` and
carries the state with ``lax.scan``; here the decay products are one
``cumprod`` and the driven state a Python loop over the chunk's 128
positions, each step batched over every chunk of the sequence (the drive
within a chunk does not depend on the carried state), then a loop over
chunks carries the state. Same sums in another order: 1e-5 of the
reference. Decode is the single-step recurrence on the carried state.

Types follow the reference: projections in the model's dtype, gates, state
and ``y`` in f32, then ``y`` cast back before ``out_proj``; ``a_log`` is an
f32 parameter whatever the model's dtype. The scan runs under a span
of ``repro_torch.trace``, ``ssm.scan`` (``ssm.step`` in decode), a
profiler range when a profiler runs, so ``launch/profile.py`` can split its device time from the
projections'.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import trace
from repro_torch.models import layers as L

CHUNK = 128


class Mamba(nn.Module):
    """``in_proj``, ``w_bc``, ``w_dt``, ``b_dt``, ``a_log`` (f32), ``d_skip``,
    ``out_proj``: the reference's ``init_mamba`` keys."""

    def __init__(self, d: int, *, expand: int, state: int, dtype, device=None):
        super().__init__()
        di = expand * d
        p = lambda *shape: L._param(shape, dtype, device)  # noqa: E731
        self.in_proj, self.w_bc, self.w_dt = p(d, 2 * di), p(di, 2 * state), p(di, 1)
        self.b_dt, self.d_skip, self.out_proj = p(1), p(di), p(di, d)
        self.a_log = L._param((di, state), torch.float32, device)

    def init_(self, gen: torch.Generator) -> None:
        d, di = self.in_proj.shape[0], self.in_proj.shape[1] // 2
        state, dt = self.a_log.shape[1], self.in_proj.dtype
        self.in_proj.data.copy_(L.truncated_normal(gen, (d, 2 * di), d ** -0.5, dt))
        self.w_bc.data.copy_(L.truncated_normal(gen, (di, 2 * state), di ** -0.5, dt))
        self.w_dt.data.copy_(L.truncated_normal(gen, (di, 1), di ** -0.5, dt))
        self.b_dt.data.fill_(-4.0)          # softplus(-4) ~ a small initial dt
        self.a_log.data.copy_(torch.log(torch.linspace(1.0, float(state), state))[None]
                              .expand(di, state))
        self.d_skip.data.fill_(1.0)
        self.out_proj.data.copy_(L.truncated_normal(gen, (di, d), di ** -0.5, dt))


def axes_mamba() -> dict:
    """Logical axes of ``Mamba``'s parameters (``repro.models.ssm.axes_mamba``)."""
    return {"in_proj": ("embed", "inner"), "w_bc": ("inner", None),
            "w_dt": ("inner", None), "b_dt": (None,),
            "a_log": ("inner", None), "d_skip": ("inner",),
            "out_proj": ("inner", "embed")}


def init_mamba(gen: torch.Generator, d: int, *, expand: int, state: int, dtype) -> Mamba:
    p = Mamba(d, expand=expand, state=state, dtype=dtype, device=gen.device)
    p.init_(gen)
    return p


def _gates(p: Mamba, x: torch.Tensor):
    """Shared projections. x: [..., d] -> (xt, z, dt, b, c); dt [..., 1], b
    and c [..., n] in f32."""
    xt, z = torch.chunk(x @ p.in_proj, 2, dim=-1)          # [..., di] each
    b, c = torch.chunk((xt @ p.w_bc).float(), 2, dim=-1)   # [..., n]
    dt = F.softplus((xt @ p.w_dt + p.b_dt).float())
    return xt, z, dt, b, c


def _output(p: Mamba, y: torch.Tensor, xt: torch.Tensor, z: torch.Tensor,
            dtype) -> torch.Tensor:
    """The skip, the SiLU gate and ``out_proj`` of the scan's f32 ``y``."""
    y = y + xt.float() * p.d_skip.float()
    y = y * F.silu(z.float())
    return y.to(dtype) @ p.out_proj


def apply_mamba(p: Mamba, x: torch.Tensor, *, state: int, return_state: bool = False):
    """Full-sequence chunkwise scan. x: [B, S, d] -> [B, S, d] (or
    (y, {"h": final state [B, d_inner, n]}) when ``return_state``). S must
    be at most ``CHUNK`` or a multiple of it, as the reference asserts."""
    bsz, s, _ = x.shape
    xt, z, dt, bmat, cmat = _gates(p, x)
    di = xt.shape[-1]
    q = min(CHUNK, s)
    if s % q:
        raise ValueError(f"sequence length {s} is neither at most {CHUNK} nor a multiple "
                         f"of it: the chunkwise scan takes whole chunks")
    nc = s // q
    a = -torch.exp(p.a_log)                                   # [di, n]

    def chunks(t):                                            # [B, S, ...] -> [B, nc, q, ...]
        return t.reshape(bsz, nc, q, *t.shape[2:])

    with trace.span("ssm.scan"):
        y, h = _scan(a, chunks(xt.float()), chunks(dt), chunks(bmat), chunks(cmat), state)
    out = _output(p, y.reshape(bsz, s, di), xt, z, x.dtype)
    if return_state:
        return out, {"h": h}
    return out


def _scan(a, xt_c, dt_c, b_c, c_c, state: int):
    """The chunkwise scan over [B, nc, q, ...] chunks: (y [B, nc, q, di] f32,
    the final state [B, di, n])."""
    bsz, nc, q, di = xt_c.shape
    decay = torch.exp(a * dt_c[..., None])                    # [B, nc, q, di, n]
    drive = (dt_c * xt_c)[..., None] * b_c[:, :, :, None, :]
    acc_a = torch.cumprod(decay, dim=2)                       # decay since the chunk's start
    # Steps taken by unbind, whose backward stacks their gradients once (an
    # index per step would write a zeroed full-size gradient per step).
    decays, drives = decay.unbind(2), drive.unbind(2)
    acc_b = [drives[0]]                                       # state driven since it
    for t in range(1, q):
        acc_b.append(decays[t] * acc_b[-1] + drives[t])
    del decay, drive, decays, drives
    acc_b = torch.stack(acc_b, dim=2)
    h = torch.zeros((bsz, di, state), dtype=torch.float32, device=xt_c.device)
    starts = []
    for last_a, last_b in zip(acc_a[:, :, -1].unbind(1), acc_b[:, :, -1].unbind(1)):
        starts.append(h)                                      # the carried state
        h = last_a * h + last_b
    h_all = acc_a * torch.stack(starts, dim=1)[:, :, None] + acc_b
    return torch.einsum("bcqin,bcqn->bcqi", h_all, c_c), h


def init_mamba_state(batch: int, d: int, *, expand: int, state: int,
                     device=None) -> Dict[str, torch.Tensor]:
    return {"h": torch.zeros((batch, expand * d, state), dtype=torch.float32, device=device)}


def decode_mamba(p: Mamba, x: torch.Tensor, cache: Dict[str, torch.Tensor], *, state: int
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-step recurrence. x: [B, 1, d] -> (out [B, 1, d], {"h": new state})."""
    xt, z, dt, bmat, cmat = _gates(p, x[:, 0])                # [B, ...]
    with trace.span("ssm.step"):
        a = -torch.exp(p.a_log)
        decay = torch.exp(a[None] * dt[..., None])            # [B, di, n]
        drive = (dt * xt.float())[..., None] * bmat[:, None, :]
        h = decay * cache["h"] + drive
        y = torch.einsum("bin,bn->bi", h, cmat)
    return _output(p, y, xt, z, x.dtype)[:, None, :], {"h": h}

