"""Shared transformer building blocks: counterpart of ``repro.models.layers``.

The reference keeps parameters in pytrees built by ``init_*`` functions;
here each block is an ``nn.Module`` whose parameter names are the
reference's pytree keys, so ``convert.lm_params_from_jax`` maps one onto the
other by name. Modules allocate their parameters uninitialised; ``init_``
fills them from a ``torch.Generator``. Weights keep the reference's
orientation: a projection is ``x @ w`` with ``w [d_in, d_out]``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))   # Phi(-2)


def truncated_normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    """``std`` times a standard normal truncated to [-2, 2], drawn from ``gen``.

    Inverse-CDF sampling on ``gen``'s device: uniform on [Phi(-2), Phi(2)],
    then ``sqrt(2) * erfinv(2u - 1)``. The reference draws the same
    distribution with ``jax.random.truncated_normal``; the two streams differ.
    """
    u = torch.empty(shape, dtype=torch.float32, device=gen.device)
    u.uniform_(_LO, 1.0 - _LO, generator=gen)
    x = u.mul_(2.0).sub_(1.0).erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return x.mul_(std).to(dtype)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted type of the two, as jnp promotes: f32 frames
    or image memory against bf16 weights is an f32 product."""
    if x.dtype == w.dtype:
        return x @ w
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """RMSNorm or LayerNorm over the last axis, computed in f32 (``apply_norm``)."""

    def __init__(self, kind: str, d: int, *, dtype, device=None):
        super().__init__()
        if kind not in ("rmsnorm", "layernorm"):
            raise ValueError(f"unknown norm kind {kind!r}")
        self.kind = kind
        self.scale = _param((d,), dtype, device)
        self.register_parameter("bias", _param((d,), dtype, device)
                                if kind == "layernorm" else None)

    def init_(self, gen: Optional[torch.Generator] = None) -> None:
        self.scale.data.fill_(1.0)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        if self.kind == "rmsnorm":
            return rms_head_norm(self.scale, x, eps)
        xf = x.float()
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        out = (xf - mean) * torch.rsqrt(var + eps) * self.scale.float()
        return (out + self.bias.float()).to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis in f32: the per-head qk-norm (qwen3),
    x [..., D], scale [D], and ``Norm``'s rmsnorm."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def axes_norm(kind: str) -> dict:
    """Logical axes of ``Norm``'s parameters (``repro.models.layers.axes_norm``)."""
    p = {"scale": ("embed",)}
    if kind == "layernorm":
        p["bias"] = ("embed",)
    return p


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, H, S, D]; positions: [B, S] (or [S])."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)          # [D/2]
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[:, None, :, None].float() * freqs            # [B,1,S,D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense MLP (gated silu or plain gelu)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """``apply_mlp``: gated silu (``w_gate``) or plain tanh-gelu, optional biases."""

    def __init__(self, d: int, ff: int, act: str, use_bias: bool, *, dtype, device=None):
        super().__init__()
        if act not in ("silu", "gelu"):
            raise ValueError(f"unknown activation {act!r}")
        self.act = act
        self.w_up = _param((d, ff), dtype, device)
        self.w_down = _param((ff, d), dtype, device)
        self.register_parameter("w_gate", _param((d, ff), dtype, device)
                                if act == "silu" else None)
        self.register_parameter("b_up", _param((ff,), dtype, device) if use_bias else None)
        self.register_parameter("b_down", _param((d,), dtype, device) if use_bias else None)

    def init_(self, gen: torch.Generator) -> None:
        d, ff = self.w_up.shape
        self.w_up.data.copy_(truncated_normal(gen, (d, ff), d ** -0.5, self.w_up.dtype))
        self.w_down.data.copy_(truncated_normal(gen, (ff, d), ff ** -0.5, self.w_up.dtype))
        if self.w_gate is not None:
            self.w_gate.data.copy_(truncated_normal(gen, (d, ff), d ** -0.5, self.w_up.dtype))
        for b in (self.b_up, self.b_down):
            if b is not None:
                b.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = dot(x, self.w_up)
        if self.b_up is not None:
            up = up + self.b_up
        if self.act == "silu":
            up = F.silu(dot(x, self.w_gate)) * up
        else:
            up = F.gelu(up, approximate="tanh")    # jax.nn.gelu's default
        out = dot(up, self.w_down)
        if self.b_down is not None:
            out = out + self.b_down
        return out


def axes_mlp(act: str, use_bias: bool) -> dict:
    """Logical axes of ``MLP``'s parameters."""
    p = {"w_up": ("embed", "ff"), "w_down": ("ff", "embed")}
    if act == "silu":
        p["w_gate"] = ("embed", "ff")
    if use_bias:
        p["b_up"] = ("ff",)
        p["b_down"] = ("embed",)
    return p


# ---------------------------------------------------------------------------
# Embeddings / unembedding
# ---------------------------------------------------------------------------

class Embed(nn.Module):
    """Token table ``tokens [V, d]``, untied ``unembed [d, V]``, learned ``positions``."""

    def __init__(self, vocab: int, d: int, *, tie: bool, max_positions: int = 0,
                 dtype, device=None):
        super().__init__()
        self.tokens = _param((vocab, d), dtype, device)
        self.register_parameter("unembed", None if tie else _param((d, vocab), dtype, device))
        self.register_parameter("positions", _param((max_positions, d), dtype, device)
                                if max_positions else None)

    def init_(self, gen: torch.Generator) -> None:
        vocab, d = self.tokens.shape
        dt = self.tokens.dtype
        self.tokens.data.copy_(truncated_normal(gen, (vocab, d), d ** -0.5, dt))
        if self.unembed is not None:
            self.unembed.data.copy_(truncated_normal(gen, (d, vocab), d ** -0.5, dt))
        if self.positions is not None:
            self.positions.data.copy_(truncated_normal(gen, self.positions.shape, 0.02, dt))


def axes_embed(*, tie: bool, max_positions: int = 0) -> dict:
    """Logical axes of ``Embed``'s parameters."""
    p = {"tokens": ("vocab", "embed")}
    if not tie:
        p["unembed"] = ("embed", "vocab")
    if max_positions:
        p["positions"] = (None, "embed")
    return p


def embed_tokens(p: Embed, tokens: torch.Tensor, *, scale: bool = True) -> torch.Tensor:
    """Table rows, times sqrt(d) rounded to the working dtype as the reference does."""
    x = p.tokens[tokens]
    if scale:
        x = x * torch.tensor(x.shape[-1] ** 0.5, dtype=x.dtype).item()
    return x


def unembed(p: Embed, x: torch.Tensor, *, softcap: float = 0.0) -> torch.Tensor:
    """Logits in f32; the tied table's transpose unless ``unembed`` exists."""
    logits = x @ p.unembed if p.unembed is not None else x @ p.tokens.T
    logits = logits.float()
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    return logits
