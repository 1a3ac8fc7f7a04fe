"""Mixture-of-experts FFN with top-k routing and capacity-based dispatch.

Counterpart of ``repro.models.moe``: the same token groups, gates, top-k,
per-group capacity and Switch-style aux loss, and the same tokens dropped.
Tokens are split into groups of ``group_len`` along (batch, seq); within a
group each expert takes at most ``capacity`` (token, k) assignments, counted
in flattened (token, k) order, and the rest are dropped (their weight is
lost, the kept weights are not renormalised).

The reference dispatches and combines with one-hot ``[G, T, E, C]`` einsums.
Here the same dispatch is done by index: each (expert, group, slot) holds
the index of its token (an empty slot points at a zero row), the tokens are
gathered into ``[E, G·C, d]`` and each expert weight is one batched
``torch.bmm`` over E; each token then gathers its kept slots' outputs and
sums them, weighted, in one ``bmm`` that accumulates in f32. Empty slots
give exact zeros (silu(0)·0 = gelu(0) = 0, no biases), as in the reference.

Ties among gates resolve as ``jax.lax.top_k`` resolves them, the lower
expert index first (a stable descending sort).

Each phase runs under a span of ``repro_torch.trace`` (``moe.router``,
``moe.dispatch``, ``moe.experts``, ``moe.combine``), a profiler range when
a profiler runs, so ``launch/profile.py`` can split an MoE layer's device
time.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import trace
from repro_torch.models import layers as L


class MoE(nn.Module):
    """``router [d, E]`` (always f32), ``w_up, w_gate [E, d, ff]``, ``w_down [E, ff, d]``;
    ``w_gate`` only for ``act == "silu"``."""

    def __init__(self, d: int, ff: int, num_experts: int, act: str, *, dtype, device=None):
        super().__init__()
        if act not in ("silu", "gelu"):
            raise ValueError(f"unknown activation {act!r}")
        e = num_experts
        self.router = L._param((d, e), torch.float32, device)
        self.w_up = L._param((e, d, ff), dtype, device)
        self.w_down = L._param((e, ff, d), dtype, device)
        self.register_parameter("w_gate", L._param((e, d, ff), dtype, device)
                                if act == "silu" else None)

    def init_(self, gen: torch.Generator) -> None:
        e, d, ff = self.w_up.shape
        dt = self.w_up.dtype
        self.router.data.copy_(L.truncated_normal(gen, (d, e), d ** -0.5, torch.float32))
        self.w_up.data.copy_(L.truncated_normal(gen, (e, d, ff), d ** -0.5, dt))
        self.w_down.data.copy_(L.truncated_normal(gen, (e, ff, d), ff ** -0.5, dt))
        if self.w_gate is not None:
            self.w_gate.data.copy_(L.truncated_normal(gen, (e, d, ff), d ** -0.5, dt))


def axes_moe(act: str) -> dict:
    """Logical axes of ``MoE``'s parameters (``repro.models.moe.axes_moe``)."""
    p = {"router": ("embed", None),
         "w_up": ("experts", "embed", "expert_ff"),
         "w_down": ("experts", "expert_ff", "embed")}
    if act == "silu":
        p["w_gate"] = ("experts", "embed", "expert_ff")
    return p


def init_moe(gen: torch.Generator, d: int, ff: int, num_experts: int, act: str,
             dtype) -> MoE:
    p = MoE(d, ff, num_experts, act, dtype=dtype, device=gen.device)
    p.init_(gen)
    return p


def route(router: torch.Tensor, xt: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt [G, T, d] -> (gates [G, T, E] f32, topw [G, T, k] renormalised,
    topi [G, T, k]); ties give the lower expert index first."""
    gates = torch.softmax(xt.float() @ router, dim=-1)
    sw, si = torch.sort(gates, dim=-1, descending=True, stable=True)
    topw, topi = sw[..., :top_k], si[..., :top_k]
    return gates, topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9), topi


def slot_positions(topi: torch.Tensor, num_experts: int) -> torch.Tensor:
    """[G, T, k]: the number of earlier (token, k) assignments of the same
    group to the same expert, in flattened (token, k) order."""
    g, t, k = topi.shape
    flat = topi.reshape(g, t * k)
    onehot = F.one_hot(flat, num_experts).to(torch.int32)             # [G, T*k, E]
    before = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    return torch.gather(before, 2, flat[..., None])[..., 0].reshape(g, t, k)


def apply_moe(p: MoE, x: torch.Tensor, *, num_experts: int, top_k: int,
              capacity_factor: float, act: str, group_len: int = 512
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (out [B, S, d] in x's dtype, aux loss f32 scalar)."""
    b, s, d = x.shape
    g_len = min(group_len, s)
    if s % g_len:
        raise ValueError(f"sequence length {s} is not a multiple of the MoE group "
                         f"length {g_len}")
    g, e = b * (s // g_len), num_experts
    xt = x.reshape(g, g_len, d)
    cap = max(1, int(capacity_factor * g_len * top_k / e))     # the reference's float math

    with trace.span("moe.router"):
        gates, topw, topi = route(p.router, xt, top_k)
        pos = slot_positions(topi, e)
        keep = pos < cap
    with trace.span("moe.dispatch"):
        # Slot (expert, group, c) at flat index (e·G + g)·C + c holds its
        # token's row of xt padded with a zero row at g_len; dropped
        # assignments write to one spare slot past the end.
        n_slots = e * g * cap
        gi = torch.arange(g, device=x.device)[:, None, None]
        slot = (topi * g + gi) * cap + pos.clamp(max=cap - 1)           # [G, T, k]
        ti = torch.arange(g_len, device=x.device)[None, :, None].expand_as(topi)
        src = torch.full((n_slots + 1,), g_len, dtype=torch.long, device=x.device)
        src[torch.where(keep, slot, n_slots).reshape(-1)] = ti.reshape(-1)
        src = src[:n_slots].view(e, g, cap) + gi.view(1, g, 1) * (g_len + 1)
        xpad = torch.cat([xt, xt.new_zeros(g, 1, d)], dim=1).reshape(g * (g_len + 1), d)
        expert_in = xpad[src.reshape(-1)].view(e, g * cap, d)
    with trace.span("moe.experts"):
        up = torch.bmm(expert_in, p.w_up)
        if act == "silu":
            up = F.silu(torch.bmm(expert_in, p.w_gate)) * up
        else:
            up = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
        expert_out = torch.bmm(up, p.w_down).view(e * g * cap, d)
    with trace.span("moe.combine"):
        # Each token's k slots (a dropped one points at slot 0 with weight
        # 0); the weights in x's dtype, as the reference casts them, summed
        # in f32 by one [1, k] x [k, d] product a token.
        w = (topw * keep).to(x.dtype).reshape(g * g_len, 1, top_k)
        y = expert_out[torch.where(keep, slot, 0).reshape(-1)].view(g * g_len, top_k, d)
        out = torch.bmm(w, y).view(b, s, d)

    # Switch-style aux loss.
    density = F.one_hot(topi[..., 0], e).float().mean(dim=(0, 1))
    aux = e * torch.sum(density * gates.mean(dim=(0, 1)))
    return out, aux
