"""Transformer assembly: counterpart of ``repro.models.transformer``.

The reference stacks each member of a repeating layer group along a leading
``[n_groups]`` axis and scans over groups. Here the model is an
``nn.Module`` with one ``Block`` per layer in ``blocks``, run by a Python
loop; ``convert.lm_params_from_jax`` unstacks the reference's groups. Module
and parameter names follow the reference's pytree keys (``embed.tokens``,
``blocks.<i>.attn.wq``, ...).

With gradients on and ``cfg.remat``, ``forward`` recomputes each group of
``group_size(cfg)`` blocks in the backward pass instead of keeping its
activations (``torch.utils.checkpoint``), as the reference wraps each
group's scan body in ``jax.checkpoint``.

Dense, MoE (``Block.moe``, ``models.moe``) and vlm (a gated ``CrossBlock``
over the image memory after each group, ``cross_blocks.<i>``) build; ssm,
hybrid and audio raise ``NotImplementedError`` when the model is built
(ROADMAP.md, queue 1, item 9). ``sharding.constraints.constrain`` is a no-op
on one card and has no counterpart here.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.config import ModelConfig

PORTED_ARCHS = ("dense", "moe", "vlm")


def group_size(cfg: ModelConfig) -> int:
    """Smallest period covering window pattern + cross-attn insertion."""
    if cfg.arch_type == "ssm":
        return cfg.num_layers  # unrolled
    ws = cfg.windows
    period = 1
    for p in range(1, cfg.num_layers + 1):
        if cfg.num_layers % p:
            continue
        if all(ws[i] == ws[i % p] for i in range(cfg.num_layers)):
            period = p
            break
    if cfg.cross_attn_interval:
        # group must end exactly where a cross block goes
        period = period * cfg.cross_attn_interval // math.gcd(period, cfg.cross_attn_interval)
    return period


def _block_kind(cfg: ModelConfig, layer_idx: int) -> str:
    if cfg.arch_type == "ssm":
        return cfg.block_pattern[layer_idx] if cfg.block_pattern else "mlstm"
    if cfg.arch_type == "hybrid":
        return "hybrid"
    if cfg.is_encdec:
        return "encdec_dec"
    return "attn"


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.arch_type not in PORTED_ARCHS:
        raise NotImplementedError(
            f"{cfg.name}: arch_type {cfg.arch_type!r} is not ported to repro_torch yet; "
            f"only {', '.join(PORTED_ARCHS)} transformers build (ROADMAP.md, queue 1, "
            f"item 9)")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One pre-norm layer of kind ``"attn"``: attention, then the MLP (or,
    for MoE configs, the experts ``moe``)."""

    def __init__(self, cfg: ModelConfig, kind: str, *, device=None):
        super().__init__()
        if kind != "attn":
            raise NotImplementedError(f"block kind {kind!r} is not ported yet "
                                      f"(ROADMAP.md, queue 1, item 9)")
        dt, d = _dtype(cfg), cfg.d_model
        self.ln1 = L.Norm(cfg.norm_kind, d, dtype=dt, device=device)
        self.attn = A.Attention(d, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                                qk_norm=cfg.qk_norm, use_bias=cfg.use_bias, dtype=dt,
                                device=device)
        self.ln2 = L.Norm(cfg.norm_kind, d, dtype=dt, device=device)
        if cfg.is_moe:
            self.moe = M.MoE(d, cfg.d_ff, cfg.num_experts, cfg.act, dtype=dt, device=device)
        else:
            self.mlp = L.MLP(d, cfg.d_ff, cfg.act, cfg.use_bias, dtype=dt, device=device)

    def init_(self, gen: torch.Generator) -> None:
        for m in self.children():
            m.init_(gen)


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str) -> Block:
    bp = Block(cfg, kind, device=gen.device)
    bp.init_(gen)
    return bp


def feed_forward(bp: Block, x: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's ``ln2`` and MLP or experts, added to x: (x, aux loss f32;
    None for an MLP)."""
    h = bp.ln2(x)
    if cfg.is_moe:
        ff, aux = M.apply_moe(bp.moe, h, num_experts=cfg.num_experts,
                              top_k=cfg.experts_per_token,
                              capacity_factor=cfg.capacity_factor, act=cfg.act)
        return x + ff, aux
    return x + bp.mlp(h), None


def attn_block_kv(bp: Block, x: torch.Tensor, cfg: ModelConfig, *, window: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """An ``"attn"`` block over the whole sequence: (x, its (roped) k, v
    [B, Hkv, S, D] for the decode cache, its aux loss or None)."""
    h = bp.ln1(x)
    attn_out, k, v = A.self_attention_kv(
        bp.attn, h, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, window=window, rope_theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm, use_rope=not cfg.is_encdec)
    x, aux = feed_forward(bp, x + attn_out, cfg)
    return x, k, v, aux


def apply_block(bp: Block, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                window: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (x, aux_loss); the aux loss is None for dense blocks."""
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    x, _, _, aux = attn_block_kv(bp, x, cfg, window=window)
    return x, aux


class CrossBlock(nn.Module):
    """Gated image cross-attention (llama-3.2-vision): ``ln``, ``attn``
    (no qk-norm) and a scalar ``gate``, 0 at init."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        dt, d = _dtype(cfg), cfg.d_model
        self.ln = L.Norm(cfg.norm_kind, d, dtype=dt, device=device)
        self.attn = A.Attention(d, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                                qk_norm=False, use_bias=cfg.use_bias, dtype=dt,
                                device=device)
        self.gate = L._param((), dt, device)

    def init_(self, gen: torch.Generator) -> None:
        self.ln.init_(gen)
        self.attn.init_(gen)
        self.gate.data.zero_()


def init_cross_block(gen: torch.Generator, cfg: ModelConfig) -> CrossBlock:
    cp = CrossBlock(cfg, device=gen.device)
    cp.init_(gen)
    return cp


def apply_cross_block(cp: CrossBlock, x: torch.Tensor, memory: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """x + tanh(gate) * cross_attention(ln(x), memory)."""
    out = A.cross_attention(cp.attn, cp.ln(x), memory, num_heads=cfg.num_heads,
                            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim)
    return x + torch.tanh(cp.gate) * out


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class Transformer(nn.Module):
    """``embed``, ``blocks`` (one ``Block`` per layer), ``final_norm``, and
    for vlm configs ``cross_blocks`` (one ``CrossBlock`` per group of
    ``group_size(cfg)`` layers)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        dt = _dtype(cfg)
        self.embed = L.Embed(cfg.vocab_size, cfg.d_model, tie=cfg.tie_embeddings,
                             dtype=dt, device=device)
        self.final_norm = L.Norm(cfg.norm_kind, cfg.d_model, dtype=dt, device=device)
        self.blocks = nn.ModuleList(Block(cfg, _block_kind(cfg, i), device=device)
                                    for i in range(cfg.num_layers))
        if cfg.cross_attn_interval:
            self.cross_blocks = nn.ModuleList(
                CrossBlock(cfg, device=device)
                for _ in range(cfg.num_layers // group_size(cfg)))

    def init_(self, gen: torch.Generator) -> None:
        self.embed.init_(gen)
        self.final_norm.init_(gen)
        for bp in self.blocks:
            bp.init_(gen)
        for cp in getattr(self, "cross_blocks", ()):
            cp.init_(gen)


def init_model(cfg: ModelConfig, *, seed: int = 0, device="cpu") -> Transformer:
    """A model with random weights drawn on ``device`` from a generator seeded
    with ``seed`` (the same seed gives other weights on another device)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = Transformer(cfg, device=device)
    model.init_(gen)
    return model


def check_memory(cfg: ModelConfig, memory: Optional[torch.Tensor]) -> None:
    """A vlm config needs its image memory [B, num_image_tokens, d]; others
    ignore it, as the reference does."""
    if cfg.cross_attn_interval and memory is None:
        raise ValueError(f"{cfg.name} attends to image memory: pass memory= "
                         f"[B, {cfg.num_image_tokens}, {cfg.d_model}]")


def _group(model: Transformer, x: torch.Tensor, aux: torch.Tensor, start: int, g: int,
           memory: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocks ``start .. start + g - 1``, then the group's cross block if the
    config has them: the reference's scan body."""
    cfg = model.cfg
    for i in range(start, start + g):
        x, a = apply_block(model.blocks[i], x, cfg, _block_kind(cfg, i), window=cfg.windows[i])
        if a is not None:
            aux = aux + a
    if cfg.cross_attn_interval:
        x = apply_cross_block(model.cross_blocks[start // g], x, memory, cfg)
    return x, aux


def forward(model: Transformer, tokens: torch.Tensor, *,
            memory: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V] f32, aux loss scalar: the MoE
    layers' summed). ``memory``: vlm image embeddings [B, T, d]."""
    cfg = model.cfg
    check_memory(cfg, memory)
    x = L.embed_tokens(model.embed, tokens)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    g = group_size(cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    for start in range(0, cfg.num_layers, g):
        if remat:
            x, aux_total = checkpoint(_group, model, x, aux_total, start, g, memory,
                                      use_reentrant=False)
        else:
            x, aux_total = _group(model, x, aux_total, start, g, memory)
    x = model.final_norm(x)
    return L.unembed(model.embed, x, softcap=cfg.logit_softcap), aux_total
