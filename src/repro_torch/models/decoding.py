"""Serving paths: prefill (prompt -> cache) and decode_step (1 token + cache).

Counterpart of ``repro.models.decoding`` for attention layers, with their
MLP or MoE experts, and for vlm configs the gated cross blocks at group
boundaries. The cache is a dict ``{"layers": [{"k", "v"} per layer], "pos":
int}``, plus ``"memory"`` (the image embeddings) when given; a Python loop
over layers takes the place of the reference's ``lax.scan`` over groups.
Prefill attention runs through ``kernels.ops.mha`` (the CUDA
``flash_attention`` kernel on the card); decode attention and cross
attention are plain PyTorch, as in the reference. As the reference does,
each decode step recomputes the memory's k and v in every cross block, and
serving drops the MoE aux loss.

Windowed layers keep a ring buffer of ``window`` slots; after prefill the last
``window`` kv entries are rolled into ring order so decode can continue with
``slot = pos % window``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (Transformer, _check_ported, apply_cross_block,
                                            attn_block_kv, check_memory, feed_forward,
                                            group_size)

Cache = Dict[str, Any]


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *, device="cpu",
               memory: Optional[torch.Tensor] = None) -> Cache:
    """Zeroed cache sized for a maximum context of ``seq_len``, holding
    ``memory`` when given."""
    _check_ported(cfg)
    dt = getattr(torch, cfg.dtype)
    layers = [A.init_kv_cache(batch, cfg.num_kv_heads, cfg.head_dim, seq_len=seq_len,
                              window=w, dtype=dt, device=device)
              for w in cfg.windows]
    cache: Cache = {"layers": layers, "pos": 0}
    if memory is not None:
        cache["memory"] = memory
    return cache


def _cross(model: Transformer, x: torch.Tensor, layer: int,
           memory: Optional[torch.Tensor]) -> torch.Tensor:
    """The vlm cross block that follows ``layer`` if it ends a group."""
    cfg = model.cfg
    g = group_size(cfg)
    if cfg.cross_attn_interval and (layer + 1) % g == 0:
        x = apply_cross_block(model.cross_blocks[layer // g], x, memory, cfg)
    return x


def decode_step(model: Transformer, cache: Cache, token: torch.Tensor
                ) -> Tuple[torch.Tensor, Cache]:
    """token: [B, 1] int -> (logits [B, V] f32, cache), the cache updated in place."""
    cfg = model.cfg
    x = L.embed_tokens(model.embed, token)
    pos = cache["pos"]
    memory = cache.get("memory")
    for i, (bp, entry, w) in enumerate(zip(model.blocks, cache["layers"], cfg.windows)):
        h = bp.ln1(x)
        attn_out, _ = A.decode_self_attention(
            bp.attn, h, entry, pos, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, window=w,
            rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm, use_rope=not cfg.is_encdec)
        x, _ = feed_forward(bp, x + attn_out, cfg)
        x = _cross(model, x, i, memory)
    x = model.final_norm(x)
    logits = L.unembed(model.embed, x, softcap=cfg.logit_softcap)
    cache["pos"] = pos + 1
    return logits[:, 0], cache


def prefill(model: Transformer, tokens: torch.Tensor, *, max_len: Optional[int] = None,
            memory: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Cache]:
    """tokens [B, S] -> (last-position logits [B, V] f32, decode-ready cache).

    ``max_len``: total context budget the cache must hold (>= S); defaults S.
    ``memory``: vlm image embeddings [B, T, d], kept in the cache for decode.
    """
    cfg = model.cfg
    check_memory(cfg, memory)
    b, s = tokens.shape
    max_len = max_len or s
    if max_len < s:
        raise ValueError(f"max_len {max_len} is shorter than the prompt ({s})")
    x = L.embed_tokens(model.embed, tokens)
    cache = init_cache(cfg, b, max_len, device=x.device, memory=memory)
    for i, (bp, tgt, w) in enumerate(zip(model.blocks, cache["layers"], cfg.windows)):
        x, k, v, _ = attn_block_kv(bp, x, cfg, window=w)
        x = _cross(model, x, i, memory)
        size = tgt["k"].shape[2]
        if size >= s:   # global (or window >= prompt): plain left-aligned
            tgt["k"][:, :, :s] = k
            tgt["v"][:, :, :s] = v
        else:           # ring buffer: keep the last `size`, rolled to slot order
            tgt["k"].copy_(torch.roll(k[:, :, s - size:], s % size, dims=2))
            tgt["v"].copy_(torch.roll(v[:, :, s - size:], s % size, dims=2))
    cache["pos"] = s
    x_last = model.final_norm(x[:, -1])
    return L.unembed(model.embed, x_last, softcap=cfg.logit_softcap), cache
