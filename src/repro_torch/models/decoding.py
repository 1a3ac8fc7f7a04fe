"""Serving paths: prefill (prompt -> cache) and decode_step (1 token + cache).

Counterpart of ``repro.models.decoding`` for every family. The cache is a
dict ``{"layers": [one entry per layer], "pos": int}``, plus ``"memory"``
when given: a vlm's image embeddings, or an encoder-decoder config's
encoder output (prefill runs the encoder once over the frames and keeps its
output here). Each layer's entry holds what its kind carries: ``k, v`` for
attention kinds, the mamba state ``h`` besides them for hybrid blocks,
``c, n`` for mLSTM and ``c, n, h, m`` for sLSTM. A Python loop over layers
takes the place of the reference's ``lax.scan`` over groups.

Prefill attention runs through ``kernels.ops.mha`` (the CUDA
``flash_attention`` kernel on the card); decode attention, cross attention,
the encoder's attention and the recurrences are plain PyTorch, as in the
reference. As the reference does, each decode step recomputes the memory's
k and v in every cross block (the vlm's gated blocks and whisper's
per-layer ones), and serving drops the MoE aux loss.

Windowed layers keep a ring buffer of ``window`` slots; after prefill the last
``window`` kv entries are rolled into ring order so decode can continue with
``slot = pos % window``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (Transformer, _block_kind, apply_cross_block,
                                            check_memory, encode_memory, feed_forward,
                                            group_size, positions, run_block)

Cache = Dict[str, Any]


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *, device="cpu",
               memory: Optional[torch.Tensor] = None) -> Cache:
    """Zeroed cache sized for a maximum context of ``seq_len``, holding
    ``memory`` when given."""
    dt = getattr(torch, cfg.dtype)
    layers: List[Dict[str, torch.Tensor]] = []
    for i, w in enumerate(cfg.windows):
        kind = _block_kind(cfg, i)
        entry: Dict[str, torch.Tensor] = {}
        if kind in ("attn", "hybrid", "encdec_dec"):
            entry.update(A.init_kv_cache(batch, cfg.num_kv_heads, cfg.head_dim,
                                         seq_len=seq_len, window=w, dtype=dt, device=device))
        if kind == "hybrid":
            entry.update(S.init_mamba_state(batch, cfg.d_model, expand=cfg.ssm_expand,
                                            state=cfg.ssm_state, device=device))
        if kind == "mlstm":
            entry.update(X.init_mlstm_state(batch, cfg.d_model, cfg.num_heads,
                                            expand=cfg.ssm_expand, device=device))
        if kind == "slstm":
            entry.update(X.init_slstm_state(batch, cfg.d_model, device=device))
        layers.append(entry)
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


def _decode_layer(model: Transformer, i: int, x: torch.Tensor, entry: Dict[str, torch.Tensor],
                  pos: int, memory: Optional[torch.Tensor]) -> torch.Tensor:
    """Layer ``i`` on one token x [B, 1, d]; ``entry`` updated in place."""
    cfg = model.cfg
    bp, kind = model.blocks[i], _block_kind(cfg, i)
    h = bp.ln1(x)
    if kind == "mlstm":
        out, st = X.decode_mlstm(bp.mlstm, h, entry, cfg.num_heads)
        entry.update(st)
        return x + out
    if kind == "slstm":
        out, st = X.decode_slstm(bp.slstm, h, entry)
        entry.update(st)
        return x + out
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim)
    attn_out, _ = A.decode_self_attention(
        bp.attn, h, entry, pos, window=cfg.windows[i], rope_theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm, use_rope=not cfg.is_encdec, **kw)
    if kind == "hybrid":
        mamba_out, st = S.decode_mamba(bp.mamba, h, entry, state=cfg.ssm_state)
        attn_out = 0.5 * (attn_out + mamba_out)
        entry.update(st)
    x = x + attn_out
    if kind == "encdec_dec":
        x = x + A.cross_attention(bp.cross, bp.ln_cross(x), memory, **kw)
    x, _ = feed_forward(bp, x, cfg)
    return _cross(model, x, i, memory)


def decode_step(model: Transformer, cache: Cache, token: torch.Tensor
                ) -> Tuple[torch.Tensor, Cache]:
    """token: [B, 1] int -> (logits [B, V] f32, cache), the cache updated in place."""
    cfg = model.cfg
    x = L.embed_tokens(model.embed, token)
    pos = cache["pos"]
    if cfg.is_encdec:
        x = x + positions(model, pos, 1)
    for i, entry in enumerate(cache["layers"]):
        x = _decode_layer(model, i, x, entry, pos, cache.get("memory"))
    x = model.final_norm(x)
    logits = L.unembed(model.embed, x, softcap=cfg.logit_softcap)
    cache["pos"] = pos + 1
    return logits[:, 0], cache


def prefill(model: Transformer, tokens: torch.Tensor, *, max_len: Optional[int] = None,
            memory: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Cache]:
    """tokens [B, S] -> (last-position logits [B, V] f32, decode-ready cache).

    ``max_len``: total context budget the cache must hold (>= S); defaults S.
    ``memory``: vlm image embeddings [B, T, d], kept in the cache for decode,
    or an encoder-decoder config's frames [B, T, d], whose encoding is kept.
    """
    cfg = model.cfg
    check_memory(cfg, memory)
    b, s = tokens.shape
    max_len = max_len or s
    if max_len < s:
        raise ValueError(f"max_len {max_len} is shorter than the prompt ({s})")
    x = L.embed_tokens(model.embed, tokens)
    if cfg.is_encdec:
        x = x + positions(model, 0, s)
        memory = encode_memory(model, memory)
    cache = init_cache(cfg, b, max_len, device=x.device, memory=memory)
    for i, (bp, tgt) in enumerate(zip(model.blocks, cache["layers"])):
        x, entry, _ = run_block(bp, x, cfg, _block_kind(cfg, i), window=cfg.windows[i],
                                memory=memory)
        x = _cross(model, x, i, memory)
        if "k" in entry:
            k, v = entry.pop("k"), entry.pop("v")
            size = tgt["k"].shape[2]
            if size >= s:   # global (or window >= prompt): plain left-aligned
                tgt["k"][:, :, :s] = k
                tgt["v"][:, :, :s] = v
            else:           # ring buffer: keep the last `size`, rolled to slot order
                tgt["k"].copy_(torch.roll(k[:, :, s - size:], s % size, dims=2))
                tgt["v"].copy_(torch.roll(v[:, :, s - size:], s % size, dims=2))
        tgt.update(entry)   # recurrent states: h, c, n, m
    cache["pos"] = s
    x_last = model.final_norm(x[:, -1])
    return L.unembed(model.embed, x_last, softcap=cfg.logit_softcap), cache
