"""Transformer assembly for all six architecture families: counterpart of
``repro.models.transformer``.

The reference stacks each member of a repeating layer group along a leading
``[n_groups]`` axis and scans over groups (the ssm family keeps an unrolled
per-layer list). Here the model is an ``nn.Module`` with one ``Block`` per
layer in ``blocks``, run by a Python loop; ``convert.lm_params_from_jax``
unstacks the reference's groups. Module and parameter names follow the
reference's pytree keys (``embed.tokens``, ``blocks.<i>.attn.wq``,
``blocks.<i>.mamba.in_proj``, ``blocks.<i>.slstm.r_in``,
``encoder.blocks.<i>.attn.wq``, ...).

Every kind of block builds: ``"attn"`` (dense and MoE), ``"hybrid"``
(attention and a mamba mixer side by side, averaged: hymba),
``"encdec_dec"`` (a per-layer cross-attention over the encoder's output
after self-attention: whisper's decoder), ``"encoder"`` (non-causal plain
attention: whisper's encoder), ``"mlstm"`` and ``"slstm"`` (xlstm). A vlm
has a gated ``CrossBlock`` over the image memory after each group
(``cross_blocks.<i>``); an encoder-decoder config has ``encoder``
(``positions``, ``blocks``, ``final_norm``) and learned decoder positions
``embed.positions``.

With gradients on and ``cfg.remat``, ``forward`` recomputes each group of
``group_size(cfg)`` blocks in the backward pass instead of keeping its
activations (``torch.utils.checkpoint``), as the reference wraps each
group's scan body in ``jax.checkpoint``; the encoder recomputes each layer,
and the ssm family keeps everything, as in the reference. A hybrid block's
mamba scan is checkpointed on its own as well: within a recomputed group its
f32 ``[B, S, d_inner, n]`` intermediates would otherwise be kept for every
layer of the group at once. That changes memory, never the numbers.
``sharding.constraints.constrain`` is a no-op on one card and has no
counterpart here.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import trace
from repro_torch.core.fedgl import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X
from repro_torch.models.config import ModelConfig

ATTN_KINDS = ("attn", "hybrid", "encdec_dec", "encoder")


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


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One pre-norm layer of ``kind`` (``init_block``'s kinds). Attention
    kinds hold ``ln1``, ``attn``, ``ln2`` and the MLP (or, for MoE configs,
    the experts ``moe``); ``"hybrid"`` adds ``mamba``, ``"encdec_dec"``
    ``ln_cross`` and ``cross`` (no qk-norm). ``"mlstm"`` and ``"slstm"``
    hold ``ln1`` and their mixer."""

    def __init__(self, cfg: ModelConfig, kind: str, *, device=None):
        super().__init__()
        if kind not in ATTN_KINDS + ("mlstm", "slstm"):
            raise ValueError(f"unknown block kind {kind!r}")
        dt, d = _dtype(cfg), cfg.d_model
        self.ln1 = L.Norm(cfg.norm_kind, d, dtype=dt, device=device)
        if kind == "mlstm":
            self.mlstm = X.MLSTM(d, cfg.num_heads, expand=cfg.ssm_expand, dtype=dt,
                                 device=device)
            return
        if kind == "slstm":
            self.slstm = X.SLSTM(d, dtype=dt, device=device)
            return
        self.attn = A.Attention(d, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                                qk_norm=cfg.qk_norm, use_bias=cfg.use_bias, dtype=dt,
                                device=device)
        self.ln2 = L.Norm(cfg.norm_kind, d, dtype=dt, device=device)
        if cfg.is_moe:
            self.moe = M.MoE(d, cfg.d_ff, cfg.num_experts, cfg.act, dtype=dt, device=device)
        else:
            self.mlp = L.MLP(d, cfg.d_ff, cfg.act, cfg.use_bias, dtype=dt, device=device)
        if kind == "hybrid":
            self.mamba = S.Mamba(d, expand=cfg.ssm_expand, state=cfg.ssm_state, dtype=dt,
                                 device=device)
        if kind == "encdec_dec":
            self.ln_cross = L.Norm(cfg.norm_kind, d, dtype=dt, device=device)
            self.cross = A.Attention(d, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                                     qk_norm=False, use_bias=cfg.use_bias, dtype=dt,
                                     device=device)

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


def _mamba(bp: Block, h: torch.Tensor, cfg: ModelConfig):
    """A hybrid block's mamba over h: (out, {"h": final state}), checkpointed
    on its own when the group around it is recomputed."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(S.apply_mamba, bp.mamba, h, state=cfg.ssm_state, return_state=True,
                          use_reentrant=False)
    return S.apply_mamba(bp.mamba, h, state=cfg.ssm_state, return_state=True)


def run_block(bp: Block, x: torch.Tensor, cfg: ModelConfig, kind: str, *, window: int,
              memory: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Optional[torch.Tensor]]:
    """A block over the whole sequence: (x, the layer's decode state, its aux
    loss or None). The state is what the reference's prefill keeps: the
    (roped) k, v [B, Hkv, S, D] of a causal attention kind, a hybrid's mamba
    ``h``, an mLSTM's ``c, n``, an sLSTM's ``c, n, h, m``; an ``"encoder"``
    block keeps none. ``memory``: the encoder's output, for ``"encdec_dec"``."""
    entry: Dict[str, torch.Tensor] = {}
    if kind == "mlstm":
        out, entry = X.apply_mlstm(bp.mlstm, bp.ln1(x), cfg.num_heads, return_state=True)
        return x + out, entry, None
    if kind == "slstm":
        out, entry = X.apply_slstm(bp.slstm, bp.ln1(x), cfg.num_heads, return_state=True)
        return x + out, entry, None
    h = bp.ln1(x)
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim)
    if kind == "encoder":   # non-causal plain attention of h over itself
        attn_out = A.cross_attention(bp.attn, h, h, qk_norm=cfg.qk_norm, **kw)
    else:
        attn_out, entry["k"], entry["v"] = A.self_attention_kv(
            bp.attn, h, window=window, rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
            use_rope=not cfg.is_encdec, **kw)
    if kind == "hybrid":
        mamba_out, st = _mamba(bp, h, cfg)
        attn_out = 0.5 * (attn_out + mamba_out)     # parallel heads (hymba)
        entry.update(st)
    x = x + attn_out
    if kind == "encdec_dec":
        x = x + A.cross_attention(bp.cross, bp.ln_cross(x), memory, **kw)
    x, aux = feed_forward(bp, x, cfg)
    return x, entry, aux


def apply_block(bp: Block, x: torch.Tensor, cfg: ModelConfig, kind: str, *, window: int,
                memory: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (x, aux_loss); the aux loss is None for blocks without experts."""
    x, _, aux = run_block(bp, x, cfg, kind, window=window, memory=memory)
    return x, aux


def axes_block(cfg: ModelConfig, kind: str) -> Dict[str, Tuple]:
    """Logical axes of a ``Block``'s parameters by their names within it
    (``attn.wq``, ...): the reference's ``axes_block`` without its stacked
    ``layers`` axis, which the port's per-layer blocks do not have."""
    p: Dict[str, dict] = {"ln1": L.axes_norm(cfg.norm_kind)}
    if kind == "mlstm":
        p["mlstm"] = X.axes_mlstm()
    elif kind == "slstm":
        p["slstm"] = X.axes_slstm()
    else:
        p["attn"] = A.axes_attention(qk_norm=cfg.qk_norm, use_bias=cfg.use_bias)
        p["ln2"] = L.axes_norm(cfg.norm_kind)
        if cfg.is_moe:
            p["moe"] = M.axes_moe(cfg.act)
        else:
            p["mlp"] = L.axes_mlp(cfg.act, cfg.use_bias)
    if kind == "hybrid":
        p["mamba"] = S.axes_mamba()
    if kind == "encdec_dec":
        p["ln_cross"] = L.axes_norm(cfg.norm_kind)
        p["cross"] = A.axes_attention(qk_norm=False, use_bias=cfg.use_bias)
    return _flat(p)


def axes_cross_block(cfg: ModelConfig) -> Dict[str, Tuple]:
    """Logical axes of a ``CrossBlock``'s parameters."""
    return _flat({"ln": L.axes_norm(cfg.norm_kind),
                  "attn": A.axes_attention(qk_norm=False, use_bias=cfg.use_bias),
                  "gate": ()})


def _flat(tree: dict, prefix: str = "") -> Dict[str, Tuple]:
    out: Dict[str, Tuple] = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[prefix + key] = tuple(val)
    return out


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

class Encoder(nn.Module):
    """Whisper's encoder over the stub front end's frames: learned
    ``positions`` [encoder_seq, d], ``blocks`` of kind ``"encoder"``,
    ``final_norm``."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        dt, d = _dtype(cfg), cfg.d_model
        self.positions = L._param((cfg.encoder_seq, d), dt, device)
        self.blocks = nn.ModuleList(Block(cfg, "encoder", device=device)
                                    for _ in range(cfg.encoder_layers))
        self.final_norm = L.Norm(cfg.norm_kind, d, dtype=dt, device=device)

    def init_(self, gen: torch.Generator) -> None:
        self.positions.data.copy_(L.truncated_normal(gen, tuple(self.positions.shape), 0.02,
                                                     self.positions.dtype))
        for bp in self.blocks:
            bp.init_(gen)
        self.final_norm.init_(gen)


class Transformer(nn.Module):
    """``embed`` (with decoder ``positions`` for an encoder-decoder config),
    ``blocks`` (one ``Block`` per layer, of ``_block_kind``), ``final_norm``;
    for vlm configs ``cross_blocks`` (one ``CrossBlock`` per group of
    ``group_size(cfg)`` layers), for encoder-decoder configs ``encoder``."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        dt = _dtype(cfg)
        self.embed = L.Embed(cfg.vocab_size, cfg.d_model, tie=cfg.tie_embeddings,
                             max_positions=cfg.max_target_positions if cfg.is_encdec else 0,
                             dtype=dt, device=device)
        self.final_norm = L.Norm(cfg.norm_kind, cfg.d_model, dtype=dt, device=device)
        self.blocks = nn.ModuleList(Block(cfg, _block_kind(cfg, i), device=device)
                                    for i in range(cfg.num_layers))
        if cfg.cross_attn_interval:
            self.cross_blocks = nn.ModuleList(
                CrossBlock(cfg, device=device)
                for _ in range(cfg.num_layers // group_size(cfg)))
        if cfg.is_encdec:
            self.encoder = Encoder(cfg, device=device)

    def init_(self, gen: torch.Generator) -> None:
        self.embed.init_(gen)
        self.final_norm.init_(gen)
        for bp in self.blocks:
            bp.init_(gen)
        for cp in getattr(self, "cross_blocks", ()):
            cp.init_(gen)
        if self.cfg.is_encdec:
            self.encoder.init_(gen)


def init_model(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Transformer:
    """A model with random weights drawn on ``device`` from a generator seeded
    with ``seed`` (the same seed gives other weights on another device).
    Without a GPU this raises unless ``device="cpu"``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = Transformer(cfg, device=dev)
    model.init_(gen)
    return model


def model_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    """Logical axes of every parameter of ``Transformer(cfg)``, keyed by its
    name in ``named_parameters()`` (``blocks.{i}.attn.wq``, ...): the
    counterpart of the reference's ``model_axes``. A per-layer leaf has no
    ``layers`` axis (the reference's stacked dim, which never shards)."""
    axes = _flat({"embed": L.axes_embed(
        tie=cfg.tie_embeddings, max_positions=cfg.max_target_positions if cfg.is_encdec else 0),
        "final_norm": L.axes_norm(cfg.norm_kind)})
    for i in range(cfg.num_layers):
        axes.update(_flat(axes_block(cfg, _block_kind(cfg, i)), f"blocks.{i}."))
    if cfg.cross_attn_interval:
        for i in range(cfg.num_layers // group_size(cfg)):
            axes.update(_flat(axes_cross_block(cfg), f"cross_blocks.{i}."))
    if cfg.is_encdec:
        axes["encoder.positions"] = (None, "embed")
        for i in range(cfg.encoder_layers):
            axes.update(_flat(axes_block(cfg, "encoder"), f"encoder.blocks.{i}."))
        axes.update(_flat(L.axes_norm(cfg.norm_kind), "encoder.final_norm."))
    return axes


def check_memory(cfg: ModelConfig, memory: Optional[torch.Tensor]) -> None:
    """A vlm config needs its image memory [B, num_image_tokens, d], an
    encoder-decoder config its frames [B, T <= encoder_seq, d]; others
    ignore it, as the reference does."""
    if cfg.cross_attn_interval and memory is None:
        raise ValueError(f"{cfg.name} attends to image memory: pass memory= "
                         f"[B, {cfg.num_image_tokens}, {cfg.d_model}]")
    if cfg.is_encdec and memory is None:
        raise ValueError(f"{cfg.name} encodes audio frames: pass memory= "
                         f"[B, {cfg.encoder_seq}, {cfg.d_model}]")


def positions(model: Transformer, start: int, length: int) -> torch.Tensor:
    """The decoder's learned positions of ``start .. start + length - 1``,
    modulo the table's length as in the reference: [length, d]."""
    table = model.embed.positions
    idx = torch.arange(start, start + length, device=table.device) % table.shape[0]
    return table[idx]


def _encoder_layer(bp: Block, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return apply_block(bp, x, cfg, "encoder", window=0)[0]


def encode_memory(model: Transformer, frames: torch.Tensor) -> torch.Tensor:
    """The encoder over precomputed front-end frames [B, T, d] (``T <=
    encoder_seq``): frames plus positions, the encoder blocks (each
    recomputed in the backward pass under ``cfg.remat``), the final norm.
    f32 frames against bf16 weights run in f32, as jnp promotes. Runs under
    the profiler range ``encoder`` (``launch/profile.py``)."""
    cfg, enc = model.cfg, model.encoder
    with trace.span("encoder"):
        x = frames + enc.positions[:frames.shape[1]]
        remat = cfg.remat and torch.is_grad_enabled()
        for bp in enc.blocks:
            if remat:
                x = checkpoint(_encoder_layer, bp, x, cfg, use_reentrant=False)
            else:
                x = _encoder_layer(bp, x, cfg)
        return enc.final_norm(x)


def _group(model: Transformer, x: torch.Tensor, aux: torch.Tensor, start: int, g: int,
           memory: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocks ``start .. start + g - 1``, then the group's cross block if the
    config has them: the reference's scan body."""
    cfg = model.cfg
    for i in range(start, start + g):
        x, a = apply_block(model.blocks[i], x, cfg, _block_kind(cfg, i), window=cfg.windows[i],
                           memory=memory)
        if a is not None:
            aux = aux + a
    if cfg.cross_attn_interval:
        x = apply_cross_block(model.cross_blocks[start // g], x, memory, cfg)
    return x, aux


def forward(model: Transformer, tokens: torch.Tensor, *,
            memory: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V] f32, aux loss scalar: the MoE
    layers' summed). ``memory``: vlm image embeddings [B, T, d], or an
    encoder-decoder config's frames [B, T, d], encoded here."""
    cfg = model.cfg
    check_memory(cfg, memory)
    x = L.embed_tokens(model.embed, tokens)
    if cfg.is_encdec:
        x = x + positions(model, 0, tokens.shape[1])
        memory = encode_memory(model, memory)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    g = group_size(cfg)
    # The ssm family's layers keep their activations, as the reference's loop does.
    remat = cfg.remat and torch.is_grad_enabled() and cfg.arch_type != "ssm"
    for start in range(0, cfg.num_layers, g):
        if remat:
            x, aux_total = checkpoint(_group, model, x, aux_total, start, g, memory,
                                      use_reentrant=False)
        else:
            x, aux_total = _group(model, x, aux_total, start, g, memory)
    x = model.final_norm(x)
    return L.unembed(model.embed, x, softcap=cfg.logit_softcap), aux_total
