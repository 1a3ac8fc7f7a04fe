"""GQA self-attention with RoPE, qk-norm, sliding windows and a KV cache.

Counterpart of ``repro.models.attention``. Prefill and training attention go
through ``kernels.ops.mha``: the CUDA ``flash_attention`` kernels for a CUDA
tensor (in training, the forward that keeps each row's log-sum-exp and the
backward kernel), their plain versions for a CPU tensor. Decode (one token
against the cache) and ``cross_attention`` (non-causal, over image memory)
stay plain PyTorch, as the reference's are plain jnp.

Sliding-window layers keep a ring-buffer cache of ``window`` entries; global
layers keep the full-sequence cache. window == 0 means global.

``_sdpa_chunked`` is the reference's attention over query chunks; its one
caller is the dry-run's ``--attention-impl chunked`` (``launch.dryrun``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch import trace
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L


class Attention(nn.Module):
    """Projections ``wq, wk, wv, wo``, optional ``q_norm, k_norm`` and biases."""

    def __init__(self, d: int, num_heads: int, num_kv_heads: int, head_dim: int, *,
                 qk_norm: bool, use_bias: bool, dtype, device=None):
        super().__init__()
        hq, hkv = num_heads * head_dim, num_kv_heads * head_dim
        p = lambda *shape: L._param(shape, dtype, device)  # noqa: E731
        self.wq, self.wk, self.wv, self.wo = p(d, hq), p(d, hkv), p(d, hkv), p(hq, d)
        for name, shape in (("q_norm", (head_dim,)), ("k_norm", (head_dim,))):
            self.register_parameter(name, p(*shape) if qk_norm else None)
        for name, size in (("bq", hq), ("bk", hkv), ("bv", hkv), ("bo", d)):
            self.register_parameter(name, p(size) if use_bias else None)

    def init_(self, gen: torch.Generator) -> None:
        d, hq = self.wq.shape
        dt = self.wq.dtype
        self.wq.data.copy_(L.truncated_normal(gen, tuple(self.wq.shape), d ** -0.5, dt))
        self.wk.data.copy_(L.truncated_normal(gen, tuple(self.wk.shape), d ** -0.5, dt))
        self.wv.data.copy_(L.truncated_normal(gen, tuple(self.wv.shape), d ** -0.5, dt))
        self.wo.data.copy_(L.truncated_normal(gen, tuple(self.wo.shape), hq ** -0.5, dt))
        for t in (self.q_norm, self.k_norm):
            if t is not None:
                t.data.fill_(1.0)
        for t in (self.bq, self.bk, self.bv, self.bo):
            if t is not None:
                t.data.zero_()


def axes_attention(*, qk_norm: bool, use_bias: bool) -> dict:
    """Logical axes of ``Attention``'s parameters (``repro.models.attention.axes_attention``)."""
    p = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
         "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}
    if qk_norm:
        p["q_norm"] = (None,)
        p["k_norm"] = (None,)
    if use_bias:
        p["bq"] = ("heads",)
        p["bk"] = ("kv_heads",)
        p["bv"] = ("kv_heads",)
        p["bo"] = ("embed",)
    return p


def init_attention(gen: torch.Generator, d: int, num_heads: int, num_kv_heads: int,
                   head_dim: int, *, qk_norm: bool, use_bias: bool, dtype) -> Attention:
    p = Attention(d, num_heads, num_kv_heads, head_dim, qk_norm=qk_norm,
                  use_bias=use_bias, dtype=dtype, device=gen.device)
    p.init_(gen)
    return p


def _bias(t: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    return t if b is None else t + b


def _project_qkv(p: Attention, x: torch.Tensor, xkv: torch.Tensor, num_heads: int,
                 num_kv_heads: int, head_dim: int, qk_norm: bool):
    """q [B, Hq, S, D], k and v [B, Hkv, Skv, D]; k and v in the promoted
    type of xkv and the weights."""
    b, s = x.shape[0], x.shape[1]
    skv = xkv.shape[1]
    q = _bias(L.dot(x, p.wq), p.bq).reshape(b, s, num_heads, head_dim).transpose(1, 2)
    k = _bias(L.dot(xkv, p.wk), p.bk).reshape(b, skv, num_kv_heads, head_dim).transpose(1, 2)
    v = _bias(L.dot(xkv, p.wv), p.bv).reshape(b, skv, num_kv_heads, head_dim).transpose(1, 2)
    if qk_norm:
        q = L.rms_head_norm(p.q_norm, q)
        k = L.rms_head_norm(p.k_norm, k)
    return q, k, v


def _sdpa(q, k, v, *, causal: bool, window: int, q_offset: int = 0,
          kv_valid_len: Optional[int] = None) -> torch.Tensor:
    """Plain attention with f32 math. q: [B,H,Sq,D], k/v: [B,Hkv,Skv,D].

    Query i sits at position ``i + q_offset``; masked logits are -1e30, as
    in the reference.
    """
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, hkv, hq // hkv, sq, dh)
    logits = (qf @ k.float()[:, :, None].transpose(-1, -2)) / (dh ** 0.5)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = kpos <= qpos if causal else torch.ones((sq, skv), dtype=torch.bool,
                                                  device=q.device)
    if window:
        mask = mask & (kpos > qpos - window)
    if kv_valid_len is not None:
        mask = mask & (kpos < kv_valid_len)
    probs = torch.softmax(logits.masked_fill(~mask, -1e30), dim=-1)
    out = probs @ v.float()[:, :, None]
    return out.reshape(b, hq, sq, dh).to(q.dtype)


def _sdpa_chunked(q, k, v, *, causal: bool, window: int, chunk: int = 1024,
                  band: bool = True) -> torch.Tensor:
    """``_sdpa`` over query chunks of ``chunk`` rows, so only ``[chunk x
    Skv]`` score slabs exist at once; the same math as the reference's
    ``_sdpa_chunked`` (f32 scores, masked logits -1e30, queries end-aligned
    with the keys), with kv heads grouped instead of repeated.

    A causal windowed layer with ``band`` (the reference's default, which
    its ``REPRO_DISABLE_WINDOW_BAND`` environment switch turns off) scores
    each chunk against only the band of keys it can see: ``chunk`` rounded
    up past ``window + chunk``, the keys padded at the front so that every
    band has that width. A ragged ``Sq`` takes one chunk.
    """
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    chunk = min(chunk, sq)
    if sq % chunk:
        chunk = sq
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]     # [B, Hkv, 1, Skv, D]
    offset = skv - sq
    width = 0
    if band and window and causal and window + chunk < skv:
        width = chunk * -(-(window + chunk) // chunk)          # a multiple of chunk
        kf = torch.nn.functional.pad(kf, (0, 0, width, 0))
        vf = torch.nn.functional.pad(vf, (0, 0, width, 0))
    rows = torch.arange(chunk, device=q.device)[:, None]
    outs = []
    for ci in range(sq // chunk):
        qb = q[:, :, ci * chunk:(ci + 1) * chunk].float().reshape(b, hkv, g, chunk, dh)
        if width:
            start = ci * chunk + offset        # the band-padded keys' start for this chunk
            kb, vb = (t[:, :, :, start:start + width + chunk] for t in (kf, vf))
            qpos, kpos = rows + width, torch.arange(width + chunk, device=q.device)[None]
            mask = (kpos <= qpos) & (kpos > qpos - window) & (kpos + start >= width)
        else:
            kb, vb = kf, vf
            qpos, kpos = rows + ci * chunk + offset, torch.arange(skv, device=q.device)[None]
            mask = kpos <= qpos if causal else torch.ones_like(kpos <= qpos)
            if window:
                mask = mask & (kpos > qpos - window)
        logits = (qb @ kb.transpose(-1, -2)) / (dh ** 0.5)
        probs = torch.softmax(logits.masked_fill(~mask, -1e30), dim=-1)
        outs.append(probs @ vb)
    return torch.cat(outs, dim=3).reshape(b, hq, sq, dh).to(q.dtype)


def _merge_heads(out: torch.Tensor) -> torch.Tensor:
    b, h, s, dh = out.shape
    return out.transpose(1, 2).reshape(b, s, h * dh)


def self_attention_kv(p: Attention, x: torch.Tensor, *, num_heads: int,
                      num_kv_heads: int, head_dim: int, window: int = 0,
                      rope_theta: float = 10000.0, qk_norm: bool = False,
                      positions: Optional[torch.Tensor] = None, use_rope: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence causal self-attention (prefill) through ``ops.mha``,
    returning the (roped) k/v for the cache: k, v [B, Hkv, S, D]."""
    s = x.shape[1]
    q, k, v = _project_qkv(p, x, x, num_heads, num_kv_heads, head_dim, qk_norm)
    if use_rope:
        pos = positions if positions is not None else torch.arange(s, device=x.device)
        q = L.apply_rope(q, pos, rope_theta)
        k = L.apply_rope(k, pos, rope_theta)
    out = kops.mha(q, k, v, causal=True, window=int(window) or None)
    return _bias(L.dot(_merge_heads(out), p.wo), p.bo), k, v


def cross_attention(p: Attention, x: torch.Tensor, memory: torch.Tensor, *,
                    num_heads: int, num_kv_heads: int, head_dim: int,
                    qk_norm: bool = False) -> torch.Tensor:
    """Non-causal attention of x [B, S, d] over memory [B, T, d]: q from x,
    k and v from memory, plain ``_sdpa`` (f32 math, output in q's type).
    With ``memory`` x itself, the whisper encoder's self-attention. Runs
    under the profiler range ``attention.cross`` (``launch/profile.py``)."""
    with trace.span("attention.cross"):
        q, k, v = _project_qkv(p, x, memory, num_heads, num_kv_heads, head_dim, qk_norm)
        out = _sdpa(q, k, v, causal=False, window=0)
        return _bias(L.dot(_merge_heads(out), p.wo), p.bo)


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, num_kv_heads: int, head_dim: int, *, seq_len: int,
                  window: int, dtype, device=None) -> Dict[str, torch.Tensor]:
    """Ring buffer of min(seq_len, window) entries for windowed layers."""
    size = min(seq_len, window) if window else seq_len
    shape = (batch, num_kv_heads, size, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_self_attention(p: Attention, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                          pos: int, *, num_heads: int, num_kv_heads: int, head_dim: int,
                          window: int = 0, rope_theta: float = 10000.0,
                          qk_norm: bool = False, use_rope: bool = True
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode: x [B, 1, d] at position ``pos``.

    Returns (out [B, 1, d], cache). Windowed layers write the ring slot
    ``pos % size``, global layers slot ``pos``. Unlike the reference, which
    returns a new cache, the cache tensors are written in place. The slots
    the reference's mask keeps are always the first ``min(pos + 1, size)``,
    so this attends to that prefix instead of masking the rest: the masked
    terms are exact zeros in the reference's softmax.
    """
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, x, num_heads, num_kv_heads, head_dim, qk_norm)
    if use_rope:
        pvec = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q = L.apply_rope(q, pvec, rope_theta)
        k = L.apply_rope(k, pvec, rope_theta)
    ck, cv = cache["k"], cache["v"]
    size = ck.shape[2]
    slot = pos % size if window else pos
    if slot >= size:
        raise ValueError(f"position {pos} is past the cache's {size} slots")
    ck[:, :, slot] = k[:, :, 0]
    cv[:, :, slot] = v[:, :, 0]
    n = min(pos + 1, size)
    qf = q.float().reshape(b, num_kv_heads, num_heads // num_kv_heads, 1, head_dim)
    logits = (qf @ ck[:, :, None, :n].float().transpose(-1, -2)) / (head_dim ** 0.5)
    probs = torch.softmax(logits, dim=-1)
    out = (probs @ cv[:, :, None, :n].float()).to(x.dtype)
    out = out.reshape(b, num_heads, 1, head_dim)
    return _bias(L.dot(_merge_heads(out), p.wo), p.bo), cache
