"""xLSTM blocks (mLSTM + sLSTM) of the ssm arch (xlstm-125m): counterpart of
``repro.models.xlstm``.

mLSTM (matrix memory, exponential gating) runs chunkwise over ``CHUNK`` =
128 steps, as in the reference: within a chunk a Q×Q decay-masked
attention, across chunks a carried ``[B, H, Dh, Dh]`` matrix state with its
accumulated decay; a Python loop over chunks takes the place of
``lax.scan``. sLSTM (scalar memory, a recurrence that does not parallelise)
is a Python loop over time, the reference's ``lax.scan``; its input
projection ``x @ w_in`` is taken for every step at once before the loop.

Numerics are the reference's: exponent arguments are clipped (-60, 30, and
``_ICLIP`` on the input gate) instead of carrying a running-max stabiliser
in the mLSTM; gates are computed in f32, and their weights are f32
parameters in a bf16 model. The recurrences run under
spans of ``repro_torch.trace`` (``xlstm.mlstm``, ``xlstm.slstm``),
profiler ranges when a profiler runs, so ``launch/profile.py`` can split their device time from
the projections'.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import trace
from repro_torch.models import layers as L

CHUNK = 128
_ICLIP = 8.0  # clip on the input-gate pre-activation (stabilization)

State = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """``wq, wk, wv, w_ogate, out_proj`` in the model's dtype; ``w_igate,
    w_fgate, b_fgate, b_igate`` in f32: the reference's ``init_mlstm`` keys."""

    def __init__(self, d: int, num_heads: int, *, expand: int = 2, dtype, device=None):
        super().__init__()
        di = expand * d
        p = lambda *shape: L._param(shape, dtype, device)  # noqa: E731
        f = lambda *shape: L._param(shape, torch.float32, device)  # noqa: E731
        self.wq, self.wk, self.wv = p(d, di), p(d, di), p(d, di)
        self.w_igate, self.w_fgate = f(d, num_heads), f(d, num_heads)
        self.b_fgate, self.b_igate = f(num_heads), f(num_heads)
        self.w_ogate, self.out_proj = p(d, di), p(di, d)

    def init_(self, gen: torch.Generator) -> None:
        d, di = self.wq.shape
        for w in (self.wq, self.wk, self.wv, self.w_igate, self.w_fgate, self.w_ogate):
            w.data.copy_(L.truncated_normal(gen, tuple(w.shape), d ** -0.5, w.dtype))
        self.b_fgate.data.fill_(3.0)        # start remembering
        self.b_igate.data.zero_()
        self.out_proj.data.copy_(L.truncated_normal(gen, (di, d), di ** -0.5, self.wq.dtype))


def axes_mlstm() -> dict:
    """Logical axes of ``MLSTM``'s parameters (``repro.models.xlstm.axes_mlstm``)."""
    return {"wq": ("embed", "inner"), "wk": ("embed", "inner"),
            "wv": ("embed", "inner"), "w_igate": ("embed", None),
            "w_fgate": ("embed", None), "b_fgate": (None,), "b_igate": (None,),
            "w_ogate": ("embed", "inner"), "out_proj": ("inner", "embed")}


def init_mlstm(gen: torch.Generator, d: int, num_heads: int, *, expand: int = 2,
               dtype=torch.bfloat16) -> MLSTM:
    p = MLSTM(d, num_heads, expand=expand, dtype=dtype, device=gen.device)
    p.init_(gen)
    return p


def _mlstm_gates(p: MLSTM, x: torch.Tensor, num_heads: int):
    """x: [..., d] -> q, k, v [..., H, Dh], log_f, log_i [..., H] (f32), the
    output gate o [..., di], and Dh."""
    dh = p.wq.shape[1] // num_heads

    def heads(t):
        return t.reshape(*t.shape[:-1], num_heads, dh)

    q = heads(x @ p.wq)
    k = heads(x @ p.wk) * (dh ** -0.5)
    v = heads(x @ p.wv)
    xf = x.float()
    logf = F.logsigmoid(xf @ p.w_fgate + p.b_fgate)
    logi = torch.clamp(xf @ p.w_igate + p.b_igate, -_ICLIP, _ICLIP)
    o = torch.sigmoid(x @ p.w_ogate)
    return q, k, v, logf, logi, o, dh


def _mlstm_chunk(cstate: torch.Tensor, nstate: torch.Tensor, q_q, k_q, v_q, lf_q, li_q):
    """One chunk: (C', n', y). States [B,H,Dh,Dh] and [B,H,Dh]; q, k, v
    [B,qc,H,Dh]; log gates [B,qc,H]."""
    lf_cum = torch.cumsum(lf_q, dim=1)                   # [B,qc,H]
    total = lf_cum[:, -1]                                 # [B,H]
    qf, kf, vf = q_q.float(), k_q.float(), v_q.float()

    # Inter-chunk: the query decays the state from the chunk's start.
    w_inter = torch.exp(torch.clamp(lf_cum, -60.0, 0.0))
    y_inter = torch.einsum("bqhd,bhde,bqh->bqhe", qf, cstate, w_inter)
    n_inter = torch.einsum("bqhd,bhd,bqh->bqh", qf, nstate, w_inter)

    # Intra-chunk: decay-masked attention, j <= i; D_ij = exp(lf_cum_i - lf_cum_j + li_j).
    qc = lf_q.shape[1]
    expo = lf_cum[:, :, None] - lf_cum[:, None, :] + li_q[:, None, :]
    idx = torch.arange(qc, device=lf_q.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]
    expo = torch.where(causal, torch.clamp(expo, -60.0, 30.0),
                       torch.tensor(float("-inf"), device=lf_q.device))
    scores = torch.einsum("bqhd,bjhd->bqjh", qf, kf) * torch.exp(expo)   # [B,qc,qc,H]
    y_intra = torch.einsum("bqjh,bjhd->bqhd", scores, vf)
    n_intra = torch.sum(scores, dim=2)

    denom = torch.clamp_min(torch.abs(n_inter + n_intra), 1.0)[..., None]
    y = (y_inter + y_intra) / denom

    # C' = exp(total) C + sum_j exp(total - lf_cum_j + li_j) k_j v_j^T
    wj = torch.exp(torch.clamp(total[:, None] - lf_cum + li_q, -60.0, 30.0))
    keep = torch.exp(torch.clamp(total, -60.0, 0.0))
    c_new = keep[..., None, None] * cstate + torch.einsum("bqhd,bqhe,bqh->bhde", kf, vf, wj)
    n_new = keep[..., None] * nstate + torch.einsum("bqhd,bqh->bhd", kf, wj)
    return c_new, n_new, y


def apply_mlstm(p: MLSTM, x: torch.Tensor, num_heads: int, *, return_state: bool = False):
    """Chunkwise parallel mLSTM. x: [B, S, d] -> [B, S, d] (or (y, {"c", "n"})
    when ``return_state``). S must be at most ``CHUNK`` or a multiple of it."""
    b, s, _ = x.shape
    q, k, v, logf, logi, o, dh = _mlstm_gates(p, x, num_heads)
    qc = min(CHUNK, s)
    if s % qc:
        raise ValueError(f"sequence length {s} is neither at most {CHUNK} nor a multiple "
                         f"of it: the chunkwise mLSTM takes whole chunks")
    c = torch.zeros((b, num_heads, dh, dh), dtype=torch.float32, device=x.device)
    n = torch.zeros((b, num_heads, dh), dtype=torch.float32, device=x.device)
    ys = []
    with trace.span("xlstm.mlstm"):
        for chunk in zip(*(torch.split(t, qc, dim=1) for t in (q, k, v, logf, logi))):
            c, n, y = _mlstm_chunk(c, n, *chunk)
            ys.append(y)
        y = torch.cat(ys, dim=1).reshape(b, s, num_heads * dh)
    out = (o * y.to(x.dtype)) @ p.out_proj
    if return_state:
        return out, {"c": c, "n": n}
    return out


def init_mlstm_state(batch: int, d: int, num_heads: int, *, expand: int = 2,
                     device=None) -> State:
    dh = expand * d // num_heads
    return {"c": torch.zeros((batch, num_heads, dh, dh), dtype=torch.float32, device=device),
            "n": torch.zeros((batch, num_heads, dh), dtype=torch.float32, device=device)}


def decode_mlstm(p: MLSTM, x: torch.Tensor, cache: State, num_heads: int
                 ) -> Tuple[torch.Tensor, State]:
    """One-token recurrent step. x: [B, 1, d] -> (out [B, 1, d], {"c", "n"})."""
    b = x.shape[0]
    q, k, v, logf, logi, o, dh = _mlstm_gates(p, x[:, 0], num_heads)
    f = torch.exp(torch.clamp(logf, -60.0, 0.0))[..., None, None]      # [B,H,1,1]
    i = torch.exp(logi)[..., None, None]
    kf, vf, qf = k.float(), v.float(), q.float()
    c = f * cache["c"] + i * torch.einsum("bhd,bhe->bhde", kf, vf)
    n = f[..., 0] * cache["n"] + i[..., 0] * kf
    num = torch.einsum("bhd,bhde->bhe", qf, c)
    den = torch.clamp_min(torch.abs(torch.einsum("bhd,bhd->bh", qf, n)), 1.0)[..., None]
    y = (num / den).reshape(b, num_heads * dh)
    out = (o * y.to(x.dtype)) @ p.out_proj
    return out[:, None, :], {"c": c, "n": n}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    """``w_in, r_in, b_in`` in f32 and ``out_proj`` in the model's dtype: the
    reference's ``init_slstm`` keys."""

    def __init__(self, d: int, *, dtype, device=None):
        super().__init__()
        f = lambda *shape: L._param(shape, torch.float32, device)  # noqa: E731
        self.w_in, self.r_in, self.b_in = f(d, 4 * d), f(d, 4 * d), f(4 * d)
        self.out_proj = L._param((d, d), dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        d = self.out_proj.shape[0]
        for w in (self.w_in, self.r_in, self.out_proj):
            w.data.copy_(L.truncated_normal(gen, tuple(w.shape), d ** -0.5, w.dtype))
        self.b_in.data.zero_()
        self.b_in.data[2 * d:3 * d] = 3.0   # the forget gate's bias: start remembering


def axes_slstm() -> dict:
    """Logical axes of ``SLSTM``'s parameters; ``out_proj``'s second "embed"
    falls back to replication, as in the reference."""
    return {"w_in": ("embed", "inner"), "r_in": ("embed", "inner"),
            "b_in": ("inner",), "out_proj": ("embed", "embed")}


def init_slstm(gen: torch.Generator, d: int, num_heads: int, dtype=torch.bfloat16) -> SLSTM:
    del num_heads
    p = SLSTM(d, dtype=dtype, device=gen.device)
    p.init_(gen)
    return p


def _slstm_step(p: SLSTM, carry, zx: torch.Tensor):
    """Stabilised sLSTM cell on ``zx = x_t @ w_in`` [B, 4d] f32."""
    c, n, h, m = carry
    z = zx + h @ p.r_in + p.b_in
    zt, it, ft, ot = torch.chunk(z, 4, dim=-1)
    log_f = F.logsigmoid(ft)
    log_i = torch.clamp(it, -_ICLIP, _ICLIP)
    m_new = torch.maximum(log_f + m, log_i)
    i_gate = torch.exp(log_i - m_new)
    f_gate = torch.exp(log_f + m - m_new)
    c_new = f_gate * c + i_gate * torch.tanh(zt)
    n_new = f_gate * n + i_gate
    h_new = torch.sigmoid(ot) * c_new / torch.clamp_min(n_new, 1.0)
    return c_new, n_new, h_new, m_new


def apply_slstm(p: SLSTM, x: torch.Tensor, num_heads: int, *, return_state: bool = False):
    """x: [B, S, d] -> [B, S, d] (or (y, {"c", "n", "h", "m"}) when
    ``return_state``), a loop over the S steps."""
    del num_heads
    b, _, d = x.shape
    zx = x.float() @ p.w_in                               # every step's input projection
    st = init_slstm_state(b, d, device=x.device)
    carry = (st["c"], st["n"], st["h"], st["m"])
    hs = []
    with trace.span("xlstm.slstm"):
        for zx_t in zx.unbind(1):   # unbind's backward stacks the steps' gradients once
            carry = _slstm_step(p, carry, zx_t)
            hs.append(carry[2])
        h = torch.stack(hs, dim=1)
    out = h.to(x.dtype) @ p.out_proj
    if return_state:
        return out, dict(zip("cnhm", carry))
    return out


def init_slstm_state(batch: int, d: int, device=None) -> State:
    zeros = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return {"c": zeros, "n": zeros, "h": zeros,
            "m": torch.full((batch, d), -1e9, dtype=torch.float32, device=device)}


def decode_slstm(p: SLSTM, x: torch.Tensor, cache: State) -> Tuple[torch.Tensor, State]:
    """One step. x: [B, 1, d] -> (out [B, 1, d], {"c", "n", "h", "m"})."""
    carry = _slstm_step(p, (cache["c"], cache["n"], cache["h"], cache["m"]),
                        x[:, 0].float() @ p.w_in)
    return (carry[2].to(x.dtype) @ p.out_proj)[:, None, :], dict(zip("cnhm", carry))
