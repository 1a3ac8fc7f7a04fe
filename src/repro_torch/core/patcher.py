"""Graph fixing via local graphic patchers (Sec. III-D).

Counterpart of ``repro.core.patcher``. The edge server's imputed links and
features are split back into per-client pieces; each client's patcher turns
its strongest imputed cross-subgraph neighbors into *augmented node slots*
(features from X̅ = f(S)) wired to the local nodes they were matched with.
Where the reference vmaps one client's fix over M, the port fixes all M
clients at once with gathers and scatters over the [M] axis. The inputs
are never modified: the fixed batch holds new tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import trace
from repro_torch.core.types import ClientBatch
from repro_torch.kernels.ref import stable_topk


def stitch_server_links(scores: torch.Tensor, idx: torch.Tensor, x_bar: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-server results [N, M_per*n_pad, ..] -> the global flat index space.

    Server j's server-local flat slots live at global offset
    ``j * M_per * n_pad``; -1 stays -1.
    """
    n, n_flat, k = idx.shape
    offsets = (torch.arange(n, dtype=idx.dtype, device=idx.device) * n_flat)[:, None, None]
    idx = torch.where(idx >= 0, idx + offsets, torch.full_like(idx, -1))
    return (scores.reshape(n * n_flat, k), idx.reshape(n * n_flat, k),
            x_bar.reshape(n * n_flat, x_bar.shape[-1]))


def fix_graphs(batch: ClientBatch, link_scores: torch.Tensor, link_idx: torch.Tensor,
               x_bar: torch.Tensor) -> ClientBatch:
    """Apply graph fixing to every client.

    link_scores / link_idx: [M*n_pad, k] imputed links (0 / -1 = invalid);
    x_bar: [M*n_pad, d] imputed features. Returns a new ClientBatch whose aug
    slots hold the ``aug_max`` strongest links of each client. With the
    recorder on (``repro_torch.trace``) it counts the valid links from real
    local nodes (``fgl.links_proposed``) and the aug slots filled
    (``fgl.links_wired``).
    """
    m, n_pad = batch.x.shape[0], batch.x.shape[1]
    aug_max = batch.aug_max
    n_local = n_pad - aug_max
    dev = batch.x.device

    scores = link_scores.reshape(m, n_pad, -1)
    k = scores.shape[-1]
    # Candidate links from each client's *real local* nodes.
    src = torch.arange(n_pad, device=dev).repeat_interleave(k)        # [n_pad*k]
    tgt = link_idx.reshape(m, n_pad * k).long()
    s = scores.reshape(m, n_pad * k)
    is_local_src = (src < n_local)[None, :] & (batch.node_mask[:, src] > 0)
    valid = (tgt >= 0) & is_local_src
    s = torch.where(valid, s, torch.full_like(s, -torch.inf))
    # Strongest aug_max links win the augmentation slots (ties: lowest index,
    # as jax.lax.top_k).
    top_s, top_i = stable_topk(s, aug_max)                            # [M, aug]
    chosen_src = src[top_i]
    chosen_tgt = torch.gather(tgt, 1, top_i)
    chosen_ok = torch.isfinite(top_s)
    if trace.recording_on():
        trace.count("fgl.links_proposed", valid.sum())
        trace.count("fgl.links_wired", chosen_ok.sum())

    feats = x_bar[torch.clamp_min(chosen_tgt, 0)] * chosen_ok[..., None].to(x_bar.dtype)
    x = batch.x.clone()
    x[:, n_local:] = feats.to(x.dtype)          # aug rows are exactly [n_local, n_pad)

    adj = batch.adj.clone()
    adj[:, n_local:, :] = 0.0
    adj[:, :, n_local:] = 0.0
    w = chosen_ok.to(adj.dtype)
    rows = torch.arange(m, device=dev)[:, None].expand(m, aug_max)
    aug_rows = (n_local + torch.arange(aug_max, device=dev))[None, :].expand(m, aug_max)
    adj[rows, chosen_src, aug_rows] = w
    adj[rows, aug_rows, chosen_src] = w
    node_mask = batch.node_mask.clone()
    node_mask[:, n_local:] = w
    return batch.replace(x=x, adj=adj, node_mask=node_mask)
