"""SpreadFGL's neighbor aggregation (Eq. 16, Sec. III-E) as gossip on one host.

Counterpart of the FGL half of ``repro.core.gossip``: the exchange over the
stacked ``[N]`` edge-server axis that ``strategies.GossipAggregator`` runs
every K rounds, and the cross-server byte accounting. Only the single-host
route (the reference's ``axis=None``) is ported; placing the servers on a
device mesh is ROADMAP queue 1, item 11.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_map

PyTree = Any


def block_ring_gossip(params: PyTree) -> PyTree:
    """Eq. 16 ring average over the leading server axis of every leaf.

    Each server becomes (self + left + right) / 3. For a ring adjacency with
    self-loops (``partition.ring_adjacency``) and N >= 3 this equals
    :func:`adjacency_gossip`; at N = 2 both neighbors are the same server,
    so callers route N <= 2 through :func:`adjacency_gossip`.
    """
    def avg(p):
        if p.shape[0] == 1:
            return p
        f32 = p.to(torch.float32)
        left = torch.roll(f32, 1, dims=0)
        right = torch.roll(f32, -1, dims=0)
        return ((f32 + left + right) / 3.0).to(p.dtype)

    return tree_map(avg, params)


def adjacency_gossip(params: PyTree, adj: torch.Tensor) -> PyTree:
    """Eq. 16 with arbitrary server-server weights a_rj:
    W_j = sum_r a_rj W_r / sum_r a_rj over the leading server axis."""
    adj = torch.as_tensor(adj, dtype=torch.float32)
    den = torch.sum(adj, dim=0)                               # [N]

    def avg(p):
        num = torch.einsum("rj,r...->j...", adj.to(p.device), p.to(torch.float32))
        mixed = num / den.to(p.device).reshape((-1,) + (1,) * (num.ndim - 1))
        return mixed.to(p.dtype)

    return tree_map(avg, params)


# ---------------------------------------------------------------------------
# Cross-server traffic accounting (Sec. III-E load-balancing claim).
# ---------------------------------------------------------------------------

def ring_gossip_bytes_per_round(param_bytes: int, *, every: int = 1) -> float:
    """Cross-server bytes ONE server sends per round under ring gossip:
    |W| to both ring neighbors every ``every`` rounds, 2·|W|/K amortized."""
    return 2.0 * param_bytes / max(every, 1)


def dense_neighbor_bytes_per_round(adj, param_bytes: int, *,
                                   every: int = 1) -> float:
    """Per-server bytes of a dense Eq. 16 exchange: |W| to every topology
    neighbor (off-diagonal nonzero of its row) per exchange; the max over
    servers is the Sec. III-E peak load."""
    a = np.asarray(adj)
    if a.shape[0] == 1:
        return 0.0
    neighbors = ((a != 0).sum(axis=1) - (np.diag(a) != 0)).max()
    return float(neighbors) * param_bytes / max(every, 1)


def allreduce_bytes_per_round(param_bytes: int, n: int) -> float:
    """Per-server bytes of a ring all-reduce over N servers: 2·(N-1)/N·|W|,
    the FedAvg analogue that gossip replaces."""
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n * param_bytes


def gossip_allreduce_ratio(allreduce_bytes: float, gossip_bytes: float, *,
                           every: int = 1) -> float:
    """Per-step cross-server byte ratio: amortized gossip vs all-reduce."""
    return (gossip_bytes / max(every, 1)) / max(allreduce_bytes, 1)
