"""SpreadFGL's load-balanced neighbor aggregation (Eq. 16, Sec. III-E) as gossip.

Counterpart of ``repro.core.gossip``. Two deployments of the same math, as
there, each over a mesh of ``launch.mesh`` (one process per device) where
the reference runs under ``shard_map``:

1. **LM / multi-pod** (``ring_gossip``, ``all_average``, ``maybe_gossip``):
   each pod is an edge server holding the whole model; instead of an
   all-reduce every step, parameters are averaged with the two ring
   neighbors every K steps.
2. **FGL / edge mesh** (``block_ring_gossip``, ``adjacency_gossip``): the
   stacked ``[N]`` edge-server axis, each rank owning a block of servers.
   ``strategies.GossipAggregator`` drives these; with ``mesh=None`` the
   leading axis is the whole ring, on one host (the reference's
   ``axis=None``).

The arithmetic is f32 in the reference's order, ``(p + left + right) / 3``,
cast back to the leaf's dtype. Each exchange runs inside the span
``gossip.exchange`` (``repro_torch.trace``). The byte-accounting helpers at
the bottom are the one home of the cross-server traffic math.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import trace
from repro_torch.launch import mesh as mesh_lib
from repro_torch.tree import tree_map

PyTree = Any


def _ring_average(p: torch.Tensor, mesh) -> torch.Tensor:
    """(p + left + right) / 3 in f32: left is the previous rank's p, right
    the next rank's."""
    with trace.span("gossip.exchange"):
        (left,) = mesh_lib.shift(mesh, [p], 1)
        (right,) = mesh_lib.shift(mesh, [p], -1)
    return (p.to(torch.float32) + left.to(torch.float32) + right.to(torch.float32)) / 3.0


def ring_gossip(params: PyTree, mesh) -> PyTree:
    """Eq. 16 with a ring adjacency over the mesh's ranks (self + both
    neighbors, equal weights)."""
    if mesh is None or mesh.size == 1:
        return params
    return tree_map(lambda p: _ring_average(p, mesh).to(p.dtype), params)


def all_average(params: PyTree, mesh) -> PyTree:
    """Classic FedAvg analogue: the full average over the mesh (all-reduce)."""
    n = 1 if mesh is None else mesh.size

    def avg(p):
        with trace.span("gossip.exchange"):
            total = mesh_lib.all_reduce_sum(mesh, p.to(torch.float32)) if n > 1 else p.float()
        return (total / n).to(p.dtype)

    return tree_map(avg, params)


def maybe_gossip(params: PyTree, step, mesh, *, every: int = 1) -> PyTree:
    """Ring-gossip every ``every`` steps (K of Algorithm 1): on the steps
    with ``(step + 1) % every == 0``, identity otherwise."""
    if every <= 1 or (int(step) + 1) % every == 0:
        return ring_gossip(params, mesh)
    return params


# ---------------------------------------------------------------------------
# FGL edge-mesh gossip: stacked [N] server axis, block-sharded across ranks.
# ---------------------------------------------------------------------------

def block_ring_gossip(params: PyTree, mesh=None) -> PyTree:
    """Eq. 16 ring average over a stacked edge-server axis.

    Every leaf carries servers on its leading axis. With ``mesh`` it is this
    rank's block, and the ring spans all ``mesh.size · n_block`` servers:
    interior neighbors come from the block, boundary neighbors from the
    adjacent ranks by ONE boundary slice each way. With ``mesh=None`` the
    leading axis is the whole ring. Each server becomes
    (self + left + right) / 3; for a ring adjacency with self-loops
    (``partition.ring_adjacency``) and N >= 3 this equals
    :func:`adjacency_gossip`; at N = 2 both neighbors are the same server,
    so callers route N <= 2 through :func:`adjacency_gossip`.
    """
    def avg(p):
        n_block = p.shape[0]
        size = 1 if mesh is None else mesh.size
        if size * n_block == 1:
            return p
        f32 = p.to(torch.float32)
        if size == 1:
            left = torch.roll(f32, 1, dims=0)
            right = torch.roll(f32, -1, dims=0)
        else:
            with trace.span("gossip.exchange"):
                (from_prev,) = mesh_lib.shift(mesh, [f32[-1:]], 1)
                (from_next,) = mesh_lib.shift(mesh, [f32[:1]], -1)
            left = torch.cat([from_prev, f32[:-1]], dim=0)
            right = torch.cat([f32[1:], from_next], dim=0)
        return ((f32 + left + right) / 3.0).to(p.dtype)

    return tree_map(avg, params)


def adjacency_gossip(params: PyTree, adj: torch.Tensor, mesh=None) -> PyTree:
    """Eq. 16 with arbitrary server-server weights a_rj:
    W_j = sum_r a_rj W_r / sum_r a_rj over the stacked server axis. With
    ``mesh`` each rank holds a block of the servers: the blocks are
    all-gathered into the whole [N] stack (a general adjacency has no fixed
    send schedule), mixed, and this rank's rows sliced back out."""
    adj = torch.as_tensor(adj, dtype=torch.float32)
    den = torch.sum(adj, dim=0)                               # [N]

    def avg(p):
        n_block = p.shape[0]
        full = p.to(torch.float32)
        if mesh is not None and mesh.size > 1:
            with trace.span("gossip.exchange"):
                full = mesh_lib.all_gather(mesh, full, 0)
        num = torch.einsum("rj,r...->j...", adj.to(p.device), full)
        mixed = num / den.to(p.device).reshape((-1,) + (1,) * (num.ndim - 1))
        if mesh is not None and mesh.size > 1:
            mixed = mixed[mesh.rank * n_block:(mesh.rank + 1) * n_block]
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
