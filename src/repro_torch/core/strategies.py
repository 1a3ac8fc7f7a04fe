"""Pluggable strategy components of the FGL engine.

Counterpart of ``repro.core.strategies``, for the strategies on the main
path: the three topologies, the unmasked FedAvg / Eq. 16 / identity
aggregators, and the SpreadFGL imputation round. The masked and
participation aggregators, gossip, async and FedSage+'s local generation
are still to port.

- :class:`Topology`: how clients map onto edge servers and how servers are
  wired (star = FedGL, ring = SpreadFGL's testbed, custom adjacency).
- :class:`Aggregator`: how stacked [M] client classifiers are combined each
  round.
- :class:`ImputationStrategy`: the every-K graph-fixing round.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import imputation, patcher
from repro_torch.core.partition import group_clients_by_server, ring_adjacency
from repro_torch.tree import tree_map

PyTree = Any


# ---------------------------------------------------------------------------
# Topology: client -> edge-server grouping + server-server adjacency.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TopologyLayout:
    """Resolved edge layout for a concrete client count."""

    adjacency: np.ndarray        # [N, N] server-server weights (a_rj of Eq. 16)
    server_of_client: np.ndarray  # [M] owning server of each client
    num_servers: int
    clients_per_server: int


@runtime_checkable
class Topology(Protocol):
    """Client→edge-server layout + server-server adjacency a_rj (Eq. 16)."""

    def build(self, num_clients: int) -> TopologyLayout: ...


@dataclasses.dataclass(frozen=True)
class StarTopology:
    """One edge server covering every client (FedGL, Sec. III-B)."""

    def build(self, num_clients: int) -> TopologyLayout:
        return TopologyLayout(np.ones((1, 1), dtype=np.float32),
                              np.zeros(num_clients, dtype=np.int32),
                              1, num_clients)


@dataclasses.dataclass(frozen=True)
class RingTopology:
    """N edge servers on a ring (SpreadFGL's testbed, Sec. III-E)."""

    num_servers: int = 3

    def build(self, num_clients: int) -> TopologyLayout:
        n = self.num_servers
        if num_clients % n:
            raise ValueError(f"M={num_clients} must divide across N={n} servers")
        return TopologyLayout(ring_adjacency(n),
                              group_clients_by_server(num_clients, n),
                              n, num_clients // n)


@dataclasses.dataclass(frozen=True, eq=False)
class CustomTopology:
    """Arbitrary server-server adjacency a_rj; clients grouped contiguously."""

    adjacency: np.ndarray

    def build(self, num_clients: int) -> TopologyLayout:
        adj = np.asarray(self.adjacency, dtype=np.float32)
        if adj.ndim != 2 or adj.shape[0] != adj.shape[1]:
            raise ValueError(f"adjacency must be square, got {adj.shape}")
        n = adj.shape[0]
        if num_clients % n:
            raise ValueError(f"M={num_clients} must divide across N={n} servers")
        return TopologyLayout(adj, group_clients_by_server(num_clients, n),
                              n, num_clients // n)


# ---------------------------------------------------------------------------
# Aggregator: combine client classifiers once per global round.
# ---------------------------------------------------------------------------

@runtime_checkable
class Aggregator(Protocol):
    """Combine stacked [M] client classifiers once per global round.

    Only full participation is ported: ``mask`` must be None.
    """

    def aggregate(self, params: PyTree, *, adj: torch.Tensor,
                  num_servers: int, m_per: int, round: int = 0,
                  mask: Optional[torch.Tensor] = None) -> PyTree: ...


def _unmasked(mask) -> None:
    if mask is not None:
        raise NotImplementedError("masked (partial-participation) aggregation "
                                  "is not ported yet")


@dataclasses.dataclass(frozen=True)
class IdentityAggregator:
    """No aggregation: clients keep their own weights (LocalFGL, Sec. IV-A)."""

    def aggregate(self, params, *, adj, num_servers, m_per, round=0, mask=None):
        return params


@dataclasses.dataclass(frozen=True)
class FedAvgAggregator:
    """Per-server FedAvg: mean over covered clients, broadcast back."""

    def aggregate(self, params, *, adj, num_servers, m_per, round=0, mask=None):
        _unmasked(mask)

        def agg(leaf):
            grouped = leaf.reshape((num_servers, m_per) + leaf.shape[1:])
            w = torch.sum(grouped, dim=1) / m_per
            return torch.repeat_interleave(w, m_per, dim=0)
        return tree_map(agg, params)


@dataclasses.dataclass(frozen=True)
class NeighborAggregator:
    """Eq. 16 (Sec. III-E): each server averages itself and its topology
    neighbors densely, every round:
    W_j = sum_r a_rj * sum_i W_(r,i) / sum_r a_rj M_r."""

    def aggregate(self, params, *, adj, num_servers, m_per, round=0, mask=None):
        _unmasked(mask)

        def agg(leaf):
            grouped = leaf.reshape((num_servers, m_per) + leaf.shape[1:])
            client_sum = torch.sum(grouped, dim=1)                 # [N, ...]
            num = torch.einsum("rj,r...->j...", adj, client_sum)
            den = torch.sum(adj, dim=0) * m_per                    # [N]
            w = num / den.reshape((num_servers,) + (1,) * (leaf.ndim - 1))
            return torch.repeat_interleave(w, m_per, dim=0)
        return tree_map(agg, params)


# ---------------------------------------------------------------------------
# ImputationStrategy: the every-K graph-fixing round.
# ---------------------------------------------------------------------------

@runtime_checkable
class ImputationStrategy(Protocol):
    """The every-K graph-fixing round; ``active=False`` skips it."""

    active: bool

    def impute(self, engine, state, noise=None): ...


@dataclasses.dataclass(frozen=True)
class NoImputation:
    """Skip graph fixing entirely (LocalFGL / FedAvg-fusion baselines)."""

    active = False

    def impute(self, engine, state, noise=None):
        return state


@dataclasses.dataclass(frozen=True)
class SpreadImputation:
    """SpreadFGL's generator round (Algorithm 1 lines 11-24).

    Fuse client embeddings per server, train the AE/assessor pair
    adversarially, take cross-subgraph top-k similarity links, and fix every
    client graph. The [N] server axis is one batched pass (the similarity
    top-k is one kernel launch for all servers); per-server results are
    stitched back to the global flat index space.

    ``noise`` is the round's S, ``[N, M_per*n_pad, c]``; when None it is
    drawn from the state's generator. Tests hand in the reference's S.
    """

    active = True

    def server_outputs(self, engine, state, noise=None):
        """The batched [N] generator round, before graph fixing.

        Returns ``(ae_params, ae_opt, as_params, as_opt, scores, idx, x_bar)``
        with leading [N] axes: the raw link proposals.
        """
        batch = state.batch
        emb = engine._embeddings(state.params, batch)       # [M, n_pad, c]
        n_pad = batch.x.shape[1]
        n, mp = engine.n_servers, engine.m_per
        emb_g = emb.reshape((n, mp) + emb.shape[1:])        # [N, M_per, n_pad, c]
        mask_g = batch.node_mask.reshape(n, mp, n_pad)
        if noise is None:
            noise = imputation.sample_noise(state.gen, mp * n_pad,
                                            engine.num_classes, lead=(n,))
        client_ids = imputation.client_of_flat(mp, n_pad, device=emb.device)
        return engine._server_round(state.ae_params, state.ae_opt, state.as_params,
                                    state.as_opt, emb_g, mask_g, client_ids, noise)

    def impute(self, engine, state, noise=None):
        (ae_params, ae_opt, as_params, as_opt, scores, idx,
         x_bar) = self.server_outputs(engine, state, noise)
        scores, idx, x_bar = patcher.stitch_server_links(scores, idx, x_bar)
        batch = patcher.fix_graphs(state.batch, scores, idx, x_bar)
        return dataclasses.replace(state, batch=batch, ae_params=ae_params,
                                   ae_opt=ae_opt, as_params=as_params,
                                   as_opt=as_opt)

    def impute_reference(self, engine, state, noise=None):
        """Sequential per-server loop (tests only): the same round as
        :meth:`impute` run one server at a time, with the same noise."""
        batch = state.batch
        emb = engine._embeddings(state.params, batch)       # [M, n_pad, c]
        n_pad = batch.x.shape[1]
        mp = engine.m_per
        if noise is None:
            noise = imputation.sample_noise(state.gen, mp * n_pad,
                                            engine.num_classes, lead=(engine.n_servers,))
        client_ids = imputation.client_of_flat(mp, n_pad, device=emb.device)
        outs = []
        for j in range(engine.n_servers):
            sl = slice(j * mp, (j + 1) * mp)
            take_j = lambda t: tree_map(lambda x: x[j], t)  # noqa: E731
            outs.append(engine._server_round(
                take_j(state.ae_params), _take_opt(state.ae_opt, j),
                take_j(state.as_params), _take_opt(state.as_opt, j),
                emb[sl], batch.node_mask[sl], client_ids, noise[j]))

        def stack(i):
            return tree_map(lambda *x: torch.stack(x), *[o[i] for o in outs])
        ae_params, as_params = stack(0), stack(2)
        ae_opt, as_opt = (_stack_opt([o[i] for o in outs]) for i in (1, 3))
        scores, idx, x_bar = patcher.stitch_server_links(stack(4), stack(5), stack(6))
        batch = patcher.fix_graphs(batch, scores, idx, x_bar)
        return dataclasses.replace(state, batch=batch, ae_params=ae_params,
                                   ae_opt=ae_opt, as_params=as_params,
                                   as_opt=as_opt)


def _take_opt(opt, j):
    return type(opt)(opt.step[j], tree_map(lambda x: x[j], opt.mu),
                     tree_map(lambda x: x[j], opt.nu))


def _stack_opt(opts):
    return type(opts[0])(torch.stack([o.step for o in opts]),
                         tree_map(lambda *x: torch.stack(x), *[o.mu for o in opts]),
                         tree_map(lambda *x: torch.stack(x), *[o.nu for o in opts]))
