"""SpreadFGL / FedGL as strategy compositions (Sec. III-B and III-E).

Counterpart of ``repro.core.spreadfgl``. Every builder takes ``sim_mesh=``
(the similarity search's candidate axis sharded over a mesh,
``core/ring_topk.py``) and passes ``edge_mesh=`` (the [N] server axis
placed on a mesh) to the trainer; ``spreadfgl_gossip`` also exchanges over
it:

- ``make_fedgl`` (``"FedGL"``): star topology (one edge server covering all
  clients), FedAvg aggregation, SpreadFGL generator round.
- ``make_spreadfgl`` (``"SpreadFGL"``): N edge servers on a ring, or any
  custom adjacency, Eq. 16 neighbor aggregation, Eq. 15 trace regularizer,
  SpreadFGL generator round.
- ``make_spreadfgl_gossip`` (``"spreadfgl_gossip"``): the same with
  :class:`~repro_torch.core.strategies.GossipAggregator`: cross-server
  exchange only every K rounds (``cfg.gossip_every`` / ``gossip_every=``).
  K = 1 reproduces ``"SpreadFGL"``.
- ``make_spreadfgl_async`` (``"spreadfgl_async"``): the same layout (star
  when ``num_servers == 1``) with
  :class:`~repro_torch.core.strategies.AsyncAggregator`: FedBuff-style
  buffered aggregation with delays, dropouts and staleness discounts
  (``cfg.async_buffer`` / ``async_buffer=``). B = M with zero delays
  reproduces the synchronous per-server FedAvg bit for bit.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import strategies as S
from repro_torch.core.fedgl import FGLTrainer
from repro_torch.core.registry import register
from repro_torch.core.types import ClientBatch, FGLConfig


@register("FedGL")
def make_fedgl(cfg: FGLConfig, batch: ClientBatch, *, sim_mesh=None, **kw) -> FGLTrainer:
    return FGLTrainer(cfg, batch, topology=S.StarTopology(),
                      aggregator=S.FedAvgAggregator(),
                      imputation=S.SpreadImputation(sim_mesh=sim_mesh), **kw)


@register("SpreadFGL")
def make_spreadfgl(cfg: FGLConfig, batch: ClientBatch, *, num_servers: int = 3,
                   adjacency: Optional[np.ndarray] = None, sim_mesh=None,
                   **kw) -> FGLTrainer:
    return FGLTrainer(cfg, batch, topology=_topology(num_servers, adjacency),
                      aggregator=S.NeighborAggregator(),
                      imputation=S.SpreadImputation(sim_mesh=sim_mesh), **kw)


def _topology(num_servers: int, adjacency: Optional[np.ndarray]) -> S.Topology:
    if adjacency is None:
        return S.RingTopology(num_servers)
    if adjacency.shape[0] != num_servers:
        raise ValueError(f"adjacency is {adjacency.shape[0]}x"
                         f"{adjacency.shape[1]} but num_servers={num_servers}")
    return S.CustomTopology(adjacency)


@register("spreadfgl_gossip")
def make_spreadfgl_gossip(cfg: FGLConfig, batch: ClientBatch, *,
                          num_servers: int = 3, gossip_every: Optional[int] = None,
                          adjacency: Optional[np.ndarray] = None,
                          edge_mesh=None, sim_mesh=None, **kw) -> FGLTrainer:
    """SpreadFGL whose servers FedAvg their own clients every round and
    exchange with topology neighbors only every ``gossip_every`` rounds
    (default ``cfg.gossip_every``), over the ranks of ``edge_mesh`` when
    it is given."""
    every = int(gossip_every) if gossip_every is not None else cfg.gossip_every
    aggregator = S.GossipAggregator(topology="ring" if adjacency is None else "adjacency",
                                    every_k=every, mesh=edge_mesh)
    return FGLTrainer(cfg, batch, topology=_topology(num_servers, adjacency),
                      aggregator=aggregator, imputation=S.SpreadImputation(sim_mesh=sim_mesh),
                      edge_mesh=edge_mesh, **kw)


@register("spreadfgl_async")
def make_spreadfgl_async(cfg: FGLConfig, batch: ClientBatch, *,
                         num_servers: int = 3, async_buffer: Optional[int] = None,
                         adjacency: Optional[np.ndarray] = None, sim_mesh=None,
                         **kw) -> FGLTrainer:
    """SpreadFGL (async FedGL when ``num_servers == 1``) with buffered
    aggregation: delays from ``cfg.delay_dist``, dropouts at
    ``cfg.dropout_rate``, a flush once ``async_buffer`` (default
    ``cfg.async_buffer``) updates are buffered."""
    buffer = int(async_buffer) if async_buffer is not None else cfg.async_buffer
    if buffer < 1:
        raise ValueError(f"spreadfgl_async needs async_buffer >= 1, "
                         f"got {buffer} (set cfg.async_buffer or pass "
                         f"async_buffer=)")
    if buffer > batch.num_clients:
        raise ValueError(f"async_buffer={buffer} can never fill: the buffer "
                         f"holds at most one update per client "
                         f"(M={batch.num_clients})")
    topology = (S.StarTopology() if num_servers == 1
                else _topology(num_servers, adjacency))
    aggregator = S.AsyncAggregator(
        buffer_size=buffer, delay_dist=cfg.delay_dist,
        dropout_rate=cfg.dropout_rate, max_delay=cfg.async_max_delay,
        seed=cfg.seed)
    return FGLTrainer(cfg, batch, topology=topology, aggregator=aggregator,
                      imputation=S.SpreadImputation(sim_mesh=sim_mesh), **kw)
