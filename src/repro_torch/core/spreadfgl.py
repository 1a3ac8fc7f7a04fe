"""SpreadFGL / FedGL as strategy compositions (Sec. III-B and III-E).

Counterpart of the ``FedGL`` and ``SpreadFGL`` builders of
``repro.core.spreadfgl`` (the gossip and async compositions are still to
port):

- ``make_fedgl`` (``"FedGL"``): star topology (one edge server covering all
  clients), FedAvg aggregation, SpreadFGL generator round.
- ``make_spreadfgl`` (``"SpreadFGL"``): N edge servers on a ring, or any
  custom adjacency, Eq. 16 neighbor aggregation, Eq. 15 trace regularizer,
  SpreadFGL generator round.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import strategies as S
from repro_torch.core.fedgl import FGLTrainer
from repro_torch.core.registry import register
from repro_torch.core.types import ClientBatch, FGLConfig


@register("FedGL")
def make_fedgl(cfg: FGLConfig, batch: ClientBatch, **kw) -> FGLTrainer:
    return FGLTrainer(cfg, batch, topology=S.StarTopology(),
                      aggregator=S.FedAvgAggregator(),
                      imputation=S.SpreadImputation(), **kw)


@register("SpreadFGL")
def make_spreadfgl(cfg: FGLConfig, batch: ClientBatch, *, num_servers: int = 3,
                   adjacency: Optional[np.ndarray] = None, **kw) -> FGLTrainer:
    if adjacency is not None:
        if adjacency.shape[0] != num_servers:
            raise ValueError(f"adjacency is {adjacency.shape[0]}x"
                             f"{adjacency.shape[1]} but num_servers={num_servers}")
        topology = S.CustomTopology(adjacency)
    else:
        topology = S.RingTopology(num_servers)
    return FGLTrainer(cfg, batch, topology=topology,
                      aggregator=S.NeighborAggregator(),
                      imputation=S.SpreadImputation(), **kw)
