"""Comparison algorithms of Sec. IV-A as pure strategy compositions.

Counterpart of ``repro.core.baselines`` (``fedsage_plus`` is still to port):

- LocalFGL: each client trains its classifier alone: identity aggregation,
  no graph fixing.
- FedAvg-fusion: FedAvg aggregation of client GNNs, no link imputation.
"""
from __future__ import annotations

from repro_torch.core import strategies as S
from repro_torch.core.fedgl import FGLTrainer
from repro_torch.core.registry import register
from repro_torch.core.types import ClientBatch, FGLConfig


@register("local")
def LocalFGL(cfg: FGLConfig, batch: ClientBatch, **kw) -> FGLTrainer:
    """Local training only: never aggregate, never impute."""
    return FGLTrainer(cfg, batch, topology=S.StarTopology(),
                      aggregator=S.IdentityAggregator(),
                      imputation=S.NoImputation(), **kw)


@register("fedavg_fusion")
def FedAvgFusion(cfg: FGLConfig, batch: ClientBatch, **kw) -> FGLTrainer:
    """Classic FedAvg over client GNNs (no imputation generator)."""
    return FGLTrainer(cfg, batch, topology=S.StarTopology(),
                      aggregator=S.FedAvgAggregator(),
                      imputation=S.NoImputation(), **kw)
