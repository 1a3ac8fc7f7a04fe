"""Comparison algorithms of Sec. IV-A as pure strategy compositions.

Counterpart of ``repro.core.baselines``:

- LocalFGL: each client trains its classifier alone: identity aggregation,
  no graph fixing.
- FedAvg-fusion: FedAvg aggregation of client GNNs, no link imputation.
- FedSagePlus: FedAvg + a local linear neighbor generator per client
  (Zhang et al., NeurIPS'21 style): no cross-client information flow.
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


@register("fedsage_plus")
def FedSagePlus(cfg: FGLConfig, batch: ClientBatch, *, gen_steps: int = 20,
                **kw) -> FGLTrainer:
    """FedAvg + local linear neighbor generation (no global information flow)."""
    return FGLTrainer(cfg, batch, topology=S.StarTopology(),
                      aggregator=S.FedAvgAggregator(),
                      imputation=S.LocalGenImputation(gen_steps=gen_steps), **kw)
