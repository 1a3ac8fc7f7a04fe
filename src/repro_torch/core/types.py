"""Core data structures for federated graph learning (SpreadFGL).

Counterpart of ``repro.core.types``. Shapes are static everywhere (padded +
masked), as in the reference:

- A *global* graph is ``Graph``: dense feature matrix, edge list, labels
  (numpy arrays).
- A *federated* split is ``ClientBatch``: per-client padded subgraphs stacked
  on a leading client axis ``[M, ...]``. The partitioner fills it with numpy
  arrays; ``ClientBatch.to(device)`` turns every field into a tensor there.
- Imputation augments each client with ``aug_max`` extra node slots that the
  graphic patcher fills.

The reference's ``kernel_impl`` knob is gone: the device of the tensors
decides whether a kernel or its plain PyTorch version runs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

Array = Any  # numpy array or torch tensor

_FIELDS = ("x", "adj", "y", "node_mask", "train_mask", "test_mask", "global_id")


@dataclasses.dataclass
class Graph:
    """A (global) undirected graph with node features and labels."""

    x: Array          # [n, d] float features
    senders: Array    # [e] int32
    receivers: Array  # [e] int32
    y: Array          # [n] int32 labels in [0, c)
    num_classes: int

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.senders.shape[0])

    @property
    def feature_dim(self) -> int:
        return int(self.x.shape[1])

    def dense_adjacency(self) -> np.ndarray:
        """Dense symmetric 0/1 adjacency (numpy; for small graphs/tests)."""
        n = self.num_nodes
        a = np.zeros((n, n), dtype=np.float32)
        s = np.asarray(self.senders)
        r = np.asarray(self.receivers)
        a[s, r] = 1.0
        a[r, s] = 1.0
        np.fill_diagonal(a, 0.0)
        return a


@dataclasses.dataclass
class ClientBatch:
    """Per-client padded subgraphs, stacked on a leading [M] axis.

    ``n_pad = n_local_max + aug_max``: the first ``n_local_max`` slots hold
    real local nodes, the trailing ``aug_max`` slots are reserved for imputed
    neighbors written by the graphic patcher (Sec. III-D).
    """

    x: Array           # [M, n_pad, d] features (aug slots overwritten by patcher)
    adj: Array         # [M, n_pad, n_pad] dense 0/1 adjacency (symmetric)
    y: Array           # [M, n_pad] labels (-1 on padding/aug slots)
    node_mask: Array   # [M, n_pad] 1.0 for real local nodes
    train_mask: Array  # [M, n_pad] 1.0 for labeled training nodes
    test_mask: Array   # [M, n_pad] 1.0 for held-out eval nodes
    global_id: Array   # [M, n_pad] int32 index into the global graph (-1 pad)
    # Static: not leaves of a checkpoint, as in the reference.
    num_classes: int = dataclasses.field(metadata=dict(static=True))
    aug_max: int = dataclasses.field(metadata=dict(static=True))

    @property
    def num_clients(self) -> int:
        return int(self.x.shape[0])

    @property
    def n_pad(self) -> int:
        return int(self.x.shape[1])

    @property
    def n_local_max(self) -> int:
        return self.n_pad - self.aug_max

    def replace(self, **kw) -> "ClientBatch":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "ClientBatch":
        """Every array field as a tensor on ``device`` (dtypes kept)."""
        return self.replace(**{f: torch.as_tensor(getattr(self, f)).to(device)
                               for f in _FIELDS})


@dataclasses.dataclass
class FGLConfig:
    """Hyperparameters of FedGL / SpreadFGL (Sec. III, parameter settings).

    The same fields and defaults as ``repro.core.types.FGLConfig`` minus
    ``kernel_impl``.
    """

    # GNN node classifier (GraphSAGE, GCN aggregator, 2 layers in the paper).
    hidden_dim: int = 64
    num_layers: int = 2
    gnn_kind: str = "sage"            # "sage" | "gcn" | "gat"
    dropout: float = 0.0

    # Federated schedule (Algorithm 1).
    num_edge_servers: int = 1          # N  (1 => FedGL, >1 => SpreadFGL)
    clients_per_server: int = 6        # M_j
    local_rounds: int = 10             # T_l
    global_rounds: int = 30            # T_g
    imputation_interval: int = 5       # K
    gossip_every: int = 1              # spreadfgl_gossip's exchange interval
    participation: float = 1.0        # fraction of clients per aggregation
    async_buffer: int = 0              # spreadfgl_async's buffer size B
    delay_dist: str = "zero"           # async arrival delays
    dropout_rate: float = 0.0          # async mid-round dropouts
    async_max_delay: int = 4
    ae_iters: int = 5                  # T_ae
    assessor_iters: int = 3            # T_as
    ae_outer_iters: int = 3            # "while not convergent" outer loop bound

    # Imputation generator / assessor (Sec. III-C/D).
    top_k_links: int = 5               # k most-similar cross-subgraph links
    ae_hidden: int = 16                # autoencoder bottleneck {c,16,d}/{d,16,c}
    assessor_hidden: tuple = (128, 16) # assessor MLP {c,128,16,1}
    neg_threshold: Optional[float] = None  # theta; default 1/c
    aug_max: int = 16                  # patcher slots per client

    # Optimization.
    lr_classifier: float = 0.01        # Adam, paper Sec. IV-A
    lr_generator: float = 0.001        # Adam for AE + assessor
    trace_reg: float = 1e-4            # Eq. 15 trace-norm coefficient (SpreadFGL)
    label_ratio: float = 0.3

    seed: int = 0

    def theta(self, num_classes: int) -> float:
        return self.neg_threshold if self.neg_threshold is not None else 1.0 / num_classes
