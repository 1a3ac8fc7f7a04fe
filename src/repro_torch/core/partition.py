"""Graph partitioning into disjoint client subgraphs (Sec. III-A).

A numpy copy of ``repro.core.partition``: all four partitioners produce the
same assignments and ``ClientBatch`` arrays bit for bit as the reference
(``tests/test_torch_data_adam.py``). The batch holds numpy arrays; the
trainer moves it to its device with ``ClientBatch.to``.

The paper uses Louvain to split each benchmark graph into M client subgraphs
with *no shared nodes and no cross-client links* (the deleted links are the
missing cross-subgraph links the imputation generator must recover). Offline we
use deterministic label propagation as the community detector, then balance the
communities into M equal-size clients.

That homogeneous community split is only ONE point on the heterogeneity axis
the FGL literature stresses (AdaFGL's topology heterogeneity, FedGTA's non-IID
subgraphs). Partitioning is therefore pluggable: a :class:`Partitioner`
strategy produces the ``[n] -> client`` assignment and
:func:`partition_graph` is a thin dispatcher that turns any assignment into
the padded :class:`~repro_torch.core.types.ClientBatch` the engine trains on.

Strategies (``PARTITIONERS`` registry, CLI ``fgl_train --partitioner``):

- ``label_prop`` — :class:`LabelPropagationPartitioner`, the default; bit-
  compatible with the pre-protocol ``partition_graph`` (the fixed-seed
  goldens in ``tests/test_strategy_api.py`` pin this).
- ``dirichlet`` — :class:`DirichletPartitioner`, α-parameterized label-skew
  non-IID (per class, client shares drawn from Dir(α·1_M); α→∞ is IID,
  α→0 gives each client a handful of classes).
- ``degree`` — :class:`DegreeSkewPartitioner`, topology heterogeneity:
  clients own contiguous slices of the degree ordering (client 0 the
  sparsest nodes, client M-1 the hubs).
- ``random`` — :class:`RandomEdgeCutPartitioner`, uniform random node
  assignment; the expected (1 - 1/M) edge-cut baseline.

Every strategy returns the same ``assign`` contract: an ``[n]`` int32 array
with every node assigned to exactly one client in ``[0, M)`` and every
client non-empty, deterministic per ``(graph, num_clients, seed)``
(``tests/test_partitioners.py`` property-checks all of them).
"""
from __future__ import annotations

import dataclasses
from typing import List, Protocol, Tuple, Union, runtime_checkable

import numpy as np

from repro_torch.core.types import ClientBatch, Graph


def label_propagation_communities(graph: Graph, *, iters: int = 20, seed: int = 0) -> np.ndarray:
    """Deterministic synchronous label propagation; returns [n] community ids."""
    n = graph.num_nodes
    rng = np.random.default_rng(seed)
    labels = np.arange(n)
    nbrs: List[List[int]] = [[] for _ in range(n)]
    for u, v in zip(np.asarray(graph.senders), np.asarray(graph.receivers)):
        nbrs[int(u)].append(int(v))
        nbrs[int(v)].append(int(u))
    order = rng.permutation(n)
    for _ in range(iters):
        changed = 0
        for u in order:
            if not nbrs[u]:
                continue
            counts = np.bincount(labels[nbrs[u]])
            best = int(np.argmax(counts))
            if labels[u] != best:
                labels[u] = best
                changed += 1
        if changed == 0:
            break
    # Compact ids.
    _, labels = np.unique(labels, return_inverse=True)
    return labels.astype(np.int32)


def balanced_assignment(communities: np.ndarray, num_clients: int, *, seed: int = 0) -> np.ndarray:
    """Pack communities into ``num_clients`` near-equal groups (greedy bin pack)."""
    rng = np.random.default_rng(seed)
    comm_ids, counts = np.unique(communities, return_counts=True)
    order = np.argsort(-counts)  # largest community first
    loads = np.zeros(num_clients, dtype=np.int64)
    comm_to_client = {}
    for idx in order:
        cid = int(comm_ids[idx])
        target = int(np.argmin(loads))
        comm_to_client[cid] = target
        loads[target] += counts[idx]
    assign = np.array([comm_to_client[int(c)] for c in communities], dtype=np.int32)
    # Rebalance: move random nodes from overloaded to underloaded clients so that
    # every client has at least one node and sizes stay within 2x of mean.
    n = len(assign)
    mean = n / num_clients
    for c in range(num_clients):
        while np.sum(assign == c) > 2 * mean:
            donor = np.where(assign == c)[0]
            tgt = int(np.argmin(np.bincount(assign, minlength=num_clients)))
            assign[rng.choice(donor)] = tgt
    for c in range(num_clients):
        if not np.any(assign == c):
            big = int(np.argmax(np.bincount(assign, minlength=num_clients)))
            movable = np.where(assign == big)[0]
            assign[rng.choice(movable)] = c
    return assign


# ---------------------------------------------------------------------------
# Partitioner strategies.
# ---------------------------------------------------------------------------

@runtime_checkable
class Partitioner(Protocol):
    """Produce the [n] -> client assignment (the heterogeneity axis).

    ``assign`` must place every node on exactly one client in ``[0, M)``,
    leave no client empty, and be deterministic per ``seed``.
    """

    def assign(self, graph: Graph, num_clients: int, *, seed: int = 0) -> np.ndarray: ...


def _fill_empty_clients(assign: np.ndarray, num_clients: int,
                        rng: np.random.Generator) -> np.ndarray:
    """Move one random node from the largest client onto each empty client."""
    for c in range(num_clients):
        if not np.any(assign == c):
            big = int(np.argmax(np.bincount(assign, minlength=num_clients)))
            movable = np.where(assign == big)[0]
            assign[rng.choice(movable)] = c
    return assign


@dataclasses.dataclass(frozen=True)
class LabelPropagationPartitioner:
    """Community split + greedy balancing (the paper's Sec. III-A setup).

    The default and the pre-protocol behavior of :func:`partition_graph`,
    kept bit-compatible: label propagation and balancing consume their own
    ``default_rng(seed)`` streams exactly as before.
    """

    iters: int = 20

    def assign(self, graph: Graph, num_clients: int, *, seed: int = 0) -> np.ndarray:
        comm = label_propagation_communities(graph, iters=self.iters, seed=seed)
        return balanced_assignment(comm, num_clients, seed=seed)


@dataclasses.dataclass(frozen=True)
class DirichletPartitioner:
    """Label-skew non-IID split (FedGTA/AdaFGL evaluation regime).

    For each class c the M client shares are drawn from Dir(α·1_M) and the
    class's nodes are dealt out by largest-remainder rounding of those
    shares. ``alpha`` interpolates between IID (α → ∞: every client sees
    every class in near-global proportions) and extreme skew (α → 0: each
    client is dominated by a handful of classes). Per-client label entropy
    is monotone in α (property-checked in ``tests/test_partitioners.py``).
    """

    alpha: float = 1.0

    def assign(self, graph: Graph, num_clients: int, *, seed: int = 0) -> np.ndarray:
        if self.alpha <= 0:
            raise ValueError(f"alpha must be > 0, got {self.alpha}")
        rng = np.random.default_rng(seed)
        y = np.asarray(graph.y)
        assign = np.zeros(graph.num_nodes, dtype=np.int32)
        for c in np.unique(y):
            idx = rng.permutation(np.where(y == c)[0])
            raw = rng.dirichlet(np.full(num_clients, self.alpha)) * len(idx)
            counts = np.floor(raw).astype(np.int64)
            short = len(idx) - int(counts.sum())
            if short:
                counts[np.argsort(-(raw - counts))[:short]] += 1
            for ci, part in enumerate(np.split(idx, np.cumsum(counts)[:-1])):
                assign[part] = ci
        return _fill_empty_clients(assign, num_clients, rng)


@dataclasses.dataclass(frozen=True)
class DegreeSkewPartitioner:
    """Topology heterogeneity: contiguous slices of the degree ordering.

    Client 0 receives the sparsest nodes, client M-1 the hubs — equal client
    sizes but very different local topologies (the AdaFGL axis), so the
    value of imputed cross-subgraph links differs sharply across clients.
    Ties are broken by a small seeded jitter so the split is deterministic
    per seed but not an artifact of node numbering.
    """

    def assign(self, graph: Graph, num_clients: int, *, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        n = graph.num_nodes
        deg = np.zeros(n, dtype=np.float64)
        np.add.at(deg, np.asarray(graph.senders), 1.0)
        np.add.at(deg, np.asarray(graph.receivers), 1.0)
        order = np.argsort(deg + rng.uniform(0.0, 0.5, n), kind="stable")
        assign = np.empty(n, dtype=np.int32)
        bounds = (np.arange(1, num_clients) * n) // num_clients
        for ci, chunk in enumerate(np.split(order, bounds)):
            assign[chunk] = ci
        return assign


@dataclasses.dataclass(frozen=True)
class RandomEdgeCutPartitioner:
    """Uniform random node assignment — the random edge-cut baseline.

    Every edge lands cross-client with probability 1 - 1/M, maximizing
    |ΔE| for a given M; the floor any structure-aware split must beat.
    """

    def assign(self, graph: Graph, num_clients: int, *, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        assign = rng.integers(0, num_clients, size=graph.num_nodes).astype(np.int32)
        return _fill_empty_clients(assign, num_clients, rng)


#: CLI / registry names -> strategy class (``fgl_train --partitioner``).
PARTITIONERS = {
    "label_prop": LabelPropagationPartitioner,
    "dirichlet": DirichletPartitioner,
    "degree": DegreeSkewPartitioner,
    "random": RandomEdgeCutPartitioner,
}


def make_partitioner(name: str, **kw) -> Partitioner:
    """Build the named partitioner; keys its dataclass does not declare are
    dropped, so callers can pass e.g. ``alpha=`` unconditionally."""
    try:
        cls = PARTITIONERS[name]
    except KeyError:
        raise KeyError(f"unknown partitioner {name!r}; "
                       f"available: {', '.join(sorted(PARTITIONERS))}") from None
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in kw.items() if k in fields})


def label_skew_entropy(assign: np.ndarray, y, num_clients: int) -> np.ndarray:
    """[M] per-client label-distribution entropy (nats) — the skew diagnostic.

    log(c) means a client sees the classes uniformly (IID end); 0 means a
    single class. ``benchmarks/bench_heterogeneity.py`` reports the mean.
    """
    y = np.asarray(y)
    ent = np.zeros(num_clients, dtype=np.float64)
    for ci in range(num_clients):
        counts = np.bincount(y[assign == ci])
        p = counts[counts > 0] / max(counts.sum(), 1)
        ent[ci] = float(-(p * np.log(p)).sum())
    return ent


def count_missing_links(graph: Graph, assign: np.ndarray) -> int:
    """|ΔE|: links deleted because their endpoints land on different clients."""
    s = np.asarray(graph.senders)
    r = np.asarray(graph.receivers)
    return int(np.sum(assign[s] != assign[r]))


def partition_graph(graph: Graph, num_clients: int, *, label_ratio: float = 0.3,
                    test_ratio: float = 0.2, aug_max: int = 16,
                    seed: int = 0,
                    partitioner: Union[Partitioner, str, None] = None
                    ) -> Tuple[ClientBatch, np.ndarray]:
    """Split ``graph`` into M disjoint padded client subgraphs.

    A thin dispatcher: the :class:`Partitioner` strategy (default
    ``label_prop``; a string resolves through :func:`make_partitioner`)
    produces the node->client ``assign``, and this function materializes the
    padded :class:`ClientBatch` — identically for every strategy. Cross-
    client edges are DELETED (they are the missing links of Sec. III-A);
    their count is reported by :func:`count_missing_links`.

    Returns (client_batch, assign).
    """
    if partitioner is None:
        partitioner = LabelPropagationPartitioner()
    elif isinstance(partitioner, str):
        partitioner = make_partitioner(partitioner)
    rng = np.random.default_rng(seed)
    assign = np.asarray(partitioner.assign(graph, num_clients, seed=seed),
                        dtype=np.int32)

    sizes = np.bincount(assign, minlength=num_clients)
    n_local_max = int(sizes.max())
    n_pad = n_local_max + aug_max
    d = graph.feature_dim
    m = num_clients

    x = np.zeros((m, n_pad, d), dtype=np.float32)
    adj = np.zeros((m, n_pad, n_pad), dtype=np.float32)
    y = -np.ones((m, n_pad), dtype=np.int32)
    node_mask = np.zeros((m, n_pad), dtype=np.float32)
    train_mask = np.zeros((m, n_pad), dtype=np.float32)
    test_mask = np.zeros((m, n_pad), dtype=np.float32)
    global_id = -np.ones((m, n_pad), dtype=np.int32)

    s = np.asarray(graph.senders)
    r = np.asarray(graph.receivers)
    gx = np.asarray(graph.x)
    gy = np.asarray(graph.y)

    for ci in range(m):
        nodes = np.where(assign == ci)[0]
        k = len(nodes)
        local_index = {int(g): i for i, g in enumerate(nodes)}
        x[ci, :k] = gx[nodes]
        y[ci, :k] = gy[nodes]
        node_mask[ci, :k] = 1.0
        global_id[ci, :k] = nodes
        # Intra-client edges only.
        keep = (assign[s] == ci) & (assign[r] == ci)
        for u, v in zip(s[keep], r[keep]):
            iu, iv = local_index[int(u)], local_index[int(v)]
            adj[ci, iu, iv] = 1.0
            adj[ci, iv, iu] = 1.0
        # Label split: label_ratio train, test_ratio test (disjoint).
        perm = rng.permutation(k)
        n_tr = max(1, int(round(label_ratio * k)))
        n_te = max(1, int(round(test_ratio * k)))
        train_mask[ci, perm[:n_tr]] = 1.0
        test_mask[ci, perm[n_tr:n_tr + n_te]] = 1.0

    batch = ClientBatch(x=x, adj=adj, y=y, node_mask=node_mask,
                        train_mask=train_mask, test_mask=test_mask,
                        global_id=global_id, num_classes=graph.num_classes,
                        aug_max=aug_max)
    return batch, assign


def group_clients_by_server(num_clients: int, num_servers: int) -> np.ndarray:
    """[M] -> server id; contiguous balanced grouping (clients talk to nearest server)."""
    return (np.arange(num_clients) * num_servers // num_clients).astype(np.int32)


def ring_adjacency(num_servers: int, *, self_loop: bool = True) -> np.ndarray:
    """Edge-layer topology A of Sec. III-E (paper testbed uses a ring).

    The single source of ring structure for the server layer:
    :class:`repro_torch.core.strategies.RingTopology` builds its ``TopologyLayout``
    from this matrix, as its reference counterpart does; the reference's
    :func:`repro.core.gossip.block_ring_gossip`'s
    implicit left/right-neighbor schedule realizes the SAME adjacency with
    ``collective_permute`` instead of a materialized [N, N] matrix —
    ``tests/test_gossip.py::TestRingSingleSource`` pins the two against each
    other for N ≥ 3 (at N = 2 a true ring doubles its single edge; callers
    route N ≤ 2 through the adjacency path).
    """
    a = np.zeros((num_servers, num_servers), dtype=np.float32)
    if num_servers == 1:
        return np.ones((1, 1), dtype=np.float32)
    for j in range(num_servers):
        a[j, (j - 1) % num_servers] = 1.0
        a[j, (j + 1) % num_servers] = 1.0
        if self_loop:
            a[j, j] = 1.0
    return a
