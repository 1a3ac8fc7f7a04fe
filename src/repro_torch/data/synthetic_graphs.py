"""Synthetic benchmark graphs (offline stand-ins for Cora/Citeseer/WikiCS/CoauthorCS).

A numpy copy of ``repro.data.synthetic_graphs``: the same call sequence on
the same ``default_rng`` streams, so both packages build the same graphs bit
for bit (``tests/test_torch_data_adam.py`` pins this at every scale regime).

The container has no network access, so the four benchmark datasets of the paper
are replaced with stochastic-block-model graphs whose (n, d, c, |E|) statistics
match Table I. Class-correlated features + homophilous edges preserve the
property the paper's claims rest on: GNN accuracy degrades when cross-subgraph
links are deleted and recovers when they are imputed.

``scale`` moves n/|E| proportionally in BOTH directions: most tests and
benchmarks use scale < 1 so CPU runs finish quickly, while ``scale > 1.0``
is the documented way to grow a Table-I dataset toward the 10k–1M-node
regime the scaling benchmarks sweep (``benchmarks/bench_sim_scaling.py``
reaches 1M nodes via a custom :class:`DatasetStats`). Node and edge counts
are monotone in ``scale``; the feature dim saturates at the dataset's real
``feature_dim`` once ``scale >= 0.25`` (growing n should not also inflate
every feature row). The scale-up path swaps the per-edge Python sampler for
a vectorized one — same SBM distribution, different rng stream — so the
generator stays deterministic in (stats, scale, seed) at every scale while
scale <= 1.0 graphs remain bit-identical to the historical sampler (both
regimes pinned in ``tests/test_synthetic_scale.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.core.types import Graph


@dataclasses.dataclass(frozen=True)
class DatasetStats:
    name: str
    num_nodes: int
    num_edges: int
    feature_dim: int
    num_classes: int
    homophily: float  # fraction of edges within a class


# Table I of the paper.
DATASETS: Dict[str, DatasetStats] = {
    "cora": DatasetStats("cora", 2708, 5429, 1433, 7, 0.81),
    "citeseer": DatasetStats("citeseer", 3327, 4715, 3703, 6, 0.74),
    "wikics": DatasetStats("wikics", 11701, 215863, 300, 10, 0.65),
    "coauthor_cs": DatasetStats("coauthor_cs", 18333, 81894, 6805, 15, 0.80),
}


def make_sbm_graph(stats: DatasetStats, *, scale: float = 1.0, seed: int = 0,
                   feature_noise: float = 1.0, signal_ratio: float = 1.0) -> Graph:
    """Stochastic-block-model graph with class-centroid features.

    Nodes get a class label; edges are sampled so that ``homophily`` of them are
    intra-class; features are a class centroid plus isotropic noise, embedded in
    ``d`` dims. ``signal_ratio`` < 1 leaves a fraction of nodes with pure-noise
    features — those nodes are classifiable only through neighbor aggregation,
    which is what makes missing cross-subgraph links (and their imputation)
    matter, mirroring the role of multi-hop propagation in the paper.
    Deterministic given (stats, scale, seed).
    """
    rng = np.random.default_rng(seed)
    n = max(stats.num_classes * 8, int(round(stats.num_nodes * scale)))
    e = max(n, int(round(stats.num_edges * scale)))
    d = max(8, int(round(stats.feature_dim * min(1.0, scale * 4))))
    c = stats.num_classes

    y = rng.integers(0, c, size=n).astype(np.int32)
    # Class centroids, well separated but noisy.
    centroids = rng.normal(0.0, 1.0, size=(c, d)).astype(np.float32)
    x = centroids[y] + feature_noise * rng.normal(0.0, 1.0, size=(n, d)).astype(np.float32)
    if signal_ratio < 1.0:
        silent = rng.random(n) >= signal_ratio
        x[silent] = feature_noise * rng.normal(0.0, 1.0, size=(int(silent.sum()), d)).astype(np.float32)

    # Sample edges: homophilous fraction intra-class, rest uniform.
    if scale > 1.0:
        senders, receivers = _sample_edges_vectorized(rng, y, n, e, c,
                                                      stats.homophily)
    else:
        senders, receivers = _sample_edges_loop(rng, y, n, e, c,
                                                stats.homophily)
    keep = senders != receivers
    senders, receivers = senders[keep], receivers[keep]
    # Deduplicate undirected pairs.
    lo = np.minimum(senders, receivers)
    hi = np.maximum(senders, receivers)
    pairs = np.unique(np.stack([lo, hi], axis=1), axis=0)
    return Graph(x=x, senders=pairs[:, 0].astype(np.int32),
                 receivers=pairs[:, 1].astype(np.int32), y=y, num_classes=c)


def _sample_edges_loop(rng, y, n: int, e: int, c: int, homophily: float):
    """Per-edge Python sampler — the historical rng stream.

    Kept verbatim for ``scale <= 1.0``: every fixed-seed golden in the test
    suite was produced by this exact call sequence, so the small-graph
    regime must never change streams.
    """
    per_class = [np.where(y == k)[0] for k in range(c)]
    senders = np.empty(e, dtype=np.int32)
    receivers = np.empty(e, dtype=np.int32)
    intra = rng.random(e) < homophily
    for i in range(e):
        if intra[i]:
            k = int(y[rng.integers(0, n)])
            members = per_class[k]
            if len(members) < 2:
                senders[i], receivers[i] = rng.integers(0, n, size=2)
                continue
            u, v = rng.choice(members, size=2, replace=False)
        else:
            u, v = rng.integers(0, n, size=2)
        senders[i], receivers[i] = u, v
    return senders, receivers


def _sample_edges_vectorized(rng, y, n: int, e: int, c: int, homophily: float):
    """Batch sampler for the scale-up regime: O(e) numpy ops, no Python loop.

    Same SBM distribution as :func:`_sample_edges_loop` — an intra edge
    draws an anchor node uniformly (so class mass follows class size) and
    then two DISTINCT members of that class; an inter edge draws two
    uniform endpoints — but a different rng stream, which is why it only
    serves ``scale > 1.0`` (no historical goldens to preserve up there).
    """
    intra = rng.random(e) < homophily
    # Group nodes by class once: members of class k are
    # order[start[k] : start[k] + counts[k]].
    order = np.argsort(y, kind="stable").astype(np.int64)
    counts = np.bincount(y, minlength=c)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])

    k = y[rng.integers(0, n, size=e)].astype(np.int64)       # anchor's class
    m = counts[k]                                            # class sizes
    # Two distinct member slots via the shifted-draw trick: i2 is drawn from
    # the m-1 slots that are not i1.
    i1 = rng.integers(0, np.maximum(m, 1))
    i2 = rng.integers(0, np.maximum(m - 1, 1))
    i2 = i2 + (i2 >= i1)
    u_intra = order[start[k] + np.minimum(i1, m - 1)]
    v_intra = order[start[k] + np.minimum(i2, m - 1)]

    u_rand = rng.integers(0, n, size=e)
    v_rand = rng.integers(0, n, size=e)
    # Classes with < 2 members fall back to uniform, like the loop sampler.
    use_intra = intra & (m >= 2)
    senders = np.where(use_intra, u_intra, u_rand).astype(np.int32)
    receivers = np.where(use_intra, v_intra, v_rand).astype(np.int32)
    return senders, receivers


def load_dataset(name: str, *, scale: float = 1.0, seed: int = 0,
                 feature_noise: float = 1.0, signal_ratio: float = 1.0) -> Graph:
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(DATASETS)}")
    return make_sbm_graph(DATASETS[name], scale=scale, seed=seed,
                          feature_noise=feature_noise, signal_ratio=signal_ratio)
