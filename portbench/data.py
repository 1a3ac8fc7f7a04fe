"""The inputs of a cell, made from ``--seed``: graph, clients, weights, noise.

Everything is a function of ``(configuration, seed)``. The host part (the
stochastic-block-model edge list, the label-propagation partition and the
label split) is vectorised numpy and small; the features, the clients'
padded subgraphs, the initial weights and each imputation round's noise S
are drawn on the device with ``torch.Generator``s of their own, in a few
large calls. The same seed gives the port and the reference the same
inputs; neither derives them itself.

The graph is the dataset: like the real Coauthor-CS, one graph that every
run shares. Its structure (the SBM edges, the classes and the
label-propagation partition) comes from the configuration's
``structure_seed``, so every seed has the same client sizes and the same
work; ``--seed`` draws which node is which (a permutation of the node ids),
which nodes carry no class signal, the label split, the features, the
weights and the noise.

Layout of the clients' batch (the port's ``ClientBatch``): client i's real
nodes take slots ``[0, size_i)`` in ascending node id; ``n_pad`` is the
largest client plus ``aug_max`` imputation slots; cross-client edges are
deleted (the missing links the imputation restores).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

# Salts of the independent streams drawn from one seed.
_GRAPH, _PART, _FEATURES, _WEIGHTS, _NOISE = 1, 2, 3, 4, 5


def sub_seed(seed: int, *words: int) -> int:
    """A 63-bit seed for one stream of ``seed`` (any whole number)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 63), *words])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(device, seed: int, *words: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *words))


@dataclasses.dataclass
class HostPlan:
    """The host half of a cell's inputs: who is where, and which edges stay."""

    labels: np.ndarray      # [n] int32 class of each node
    silent: np.ndarray      # [n] bool: node whose features carry no class signal
    senders: np.ndarray     # [e] int32, undirected edges (lo < hi), deduplicated
    receivers: np.ndarray   # [e] int32
    assign: np.ndarray      # [n] int32 client of each node
    slot: np.ndarray        # [n] int32 slot of each node inside its client
    train: np.ndarray       # [n] bool
    test: np.ndarray        # [n] bool
    num_clients: int
    n_local_max: int        # the largest client
    aug_max: int

    @property
    def n_pad(self) -> int:
        return self.n_local_max + self.aug_max

    def local_edges(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(client, slot_u, slot_v) of every edge inside one client."""
        keep = self.assign[self.senders] == self.assign[self.receivers]
        s, r = self.senders[keep], self.receivers[keep]
        return self.assign[s], self.slot[s], self.slot[r]


def sbm_edges(rng: np.random.Generator, y: np.ndarray, e: int, c: int,
              homophily: float) -> Tuple[np.ndarray, np.ndarray]:
    """``e`` SBM edge draws: a share ``homophily`` between two distinct nodes
    of an anchor's class, the rest uniform; self loops dropped, undirected
    duplicates merged (lo < hi)."""
    n = len(y)
    intra = rng.random(e) < homophily
    order = np.argsort(y, kind="stable").astype(np.int64)
    counts = np.bincount(y, minlength=c)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    k = y[rng.integers(0, n, size=e)].astype(np.int64)
    m = counts[k]
    i1 = rng.integers(0, np.maximum(m, 1))
    i2 = rng.integers(0, np.maximum(m - 1, 1))
    i2 = i2 + (i2 >= i1)
    u_in = order[start[k] + np.minimum(i1, m - 1)]
    v_in = order[start[k] + np.minimum(i2, m - 1)]
    u_rand = rng.integers(0, n, size=e)
    v_rand = rng.integers(0, n, size=e)
    use = intra & (m >= 2)
    u = np.where(use, u_in, u_rand)
    v = np.where(use, v_in, v_rand)
    keep = u != v
    lo, hi = np.minimum(u, v)[keep], np.maximum(u, v)[keep]
    key = np.unique(lo.astype(np.int64) * n + hi)
    return (key // n).astype(np.int32), (key % n).astype(np.int32)


def label_propagation(n: int, s: np.ndarray, r: np.ndarray, rng: np.random.Generator,
                      iters: int = 20) -> np.ndarray:
    """Community ids [n]: label propagation, each sweep updating a random half
    of the nodes to their neighbours' most frequent label (ties to the
    smallest), which keeps synchronous updates from oscillating."""
    u = np.concatenate([s, r]).astype(np.int64)
    v = np.concatenate([r, s]).astype(np.int64)
    labels = np.arange(n, dtype=np.int64)
    for _ in range(iters):
        key, cnt = np.unique(u * n + labels[v], return_counts=True)
        node, lab = key // n, key % n
        order = np.lexsort((lab, -cnt, node))       # per node: most frequent, then smallest
        node, lab = node[order], lab[order]
        first = np.r_[True, node[1:] != node[:-1]]
        best = labels.copy()
        best[node[first]] = lab[first]
        move = (rng.random(n) < 0.5) & (best != labels)
        if not move.any():
            break
        labels[move] = best[move]
    return np.unique(labels, return_inverse=True)[1].astype(np.int32)


def client_cap(n: int, num_clients: int) -> int:
    """The most nodes ``balance`` leaves on one client: twice the mean."""
    return int(np.floor(2 * n / num_clients))


def balance(communities: np.ndarray, num_clients: int, rng: np.random.Generator) -> np.ndarray:
    """Communities packed into clients, largest first onto the least loaded;
    then a client above twice the mean gives random nodes, one at a time, to
    the least loaded client until it is at most twice the mean."""
    ids, counts = np.unique(communities, return_counts=True)
    loads = [0] * num_clients
    to_client = np.empty(len(ids), dtype=np.int32)
    for i in np.argsort(-counts, kind="stable"):
        t = loads.index(min(loads))
        to_client[i] = t
        loads[t] += int(counts[i])
    assign = to_client[np.searchsorted(ids, communities)]
    cap = client_cap(len(assign), num_clients)
    for c in range(num_clients):
        excess = loads[c] - cap
        if excess <= 0:
            continue
        donors = rng.choice(np.flatnonzero(assign == c), size=excess, replace=False)
        loads[c] -= excess
        for node in donors:
            t = loads.index(min(loads))
            assign[node] = t
            loads[t] += 1
    for c in range(num_clients):          # no client may be empty
        if loads[c] == 0:
            big = loads.index(max(loads))
            node = rng.choice(np.flatnonzero(assign == big))
            assign[node], loads[big], loads[c] = c, loads[big] - 1, 1
    return assign


def host_plan(cfg: Dict, seed: int) -> HostPlan:
    """Graph, partition and label split of configuration ``cfg``: the
    structure from ``structure_seed``, the rest from ``seed``."""
    ds = cfg["dataset"]
    n, c = int(ds["num_nodes"]), int(ds["num_classes"])
    structure = int(ds["structure_seed"])
    rng = np.random.default_rng(sub_seed(structure, _GRAPH))
    y0 = rng.integers(0, c, size=n).astype(np.int32)
    s0, r0 = sbm_edges(rng, y0, int(ds["num_edges"]), c, float(ds["homophily"]))
    m = int(cfg["num_clients"])
    prng = np.random.default_rng(sub_seed(structure, _PART))
    assign0 = balance(label_propagation(n, s0, r0, prng), m, prng)
    srng = np.random.default_rng(sub_seed(seed, _GRAPH))
    new_id = srng.permutation(n).astype(np.int32)
    y = np.empty_like(y0)
    y[new_id] = y0
    assign = np.empty_like(assign0)
    assign[new_id] = assign0
    u, v = new_id[s0], new_id[r0]
    s, r = np.minimum(u, v), np.maximum(u, v)
    silent = srng.random(n) >= float(ds["signal_ratio"])
    order = np.argsort(assign, kind="stable")
    sizes = np.bincount(assign, minlength=m)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    slot = np.empty(n, dtype=np.int32)
    slot[order] = np.arange(n) - np.repeat(starts, sizes)
    train = np.zeros(n, dtype=bool)
    test = np.zeros(n, dtype=bool)
    for ci in range(m):
        nodes = order[starts[ci]:starts[ci] + sizes[ci]]
        perm = srng.permutation(nodes)
        n_tr = max(1, int(round(float(ds["label_ratio"]) * len(nodes))))
        n_te = max(1, int(round(float(ds["test_ratio"]) * len(nodes))))
        train[perm[:n_tr]] = True
        test[perm[n_tr:n_tr + n_te]] = True
    return HostPlan(labels=y, silent=silent, senders=s, receivers=r, assign=assign,
                    slot=slot, train=train, test=test, num_clients=m,
                    n_local_max=int(sizes.max()), aug_max=int(cfg["aug_max"]))


def features(cfg: Dict, plan: HostPlan, seed: int, device) -> torch.Tensor:
    """[n, d] f32 node features on ``device``: the class centroid plus noise,
    or noise alone on silent nodes."""
    ds = cfg["dataset"]
    n, d, c = len(plan.labels), int(ds["feature_dim"]), int(ds["num_classes"])
    gen = generator(device, seed, _FEATURES)
    centroids = torch.randn((c, d), generator=gen, device=device)
    x = torch.randn((n, d), generator=gen, device=device).mul_(float(ds["feature_noise"]))
    signal = torch.as_tensor(~plan.silent, device=device)
    x[signal] += centroids[torch.as_tensor(plan.labels, device=device).long()[signal]]
    return x


def client_tensors(cfg: Dict, plan: HostPlan, seed: int, device) -> Dict[str, torch.Tensor]:
    """The clients' padded subgraphs as the fields of the port's
    ``ClientBatch``, on ``device``."""
    m, n_pad = plan.num_clients, plan.n_pad
    dev = torch.device(device)
    idx = lambda a: torch.as_tensor(a, device=dev).long()  # noqa: E731
    cl, sl = idx(plan.assign), idx(plan.slot)
    feats = features(cfg, plan, seed, dev)
    x = torch.zeros((m, n_pad, feats.shape[1]), dtype=torch.float32, device=dev)
    x[cl, sl] = feats
    del feats
    adj = torch.zeros((m, n_pad, n_pad), dtype=torch.float32, device=dev)
    ec, eu, ev = (idx(a) for a in plan.local_edges())
    adj[ec, eu, ev] = 1.0
    adj[ec, ev, eu] = 1.0

    def per_slot(values, fill, dtype):
        out = np.full((m, n_pad), fill, dtype=dtype)
        out[plan.assign, plan.slot] = values
        return torch.as_tensor(out, device=dev)

    n = len(plan.labels)
    return {"x": x, "adj": adj,
            "y": per_slot(plan.labels, -1, np.int32),
            "node_mask": per_slot(np.ones(n), 0.0, np.float32),
            "train_mask": per_slot(plan.train, 0.0, np.float32),
            "test_mask": per_slot(plan.test, 0.0, np.float32),
            "global_id": per_slot(np.arange(n), -1, np.int32)}


def _glorot(gen: torch.Generator, lead, fan_in: int, fan_out: int) -> torch.Tensor:
    lim = (6.0 / (fan_in + fan_out)) ** 0.5
    u = torch.rand(tuple(lead) + (fan_in, fan_out), generator=gen, device=gen.device)
    return u.mul_(2 * lim).sub_(lim)


def initial_weights(cfg: Dict, seed: int, num_servers: int, device) -> Dict:
    """Glorot-uniform weights, zero biases, in the nesting the port documents
    (``core/gnn.py``, ``core/imputation.py``, ``core/assessor.py``): every
    client starts from one classifier (Algorithm 1 line 3), every server
    from its own autoencoder and assessor. Returns ``{"params", "ae",
    "assessor"}`` with leading [M] and [N] axes."""
    ds, model, fgl = cfg["dataset"], cfg["model"], cfg["fgl"]
    d, c, h, m = (int(ds["feature_dim"]), int(ds["num_classes"]),
                  int(model["hidden_dim"]), int(cfg["num_clients"]))
    gen = generator(device, seed, _WEIGHTS)
    zeros = lambda lead, w: torch.zeros(tuple(lead) + (w,), device=device)  # noqa: E731
    dims = [d] + [h] * (int(model["num_layers"]) - 1) + [c]
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        layers.append({"w_self": _glorot(gen, (), a, b).expand(m, a, b).clone(),
                       "w_nbr": _glorot(gen, (), a, b).expand(m, a, b).clone(),
                       "b": zeros((m,), b)})
    n, eh = num_servers, int(fgl["ae_hidden"])
    ae = {"enc": [{"w": _glorot(gen, (n,), c, eh), "b": zeros((n,), eh)},
                  {"w": _glorot(gen, (n,), eh, d), "b": zeros((n,), d)}],
          "dec": [{"w": _glorot(gen, (n,), d, eh), "b": zeros((n,), eh)},
                  {"w": _glorot(gen, (n,), eh, c), "b": zeros((n,), c)}]}
    adims = [c] + [int(w) for w in fgl["assessor_hidden"]] + [1]
    assessor = {"layers": [{"w": _glorot(gen, (n,), a, b), "b": zeros((n,), b)}
                           for a, b in zip(adims[:-1], adims[1:])]}
    return {"params": {"layers": layers}, "ae": ae, "assessor": assessor}


def noise(cfg: Dict, plan: HostPlan, seed: int, num_servers: int, round_: int,
          device) -> torch.Tensor:
    """Round ``round_``'s imputation noise S ``[N, M_per * n_pad, c]``."""
    m_per = plan.num_clients // num_servers
    c = int(cfg["dataset"]["num_classes"])
    gen = generator(device, seed, _NOISE, round_)
    return torch.randn((num_servers, m_per * plan.n_pad, c), generator=gen, device=device)
