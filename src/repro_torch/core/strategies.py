"""Pluggable strategy components of the FGL engine.

Counterpart of ``repro.core.strategies``:

- :class:`Topology`: how clients map onto edge servers and how servers are
  wired (star = FedGL, ring = SpreadFGL's testbed, custom adjacency).
- :class:`Aggregator`: how stacked [M] client classifiers are combined each
  round: identity, FedAvg, Eq. 16, gossip every K rounds, or FedBuff-style
  buffered async aggregation; each takes an optional [M] participation
  mask.
- :class:`ImputationStrategy`: the every-K graph-fixing round (SpreadFGL's
  generator round, or FedSage+'s local generation).

The per-round schedules (participation masks, async delays and dropouts)
draw from CPU ``torch.Generator``s seeded from ``(seed, salt, round)``, so
the same run on the card and on the CPU draws the same schedule, and a
restored checkpoint replays it from its round. A mesh here is a
``launch.mesh.Mesh`` (one process per device): the gossip ``mesh`` places
the exchange's server blocks on its ranks, and ``SpreadImputation``'s
``sim_mesh`` shards the similarity search's candidate axis over them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import gossip, imputation, patcher
from repro_torch.core.partition import group_clients_by_server, ring_adjacency
from repro_torch.core.types import ClientBatch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim.adam import Adam
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PyTree = Any


def keyed_generator(*words: int) -> torch.Generator:
    """A CPU generator seeded from a tuple of non-negative integers (hashed
    by numpy's ``SeedSequence``): one independent stream per tuple."""
    seed = np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed))


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

def participation_mask(generator: torch.Generator, num_clients: int,
                       rho: float) -> torch.Tensor:
    """One round's participating-client mask: [M] float32 0/1 on the CPU.

    Exactly ``ceil(rho * M)`` clients participate, drawn without
    replacement from ``generator``, so at least one client always does.
    """
    if not 0.0 < rho <= 1.0:
        raise ValueError(f"participation must be in (0, 1], got {rho}")
    k = min(num_clients, max(1, int(np.ceil(rho * num_clients - 1e-9))))
    perm = torch.randperm(num_clients, generator=generator)
    mask = torch.zeros(num_clients, dtype=torch.float32)
    mask[perm[:k]] = 1.0
    return mask


def _masked_server_mean(leaf: torch.Tensor, mask_g: torch.Tensor,
                        num_servers: int, m_per: int) -> torch.Tensor:
    """Participation-weighted per-server mean over a grouped leaf.

    ``mask_g`` is the [N, m_per] mask. A server whose clients all sit out
    falls back to the plain mean (it re-broadcasts what it holds).
    """
    tail = (1,) * (leaf.ndim - 1)
    grouped = leaf.reshape((num_servers, m_per) + leaf.shape[1:])
    shaped = mask_g.reshape((num_servers, m_per) + tail)
    num = torch.sum(grouped * shaped, dim=1)
    den = torch.sum(mask_g, dim=1).reshape((num_servers,) + tail)
    plain = torch.sum(grouped, dim=1) / m_per
    return torch.where(den > 0, num / torch.clamp_min(den, 1.0), plain)


@runtime_checkable
class Aggregator(Protocol):
    """Combine stacked [M] client classifiers once per global round.

    ``round`` is the phase the engine derives from the absolute round
    (``FGLTrainer._agg_phase``); aggregators without a schedule ignore it.
    ``mask`` is the round's optional [M] weight vector (participation mask,
    async staleness weights, or their product); ``mask=None`` takes the
    exact unmasked code path.
    """

    def aggregate(self, params: PyTree, *, adj: torch.Tensor,
                  num_servers: int, m_per: int, round: int = 0,
                  mask: Optional[torch.Tensor] = None) -> PyTree: ...


@dataclasses.dataclass(frozen=True)
class IdentityAggregator:
    """No aggregation: clients keep their own weights (LocalFGL, Sec. IV-A).
    ``mask`` is ignored: a non-participating client keeps its weights."""

    def aggregate(self, params, *, adj, num_servers, m_per, round=0, mask=None):
        return params


@dataclasses.dataclass(frozen=True)
class FedAvgAggregator:
    """Per-server FedAvg: mean over covered clients (over the participating
    ones under a mask), broadcast back."""

    def aggregate(self, params, *, adj, num_servers, m_per, round=0, mask=None):
        if mask is None:
            def agg(leaf):
                grouped = leaf.reshape((num_servers, m_per) + leaf.shape[1:])
                w = torch.sum(grouped, dim=1) / m_per
                return torch.repeat_interleave(w, m_per, dim=0)
        else:
            mask_g = mask.reshape(num_servers, m_per)

            def agg(leaf):
                w = _masked_server_mean(leaf, mask_g, num_servers, m_per)
                return torch.repeat_interleave(w, m_per, dim=0)
        return tree_map(agg, params)


@dataclasses.dataclass(frozen=True)
class NeighborAggregator:
    """Eq. 16 (Sec. III-E): each server averages itself and its topology
    neighbors densely, every round:
    W_j = sum_r a_rj * sum_i W_(r,i) / sum_r a_rj M_r.

    Under a mask, M_r becomes the round's participating count; a
    neighborhood that entirely sat out falls back to the plain Eq. 16 mix.
    """

    def aggregate(self, params, *, adj, num_servers, m_per, round=0, mask=None):
        if mask is None:
            def agg(leaf):
                grouped = leaf.reshape((num_servers, m_per) + leaf.shape[1:])
                client_sum = torch.sum(grouped, dim=1)                 # [N, ...]
                num = torch.einsum("rj,r...->j...", adj, client_sum)
                den = torch.sum(adj, dim=0) * m_per                    # [N]
                w = num / den.reshape((num_servers,) + (1,) * (leaf.ndim - 1))
                return torch.repeat_interleave(w, m_per, dim=0)
        else:
            mask_g = mask.reshape(num_servers, m_per)
            counts = torch.sum(mask_g, dim=1)                          # [N]

            def agg(leaf):
                tail = (1,) * (leaf.ndim - 1)
                grouped = leaf.reshape((num_servers, m_per) + leaf.shape[1:])
                shaped = mask_g.reshape((num_servers, m_per) + tail)
                num = torch.einsum("rj,r...->j...", adj, torch.sum(grouped * shaped, dim=1))
                den = torch.einsum("r,rj->j", counts, adj).reshape((num_servers,) + tail)
                plain_num = torch.einsum("rj,r...->j...", adj, torch.sum(grouped, dim=1))
                plain_den = (torch.sum(adj, dim=0) * m_per).reshape((num_servers,) + tail)
                w = torch.where(den > 0, num / torch.clamp_min(den, 1.0),
                                plain_num / plain_den)
                return torch.repeat_interleave(w, m_per, dim=0)
        return tree_map(agg, params)


@dataclasses.dataclass(frozen=True, eq=False)
class GossipAggregator:
    """Sec. III-E load balancing as gossip over the edge servers.

    Each round every server FedAvg-aggregates its own clients; the
    cross-server exchange with topology neighbors (Eq. 16 weights) happens
    only every ``every_k`` rounds. ``topology="ring"`` exchanges through
    :func:`gossip.block_ring_gossip` (N >= 3; N <= 2 takes the adjacency
    path, where a 2-ring's double edge would be counted twice),
    ``"adjacency"`` through :func:`gossip.adjacency_gossip`. With
    ``every_k=1`` it equals :class:`NeighborAggregator`; on skip rounds,
    per-server FedAvg. Under a mask, participation gates the edge-client
    leg only. With ``mesh`` (the edge mesh) each rank exchanges its block
    of ``N / size`` servers with its ring neighbors (one boundary slice each
    way) or, for an adjacency, through an all-gather, and the blocks are
    gathered back, so every rank holds the whole [N] result.
    """

    topology: str = "ring"        # "ring" | "adjacency"
    every_k: int = 1
    mesh: Any = None

    def __post_init__(self):
        if self.topology not in ("ring", "adjacency"):
            raise ValueError(f"unknown gossip topology {self.topology!r}; "
                             f"expected 'ring' or 'adjacency'")
        if self.every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {self.every_k}")

    @property
    def period(self) -> int:
        """Exchange schedule length; the engine passes ``round`` mod this."""
        return self.every_k

    def aggregate(self, params, *, adj, num_servers, m_per, round=0, mask=None):
        if mask is None:
            def server_mean(leaf):
                grouped = leaf.reshape((num_servers, m_per) + leaf.shape[1:])
                return torch.sum(grouped, dim=1) / m_per
        else:
            mask_g = mask.reshape(num_servers, m_per)

            def server_mean(leaf):
                return _masked_server_mean(leaf, mask_g, num_servers, m_per)

        w = tree_map(server_mean, params)                          # [N, ...]
        if num_servers > 1 and (round + 1) % self.every_k == 0:
            w = self._exchange(w, adj, num_servers)
        return tree_map(lambda leaf: torch.repeat_interleave(leaf, m_per, dim=0), w)

    def _exchange(self, w: PyTree, adj, num_servers: int) -> PyTree:
        use_ring = self.topology == "ring" and num_servers >= 3
        mesh = self.mesh
        if mesh is None or mesh.size == 1:
            return gossip.block_ring_gossip(w) if use_ring else gossip.adjacency_gossip(w, adj)
        if num_servers % mesh.size:
            raise ValueError(f"N={num_servers} servers must divide across the "
                             f"{mesh.size}-device edge mesh")
        nb = num_servers // mesh.size
        blk = tree_map(lambda x: x[mesh.rank * nb:(mesh.rank + 1) * nb], w)
        blk = (gossip.block_ring_gossip(blk, mesh) if use_ring
               else gossip.adjacency_gossip(blk, adj, mesh))
        return tree_unflatten(blk, mesh_lib.all_gather_tree(mesh, tree_leaves(blk)))


# ---------------------------------------------------------------------------
# Async straggler-tolerant aggregation (FedBuff-style).
# ---------------------------------------------------------------------------

ASYNC_DELAY_DISTS = ("zero", "uniform", "geometric")

# Salt of the async delay/dropout stream; the participation stream has its
# own (PARTICIPATION_SALT), and neither touches the training generator.
ASYNC_SALT = 0xA57C
PARTICIPATION_SALT = 0x9A57


def async_delay_stream(seed: int, round: int, num_clients: int, *,
                       delay_dist: str = "zero", max_delay: int = 4,
                       dropout_rate: float = 0.0):
    """Round ``round``'s arrival delays and dropout flags, per client.

    Returns ``(delays int32 [M], drops bool [M])`` numpy arrays: how many
    rounds client i's update stays in flight (0 = arrives this round), and
    whether it is lost at send time (the client retries next round). The
    delays draw from ``keyed_generator(seed, ASYNC_SALT, round, 0)`` and the
    drops from ``(..., 1)``: a pure function of (seed, round), and the drops
    do not depend on the delay distribution.

    ``"zero"``: no delay; ``"uniform"``: uniform on {0..max_delay};
    ``"geometric"``: p = 1/2 on {0, 1, ...} by float64 inverse transform,
    capped at ``max_delay``.
    """
    if delay_dist not in ASYNC_DELAY_DISTS:
        raise ValueError(f"unknown delay_dist {delay_dist!r}; "
                         f"expected one of {ASYNC_DELAY_DISTS}")
    if max_delay < 0:
        raise ValueError(f"max_delay must be >= 0, got {max_delay}")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    kd = keyed_generator(seed, ASYNC_SALT, round, 0)
    kx = keyed_generator(seed, ASYNC_SALT, round, 1)
    if delay_dist == "zero":
        delays = np.zeros(num_clients, np.int32)
    elif delay_dist == "uniform":
        delays = torch.randint(0, max_delay + 1, (num_clients,),
                               generator=kd).numpy().astype(np.int32)
    else:
        u = torch.rand(num_clients, generator=kd).numpy().astype(np.float64)
        delays = np.minimum(np.floor(np.log1p(-u) / np.log(0.5)),
                            max_delay).astype(np.int32)
    drops = torch.rand(num_clients, generator=kx).numpy() < dropout_rate
    return delays, drops


# (spec, stream) -> incremental replay state; see _async_schedule. Purely a
# cache: entries are reproducible from scratch.
_ASYNC_SCHEDULES: dict = {}


def _async_schedule(spec: tuple, round: int, stream: Optional[Callable] = None):
    """``(flush, weights)`` of round ``round`` for one async spec.

    ``spec = (seed, num_clients, buffer_size, delay_dist, max_delay,
    dropout_rate)``; ``stream`` is the delay/dropout draw with
    :func:`async_delay_stream`'s signature (that function when None; the
    cache is keyed by it too). Replays the client state machine from round
    0, cached incrementally:

    - a client with no update in flight sends one every round; the round's
      draw gives its arrival delay, or drops it;
    - an update arriving at round t joins the buffer with report round t
      (one slot per client: a fresher arrival replaces a staler one);
    - when >= buffer_size updates are buffered at the end of a round, the
      server flushes with ``weights[i] = 1/sqrt(1 + t - report[i])`` for
      buffered clients, 0 elsewhere, and the buffer empties.

    On non-flush rounds weights is None (aggregation is identity).
    """
    stream = async_delay_stream if stream is None else stream
    seed, m, buffer_size, delay_dist, max_delay, dropout_rate = spec
    cache = _ASYNC_SCHEDULES.setdefault((spec, stream), {
        "next": 0,
        "arrival": np.full(m, -1, np.int64),   # in-flight arrival round
        "report": np.full(m, -1, np.int64),    # buffered report round
        "out": [],
    })
    arrival, report = cache["arrival"], cache["report"]
    while cache["next"] <= round:
        t = cache["next"]
        delays, drops = stream(seed, t, m, delay_dist=delay_dist,
                               max_delay=max_delay, dropout_rate=dropout_rate)
        free = arrival < 0
        send = free & ~drops
        arrival[send] = t + delays[send]
        arrived = arrival == t
        report[arrived] = t
        arrival[arrived] = -1
        buffered = report >= 0
        if int(buffered.sum()) >= buffer_size:
            tau = (t - report).astype(np.float32)
            weights = np.where(buffered,
                               1.0 / np.sqrt(np.float32(1.0) + tau),
                               np.float32(0.0)).astype(np.float32)
            report[:] = -1
            cache["out"].append((True, weights))
        else:
            cache["out"].append((False, None))
        cache["next"] = t + 1
    return cache["out"][round]


@dataclasses.dataclass(frozen=True)
class AsyncAggregator:
    """Buffered straggler-tolerant aggregation (FedBuff, Nguyen et al. '22).

    Client updates report with per-round arrival delays and dropouts
    (:func:`async_delay_stream`); the server buffers them and flushes only
    once ``buffer_size`` are buffered. On a flush each edge server takes the
    staleness-discounted mean of its buffered clients,
    W_j = sum_i w_i W_(j,i) / sum_i w_i with w_i = 1 / sqrt(1 + tau_i), and
    broadcasts it; a server with nothing buffered keeps its clients'
    weights. Non-flush rounds are identity. The schedule is a pure function
    of (seed, round), so a resume mid-buffer replays it exactly. With
    ``buffer_size = M``, zero delays and no dropouts every weight is 1.0 and
    the flush is :class:`FedAvgAggregator`'s unmasked mean, bit for bit.
    """

    buffer_size: int = 1
    delay_dist: str = "zero"      # "zero" | "uniform" | "geometric"
    dropout_rate: float = 0.0     # P(update lost at send), per client-round
    max_delay: int = 4            # delay cap in rounds
    seed: int = 0

    def __post_init__(self):
        if self.buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {self.buffer_size}")
        if self.delay_dist not in ASYNC_DELAY_DISTS:
            raise ValueError(f"unknown delay_dist {self.delay_dist!r}; "
                             f"expected one of {ASYNC_DELAY_DISTS}")
        if not 0.0 <= self.dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1), "
                             f"got {self.dropout_rate}")
        if self.max_delay < 0:
            raise ValueError(f"max_delay must be >= 0, got {self.max_delay}")

    def _spec(self, num_clients: int) -> tuple:
        if self.buffer_size > num_clients:
            raise ValueError(
                f"buffer_size={self.buffer_size} can never fill: the buffer "
                f"holds at most one update per client (M={num_clients})")
        return (self.seed, num_clients, self.buffer_size, self.delay_dist,
                self.max_delay, self.dropout_rate)

    def phase(self, round: int, num_clients: int) -> int:
        """1 on flush rounds, 0 otherwise."""
        flush, _ = _async_schedule(self._spec(num_clients), round)
        return int(flush)

    def round_weights(self, round: int, num_clients: int) -> Optional[torch.Tensor]:
        """[M] float32 staleness weights (CPU) on flush rounds, else None."""
        _, weights = _async_schedule(self._spec(num_clients), round)
        return None if weights is None else torch.from_numpy(weights.copy())

    def aggregate(self, params, *, adj, num_servers, m_per, round=0, mask=None):
        """``round`` is the flush phase (1 = flush); ``mask`` carries the
        [M] staleness weights (zero = not buffered). ``adj`` is unused: the
        flush is per server."""
        if not round or mask is None:
            return params
        mask_g = mask.to(torch.float32).reshape(num_servers, m_per)
        den = torch.sum(mask_g, dim=1)                       # [N] total weight

        def agg(leaf):
            tail = (1,) * (leaf.ndim - 1)
            grouped = leaf.reshape((num_servers, m_per) + leaf.shape[1:])
            shaped = mask_g.reshape((num_servers, m_per) + tail)
            num = torch.sum(grouped * shaped, dim=1)
            den_s = den.reshape((num_servers,) + tail)
            w = num / torch.where(den_s > 0, den_s, torch.ones_like(den_s))
            keep = torch.repeat_interleave(den > 0, m_per).reshape(
                (num_servers * m_per,) + tail)
            return torch.where(keep, torch.repeat_interleave(w, m_per, dim=0), leaf)
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


@dataclasses.dataclass(frozen=True, eq=False)
class SpreadImputation:
    """SpreadFGL's generator round (Algorithm 1 lines 11-24).

    Fuse client embeddings per server, train the AE/assessor pair
    adversarially, take cross-subgraph top-k similarity links, and fix every
    client graph. The [N] server axis is one batched pass (the similarity
    top-k is one kernel launch for all servers), or, on the engine's edge
    mesh, one pass per rank over its block of servers
    (``FGLTrainer.on_edge``); per-server results are stitched back to the
    global flat index space.

    With ``sim_mesh`` the similarity top-k is lifted out of the server
    round: the generator half runs over [N] (on the edge mesh, if any), and
    one ring call (``core/ring_topk.py``) over the fused ``[N, n_flat, c]``
    embeddings, whole on every rank, shards the candidate axis over the
    mesh's ranks. The ring's result is the one-call result.

    ``noise`` is the round's S, ``[N, M_per*n_pad, c]``; when None it is
    drawn for all N servers from the state's generator. Tests hand in the
    reference's S.
    """

    sim_mesh: Any = None

    active = True

    def server_outputs(self, engine, state, noise=None):
        """The batched [N] generator round, before graph fixing.

        Returns ``(ae_params, ae_opt, as_params, as_opt, scores, idx, x_bar)``
        with leading [N] axes: the raw link proposals.
        """
        batch = state.batch
        with trace.span("fgl.impute.embed"):
            emb = engine._embeddings(state.params, batch)   # [M, n_pad, c]
        n_pad = batch.x.shape[1]
        n, mp = engine.n_servers, engine.m_per
        emb_g = emb.reshape((n, mp) + emb.shape[1:])        # [N, M_per, n_pad, c]
        mask_g = batch.node_mask.reshape(n, mp, n_pad)
        if noise is None:
            noise = imputation.sample_noise(state.gen, mp * n_pad,
                                            engine.num_classes, lead=(n,))
        client_ids = imputation.client_of_flat(mp, n_pad, device=emb.device)
        stacked = (state.ae_params, state.ae_opt, state.as_params, state.as_opt,
                   emb_g, mask_g, noise)
        if self.sim_mesh is None:
            def server_round(ae, aeo, asr, aso, emb_j, mask_j, s_noise):
                return engine._server_round(ae, aeo, asr, aso, emb_j, mask_j, client_ids,
                                            s_noise)
            return engine.on_edge(server_round, stacked)
        ae, aeo, asr, aso, x_bar, h_all, fmask_all = engine.on_edge(
            engine._server_round_gen, stacked)
        tmask_all = fmask_all * imputation.local_slot_mask(
            mp, n_pad, engine.n_local, device=fmask_all.device)[None, :]
        with trace.span("fgl.impute.topk"):
            scores, idx = imputation.similarity_topk(
                h_all, fmask_all, client_ids, engine.cfg.top_k_links,
                target_mask=tmask_all, mesh=self.sim_mesh)
        return ae, aeo, asr, aso, scores, idx, x_bar

    def impute(self, engine, state, noise=None):
        with trace.span("fgl.impute"):
            (ae_params, ae_opt, as_params, as_opt, scores, idx,
             x_bar) = self.server_outputs(engine, state, noise)
            with trace.span("fgl.impute.patch"):
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


@dataclasses.dataclass(frozen=True)
class LocalGenImputation:
    """FedSage+-style purely local neighbor generation (Zhang et al. '21).

    Per client: train a linear x -> mean(neighbor x) predictor on the
    client's own neighborhoods, then append one synthetic neighbor to each
    of the ``aug_max`` highest-degree nodes. No cross-client information
    flows. Deterministic: it draws nothing from the state's generator.
    """

    gen_steps: int = 20

    active = True

    def impute(self, engine, state, noise=None):
        engine._release_graph()
        with trace.span("fgl.impute"):
            batch = _local_generation(state.batch, self.gen_steps)
        return dataclasses.replace(state, batch=batch)


def _local_generation(batch: ClientBatch, gen_steps: int) -> ClientBatch:
    """FedSage+'s generator, all M clients in one batched pass: ``W [M, d, d]``
    and ``b [M, d]`` from zero, ``gen_steps`` Adam steps (lr 1e-2) on the
    masked squared error, then the augmented batch in new tensors."""
    x, adj, node_mask = batch.x, batch.adj, batch.node_mask
    m, n_pad, d = x.shape
    n_local, aug = batch.n_local_max, batch.aug_max
    nm = node_mask[:, :n_local]
    a = adj[:, :n_local, :n_local] * (nm[:, :, None] * nm[:, None, :])
    deg = torch.sum(a, dim=-1)                                    # [M, n_local]
    xl = x[:, :n_local]
    target = (a @ xl) / torch.clamp_min(deg[..., None], 1.0)
    # The loss per client is sum((pred - target)^2 * mask) / max(sum(mask), 1)
    # over nodes with a neighbor; its gradient is written out (x needs none).
    mask = (deg > 0).to(x.dtype)
    inv = mask / torch.clamp_min(torch.sum(mask, -1, keepdim=True), 1.0)   # [M, n_local]
    xl_t = xl.transpose(1, 2)
    opt = Adam(lr=1e-2)
    p = {"w": torch.zeros((m, d, d), dtype=torch.float32, device=x.device),
         "b": torch.zeros((m, d), dtype=torch.float32, device=x.device)}
    st = opt.init(p, lead=(m,))
    for _ in range(gen_steps):
        g_pred = inv[..., None] * (2.0 * (xl @ p["w"] + p["b"][:, None, :] - target))
        p, st = opt.update({"w": xl_t @ g_pred, "b": torch.sum(g_pred, dim=1)}, st, p)

    # Highest-degree real nodes get one synthetic neighbor each; ties go to
    # the lower index, as jax.lax.top_k breaks them.
    score = torch.where(nm > 0, deg, torch.full_like(deg, -torch.inf))
    src = torch.sort(score, dim=-1, descending=True, stable=True).indices[:, :aug]
    ok = torch.isfinite(torch.gather(score, 1, src)).to(x.dtype)       # [M, aug]
    x_src = torch.gather(xl, 1, src[..., None].expand(m, aug, d))
    feats = x_src @ p["w"] + p["b"][:, None, :]
    rows = torch.arange(m, device=x.device)[:, None].expand(m, aug)
    aug_rows = (n_local + torch.arange(aug, device=x.device))[None, :].expand(m, aug)
    x_new = x.clone()
    x_new[:, n_local:] = feats * ok[..., None]     # aug rows are exactly [n_local, n_pad)
    adj_new = adj.clone()
    adj_new[:, n_local:, :] = 0.0
    adj_new[:, :, n_local:] = 0.0
    adj_new[rows, src, aug_rows] = ok
    adj_new[rows, aug_rows, src] = ok
    mask_new = node_mask.clone()
    mask_new[:, n_local:] = ok
    return batch.replace(x=x_new, adj=adj_new, node_mask=mask_new)


def _take_opt(opt, j):
    return type(opt)(opt.step[j], tree_map(lambda x: x[j], opt.mu),
                     tree_map(lambda x: x[j], opt.nu))


def _stack_opt(opts):
    return type(opts[0])(torch.stack([o.step for o in opts]),
                         tree_map(lambda *x: torch.stack(x), *[o.mu for o in opts]),
                         tree_map(lambda *x: torch.stack(x), *[o.nu for o in opts]))
