"""FGL training engine (Algorithm 1) with an explicit state lifecycle.

Counterpart of ``repro.core.fedgl``. One engine covers every method; the
variation axes are injected strategies (:mod:`repro_torch.core.strategies`).
``FedGL`` is star + FedAvg + the SpreadFGL generator; ``SpreadFGL`` is ring +
Eq. 16 + the generator (:mod:`repro_torch.core.registry`).

Lifecycle::

    state = trainer.init(batch)             # fresh FGLState at round 0
    state, metrics = trainer.step(state)    # ONE global round of Algorithm 1
    state, history = trainer.fit(batch, rounds=30)   # thin step() loop
    state, history = trainer.fit(state=restored, rounds=10)  # true resume

``fit(state=...)`` continues at ``state.round``: the imputation, gossip,
participation and async schedules are all functions of the absolute round,
so a state saved with :mod:`repro_torch.checkpoint.io` continues exactly.

Layout: client classifiers are stacked on a leading [M] axis, clients grouped
contiguously per server; per-server generator state is stacked on a leading
[N] axis. Where the reference vmaps, the port runs one batched pass: the
local step over all M clients, and the imputation round over all N servers
(one ``sim_topk`` launch per round for all of them). Where it scans, the
port loops in Python. With ``edge_mesh`` (a ``launch.mesh.Mesh``, one
process per device) each rank runs the generator round for its ``N / size``
servers and all-gathers the outputs, so every rank continues with the whole
state, the result the reference's placement of the [N] axis on its mesh
gives; the rest of the round runs whole on every rank, and the round's
noise S is drawn for all N servers from the one generator on every rank,
which keeps the ranks in step.

Randomness comes from a ``torch.Generator`` seeded from ``cfg.seed``; it
draws the initial weights and then lives in the state, where each
imputation round draws its noise S from it. The participation masks
and async schedules draw from CPU generators of their own, seeded from
``(cfg.seed, salt, round)``, so they never touch the training stream and do
not depend on the device.

The trainer runs on ``device`` ("cuda" by default; it raises when CUDA is
missing, unless the caller passes ``device="cpu"``, where the kernels' plain
PyTorch versions run). Everything is float32: TF32 is switched off.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import assessor as assessor_lib
from repro_torch.core import gnn, imputation, strategies
from repro_torch.core.types import ClientBatch, FGLConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim.adam import Adam, AdamState
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PyTree = Any


@dataclasses.dataclass
class FGLState:
    """The full Algorithm 1 state threaded through ``step()``."""

    params: PyTree        # [M, ...] stacked client classifiers
    opt_state: AdamState
    ae_params: PyTree     # [N, ...] stacked per-server autoencoders
    ae_opt: AdamState     # [N, ...] stacked optimizer state
    as_params: PyTree     # [N, ...] stacked per-server assessors
    as_opt: AdamState
    batch: ClientBatch
    gen: torch.Generator  # draws each imputation round's noise S
    round: int = 0

    def reference_leaves(self) -> Dict[str, np.ndarray]:
        """Leaves a checkpoint holds for the JAX package beside the state's
        own: ``key``, the reference's PRNG key as ``jax.random.key_data`` of a
        threefry key (uint32 [2]), the round in its high word and the
        generator's seed in its low one; at round 0 that is
        ``jax.random.key(seed)``'s. The reference's ``checkpoint.io.restore``
        then takes the file, and its run goes on under its own randomness."""
        return {"key": np.array([int(self.round) & 0xFFFFFFFF,
                                 self.gen.initial_seed() & 0xFFFFFFFF], dtype=np.uint32)}


def _cross_entropy(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Eq. (7): masked CE per client; logits [.., n, c], y [.., n] (-1 unlabeled)."""
    logp = torch.log_softmax(logits, dim=-1)
    safe_y = torch.clamp_min(y, 0).long()
    picked = torch.gather(logp, -1, safe_y[..., None])[..., 0]
    mask = mask * (y >= 0)
    return -torch.sum(picked * mask, dim=-1) / torch.clamp_min(torch.sum(mask, dim=-1), 1.0)


def _trace_reg(params: PyTree) -> torch.Tensor:
    """Eq. (15): Tr(W_L W_Lᵀ) = ||W_L||_F² of the last layer, per client [M]."""
    last = params["layers"][-1]
    return sum(torch.sum(torch.square(w), dim=(-2, -1))
               for k, w in last.items() if k != "b")


def _map_nodes(fn: Callable, tree):
    """``tree_map`` that also walks the named tuples of optimizer state."""
    if isinstance(tree, AdamState):
        return AdamState(*(_map_nodes(fn, x) for x in tree))
    if isinstance(tree, dict):
        return {k: _map_nodes(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_nodes(fn, v) for v in tree)
    return fn(tree)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; CUDA must really be there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; the port runs on the GPU "
                           "unless device='cpu' is passed explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _grad(loss_fn: Callable[[PyTree], torch.Tensor], params: PyTree) -> PyTree:
    """Gradient tree of the scalar ``loss_fn(params)``."""
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        grads = torch.autograd.grad(loss_fn(tree_unflatten(params, leaves)), leaves)
    return tree_unflatten(params, list(grads))


class FGLTrainer:
    """Drives Algorithm 1 for a fixed client batch, one strategy per axis."""

    def __init__(self, cfg: FGLConfig, batch: ClientBatch,
                 *, topology: Optional[strategies.Topology] = None,
                 aggregator: Optional[strategies.Aggregator] = None,
                 imputation: Optional[strategies.ImputationStrategy] = None,
                 participation: Optional[float] = None,
                 use_negative_sampling: bool = True, use_assessor: bool = True,
                 edge_mesh=None, device="cuda"):
        if participation is not None:     # the constructor override wins
            cfg = dataclasses.replace(cfg, participation=float(participation))
        if not 0.0 < cfg.participation <= 1.0:
            raise ValueError(f"participation must be in (0, 1], got {cfg.participation}")
        if cfg.gnn_kind not in gnn.KINDS:
            raise ValueError(f"unknown gnn_kind {cfg.gnn_kind!r}; "
                             f"expected one of {tuple(gnn.KINDS)}")
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.m = batch.num_clients
        self.topology = topology if topology is not None else strategies.StarTopology()
        layout = self.topology.build(self.m)
        self.n_servers = layout.num_servers
        self.m_per = layout.clients_per_server
        expected = np.repeat(np.arange(self.n_servers), self.m_per)
        if not np.array_equal(np.asarray(layout.server_of_client), expected):
            raise ValueError("clients must be grouped contiguously per server")
        self.cfg = cfg = dataclasses.replace(
            cfg, num_edge_servers=self.n_servers, clients_per_server=self.m_per)
        self.is_spread = self.n_servers > 1
        self.aggregator = aggregator if aggregator is not None else (
            strategies.NeighborAggregator() if self.is_spread
            else strategies.FedAvgAggregator())
        self.imputation = (imputation if imputation is not None
                           else strategies.SpreadImputation())
        self.num_classes = batch.num_classes
        self.adj_servers = torch.as_tensor(layout.adjacency, dtype=torch.float32,
                                           device=self.device)
        self.feature_dim = batch.x.shape[-1]
        self.n_local = batch.n_local_max
        self.use_ns = use_negative_sampling
        self.use_assessor = use_assessor
        self.participation = float(cfg.participation)
        # Round-scheduled aggregators (gossip) expose a `period`; the others
        # have period 1.
        self._agg_period = max(1, int(getattr(self.aggregator, "period", 1)))
        self.opt = Adam(lr=cfg.lr_classifier)
        self.gen_opt = Adam(lr=cfg.lr_generator)
        self.edge_mesh = edge_mesh
        self._prepared: Optional[Tuple[tuple, gnn.Graph]] = None   # see _graph
        if edge_mesh is not None and self.n_servers % edge_mesh.size:
            raise ValueError(f"N={self.n_servers} servers must divide across the "
                             f"{edge_mesh.size}-device edge mesh")

    # -- initialization ------------------------------------------------------

    def init(self, batch: ClientBatch) -> FGLState:
        """Algorithm 1 lines 1-5: a fresh ``FGLState`` at round 0."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device)
        gen.manual_seed(cfg.seed)
        dims = [self.feature_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1) + [self.num_classes]
        # Algorithm 1 line 3: all clients start from the server weights W_j.
        base = gnn.init_classifier(gen, cfg.gnn_kind, dims)
        params = tree_map(lambda p: p.expand((self.m,) + p.shape).clone(), base)
        n = self.n_servers
        ae_params = imputation.init_autoencoder(gen, self.num_classes, self.feature_dim,
                                                cfg.ae_hidden, lead=(n,))
        as_params = assessor_lib.init_assessor(gen, self.num_classes,
                                               cfg.assessor_hidden, lead=(n,))
        return FGLState(params=params, opt_state=self.opt.init(params),
                        ae_params=ae_params, ae_opt=self.gen_opt.init(ae_params, lead=(n,)),
                        as_params=as_params, as_opt=self.gen_opt.init(as_params, lead=(n,)),
                        batch=batch.to(self.device), gen=gen)

    # -- the edge mesh ----------------------------------------------------------

    def _place_edge(self, state: FGLState) -> FGLState:
        """The stacked [N] generator state on this rank's device. Every rank
        holds it whole: each computes its block of servers and gathers the
        rest (:meth:`on_edge`)."""
        if self.edge_mesh is None:
            return state
        moved = _map_nodes(lambda x: x.to(self.device),
                           (state.ae_params, state.ae_opt, state.as_params, state.as_opt))
        return dataclasses.replace(state, ae_params=moved[0], ae_opt=moved[1],
                                   as_params=moved[2], as_opt=moved[3])

    def on_edge(self, fn: Callable, stacked: tuple, *shared):
        """``fn(*stacked, *shared)`` with the leading [N] server axis of every
        tensor in ``stacked`` split over the edge mesh: this rank runs its
        ``N / size`` servers, and every tensor of the result is gathered
        along that axis, so every rank holds the whole result. Without a
        mesh (or on a size-1 one) it is the plain call."""
        mesh = self.edge_mesh
        if mesh is None or mesh.size == 1:
            return fn(*stacked, *shared)
        nb = self.n_servers // mesh.size
        lo = mesh.rank * nb
        out = fn(*_map_nodes(lambda x: x[lo:lo + nb], stacked), *shared)
        leaves: list = []
        _map_nodes(leaves.append, out)
        with trace.span("fgl.impute.gather"):
            gathered = iter(mesh_lib.all_gather_tree(mesh, leaves))
        return _map_nodes(lambda _: next(gathered), out)

    # -- local training (Algorithm 1 lines 8-9) ------------------------------

    def _client_losses(self, params_m: PyTree, logits: torch.Tensor,
                       batch: ClientBatch) -> torch.Tensor:
        """[M] per-client losses from the clients' logits."""
        losses = _cross_entropy(logits, batch.y, batch.train_mask)
        if self.is_spread and self.cfg.trace_reg > 0:
            losses = losses + self.cfg.trace_reg * _trace_reg(params_m)
        return losses

    def _graph(self, batch: ClientBatch) -> gnn.Graph:
        """The classifier's prepared inputs for ``batch`` (``gnn.prepare``):
        built on the first forward of each batch and reused until the batch
        is replaced. A batch is never modified in place (``fix_graphs`` and
        ``_local_generation`` build new tensors), so the identity of its x,
        adj and node_mask names it; the cache holds those tensors, so their
        ids cannot be reused while it lives."""
        key = (batch.x, batch.adj, batch.node_mask)
        if self._prepared is not None and all(
                a is b for a, b in zip(self._prepared[0], key)):
            trace.count("fgl.graph_reused", 1)
            return self._prepared[1]
        self._prepared = None           # free the old graph before building anew
        with trace.span("fgl.graph"), torch.no_grad():
            graph = gnn.prepare(self.cfg.gnn_kind, *key)
        self._prepared = (key, graph)
        trace.count("fgl.graph_built", 1)
        return graph

    def _release_graph(self) -> None:
        """Drop the prepared graph before imputation replaces the batch, so
        that none is alive while the generator and the patcher allocate."""
        self._prepared = None

    def _logits(self, params_m: PyTree, batch: ClientBatch) -> torch.Tensor:
        return gnn.forward(params_m, self.cfg.gnn_kind, self._graph(batch))

    def _client_loss(self, params_m: PyTree, batch: ClientBatch) -> torch.Tensor:
        logits = self._logits(params_m, batch)
        # A sum over clients keeps each client's gradients its own.
        return torch.sum(self._client_losses(params_m, logits, batch))

    def _local_rounds(self, params, opt_state, batch: ClientBatch):
        with trace.span("fgl.local"):
            for _ in range(self.cfg.local_rounds):
                grads = _grad(lambda p: self._client_loss(p, batch), params)
                params, opt_state = self.opt.update(grads, opt_state, params)
        return params, opt_state

    # -- aggregation (strategy) ----------------------------------------------

    def _agg_phase(self, t: int) -> int:
        """The aggregator's phase of round ``t``: ``period - 1`` on exchange
        rounds and 0 otherwise, or a buffered aggregator's own 0/1 flush
        flag (``phase(t, m)``)."""
        hook = getattr(self.aggregator, "phase", None)
        if hook is not None:
            return int(hook(t, self.m))
        p = self._agg_period
        return p - 1 if (t + 1) % p == 0 else 0

    def _participation_mask(self, t: int) -> Optional[torch.Tensor]:
        """[M] 0/1 participation mask of round ``t`` on the device, or None
        at rho = 1 (the aggregators' exact unmasked path). Drawn on the CPU
        from ``(cfg.seed, PARTICIPATION_SALT, t)``."""
        if self.participation >= 1.0:
            return None
        gen = strategies.keyed_generator(self.cfg.seed, strategies.PARTICIPATION_SALT, t)
        return strategies.participation_mask(gen, self.m, self.participation).to(self.device)

    def _agg_mask(self, t: int, participation: Optional[torch.Tensor] = None
                  ) -> Optional[torch.Tensor]:
        """The [M] weights of round ``t``'s aggregation, or None: the
        participation mask (``participation``, or the round's own draw)
        times a buffered aggregator's staleness weights on flush rounds."""
        mask = participation if participation is not None else self._participation_mask(t)
        hook = getattr(self.aggregator, "round_weights", None)
        weights = hook(t, self.m) if hook is not None else None
        if weights is None:
            return mask
        weights = weights.to(self.device)
        return weights if mask is None else weights * mask

    def aggregate(self, params: PyTree, *, round: int = 0,
                  mask: Optional[torch.Tensor] = None) -> PyTree:
        """Apply this trainer's Aggregator to stacked client classifiers.

        ``round`` is the absolute round (reduced to the aggregator's phase);
        ``mask`` is the [M] aggregation weights, round ``round``'s own
        (:meth:`_agg_mask`) when None.
        """
        t = int(round)
        with trace.span("fgl.aggregate"):
            if mask is None:
                mask = self._agg_mask(t)
            return self.aggregator.aggregate(params, adj=self.adj_servers,
                                             num_servers=self.n_servers, m_per=self.m_per,
                                             round=self._agg_phase(t), mask=mask)

    # -- imputation helpers shared by the strategies --------------------------

    def _embeddings(self, params, batch: ClientBatch) -> torch.Tensor:
        """Softmax embeddings for imputation: the batch's last forward
        before the imputation replaces it, so it releases the graph."""
        emb = torch.softmax(self._logits(params, batch), dim=-1)
        self._release_graph()
        return emb

    def _train_generator(self, ae, ae_opt, asr, as_opt, h_real, flat_mask, s_noise):
        """Alternating AE / assessor training (Algorithm 1 lines 16-23).

        S is fixed for the whole round, so row v of S stays bound to node v.
        All arguments may carry the leading [N] server axis; the per-server
        losses are summed so each server's gradients stay its own.
        """
        cfg = self.cfg
        theta = cfg.theta(self.num_classes)
        e = (assessor_lib.negative_mask(h_real, theta) if self.use_ns
             else torch.ones_like(h_real))

        def ae_loss(p, asr_frozen):
            if self.use_assessor:
                return torch.sum(assessor_lib.autoencoder_loss(
                    p, asr_frozen, s_noise, h_real, e, flat_mask))
            # w/o assessor: plain masked reconstruction of H (Fig. 7 ablation).
            _, h_fake = imputation.reconstruct(p, s_noise)
            diff = h_real - h_fake
            return torch.sum(torch.sum(torch.sum(diff * diff, -1) * flat_mask, -1)
                             / torch.clamp_min(torch.sum(flat_mask, -1), 1.0))

        def as_loss(p, h_fake):
            if self.use_ns:
                return torch.sum(assessor_lib.assessor_loss(p, h_real, h_fake, e, flat_mask))
            return torch.sum(assessor_lib.assessor_loss_plain(p, h_real, h_fake, flat_mask))

        # Every outer iteration trains the AE against the assessor as it
        # stood when the round began, and the assessor against the
        # reconstruction of the AE after the first iteration's AE steps.
        # That is what the reference computes: its two scan bodies close
        # over the other network, and lax.scan re-uses each body as traced
        # in the first outer iteration (ROADMAP, queue 3).
        asr_frozen, h_fake = asr, None
        with trace.span("fgl.impute.generator"):
            for _ in range(cfg.ae_outer_iters):
                for _ in range(cfg.ae_iters):
                    grads = _grad(lambda p: ae_loss(p, asr_frozen), ae)
                    ae, ae_opt = self.gen_opt.update(grads, ae_opt, ae)
                if self.use_assessor:
                    if h_fake is None:
                        _, h_fake = imputation.reconstruct(ae, s_noise)
                    for _ in range(cfg.assessor_iters):
                        grads = _grad(lambda p: as_loss(p, h_fake), asr)
                        asr, as_opt = self.gen_opt.update(grads, as_opt, asr)
        return ae, ae_opt, asr, as_opt

    def _server_round_gen(self, ae, aeo, asr, aso, emb_j, mask_j, s_noise):
        """The generator half of the servers' imputation round: fusion,
        adversarial AE/assessor training and X̅ = f(S), on [.., M_per, n_pad, c]
        slices. Returns the trained state, X̅ and the fused (h_flat,
        flat_mask) the similarity search runs on."""
        h_flat, flat_mask = imputation.fuse_embeddings(emb_j, mask_j)
        ae, aeo, asr, aso = self._train_generator(ae, aeo, asr, aso, h_flat,
                                                  flat_mask, s_noise)
        with trace.span("fgl.impute.encode"):
            x_bar = imputation.encode(ae, s_noise)          # X̅ = f(S), same S
        return ae, aeo, asr, aso, x_bar, h_flat, flat_mask

    def _server_round(self, ae, aeo, asr, aso, emb_j, mask_j, client_ids, s_noise):
        """The servers' whole imputation round: the generator half, then the
        similarity top-k (one kernel launch for every server on the leading
        axis)."""
        ae, aeo, asr, aso, x_bar, h_flat, flat_mask = self._server_round_gen(
            ae, aeo, asr, aso, emb_j, mask_j, s_noise)
        # Link targets must be REAL local nodes (aug slots are excluded).
        target_mask = flat_mask * imputation.local_slot_mask(
            self.m_per, emb_j.shape[-2], self.n_local, device=flat_mask.device)
        with trace.span("fgl.impute.topk"):
            scores, idx = imputation.similarity_topk(h_flat, flat_mask, client_ids,
                                                     self.cfg.top_k_links,
                                                     target_mask=target_mask)
        return ae, aeo, asr, aso, scores, idx, x_bar

    # -- evaluation ------------------------------------------------------------

    def _evaluate(self, params, batch: ClientBatch):
        """(mean client loss, accuracy, macro-F1) from one forward pass."""
        logits = self._logits(params, batch)
        y = batch.y
        pred = torch.argmax(logits, dim=-1)
        mask = batch.test_mask * (y >= 0)
        correct = torch.sum((pred == y) * mask)
        c = self.num_classes
        onehot_p = torch.nn.functional.one_hot(pred, c).float() * mask[..., None]
        onehot_y = (torch.nn.functional.one_hot(torch.clamp_min(y, 0).long(), c).float()
                    * mask[..., None])
        tp = torch.sum(onehot_p * onehot_y, dim=(0, 1))
        fp = torch.sum(onehot_p * (1 - onehot_y), dim=(0, 1))
        fn = torch.sum((1 - onehot_p) * onehot_y, dim=(0, 1))
        acc = correct / torch.clamp_min(torch.sum(mask), 1.0)
        precision = tp / torch.clamp_min(tp + fp, 1e-9)
        recall = tp / torch.clamp_min(tp + fn, 1e-9)
        f1 = 2 * precision * recall / torch.clamp_min(precision + recall, 1e-9)
        seen = (tp + fn) > 0
        macro_f1 = (torch.sum(torch.where(seen, f1, torch.zeros_like(f1)))
                    / torch.clamp_min(torch.sum(seen), 1.0))
        loss = torch.sum(self._client_losses(params, logits, batch)) / self.m
        return loss, acc, macro_f1

    # -- outer loop (Algorithm 1) ----------------------------------------------

    def step(self, state: FGLState, noise: Optional[torch.Tensor] = None,
             mask: Optional[torch.Tensor] = None) -> Tuple[FGLState, Dict[str, Any]]:
        """One global round of Algorithm 1 (lines 6-26).

        ``noise`` is this round's S ``[N, M_per*n_pad, c]`` if it is an
        imputation round (drawn from ``state.gen`` when None); ``mask`` is
        its [M] participation mask (drawn from ``(cfg.seed, round)`` when
        None and ``participation < 1``). Returns a new state at
        ``round + 1`` and metrics as tensors.
        """
        t = int(state.round)
        state = dataclasses.replace(state)   # never mutate the caller's state
        with trace.span("fgl.round", round=t), torch.no_grad():
            state.params, state.opt_state = self._local_rounds(
                state.params, state.opt_state, state.batch)
            if self.imputation.active and (t % self.cfg.imputation_interval == 0):
                state = self.imputation.impute(self, state, noise=noise)
            state.params = self.aggregate(state.params, round=t,
                                          mask=self._agg_mask(t, mask))
            with trace.span("fgl.evaluate"):
                loss, acc, f1 = self._evaluate(state.params, state.batch)
        state.round = t + 1
        return state, {"round": t, "loss": loss, "acc": acc, "f1": f1}

    def fit(self, batch: Optional[ClientBatch] = None, *,
            state: Optional[FGLState] = None, rounds: Optional[int] = None,
            noise: Optional[Callable[[int], torch.Tensor]] = None,
            mask: Optional[Callable[[int], torch.Tensor]] = None
            ) -> Tuple[FGLState, Dict[str, list]]:
        """Run ``rounds`` global rounds (default ``cfg.global_rounds``).

        Pass ``batch`` for a fresh run or ``state=`` to continue one.
        ``noise(round)``, when given, supplies S for each imputation round,
        and ``mask(round)`` each round's participation mask.
        The history also holds each round's wall time in seconds
        (``"seconds"``), taken after the device finished the round.
        """
        if state is None:
            if batch is None:
                raise ValueError("fit() needs batch for a fresh run or state= to resume")
            state = self.init(batch)
        elif batch is not None:
            raise ValueError("fit(state=...) resumes from the state's own batch")
        else:
            state = self._place_edge(state)
        rounds = rounds if rounds is not None else self.cfg.global_rounds
        metrics, seconds = [], []
        for _ in range(rounds):
            t0 = time.perf_counter()
            is_impute = (self.imputation.active
                         and state.round % self.cfg.imputation_interval == 0)
            s = noise(state.round) if (noise is not None and is_impute) else None
            part = mask(state.round) if mask is not None else None
            state, m = self.step(state, noise=s, mask=part)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            seconds.append(time.perf_counter() - t0)
            metrics.append(m)
        history: Dict[str, list] = {
            "round": [int(m["round"]) for m in metrics],
            "loss": [float(m["loss"]) for m in metrics],
            "acc": [float(m["acc"]) for m in metrics],
            "f1": [float(m["f1"]) for m in metrics],
            "seconds": seconds,
        }
        return state, history

