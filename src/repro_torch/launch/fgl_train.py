"""FGL training launcher of the PyTorch/CUDA port.

  PYTHONPATH=src python -m repro_torch.launch.fgl_train \\
      --dataset coauthor_cs --scale 1.0 --method SpreadFGL --clients 6 \\
      --servers 3 --rounds 3 -K 2 [--device cuda]

The same flags, defaults, validation and print lines as
``repro.launch.fgl_train``, with ``--impl`` replaced by ``--device
{cuda,cpu}`` (default ``cuda``: the run fails without a GPU rather than
falling back). Every method of the reference's registry runs.
``--gossip-every K > 1`` turns SpreadFGL into ``spreadfgl_gossip``;
``--async-buffer B > 0`` turns FedGL into ``spreadfgl_async`` on one server
and SpreadFGL into ``spreadfgl_async`` (delays from ``--delay-dist``,
dropouts at ``--dropout-rate``); ``--participation R`` lets ceil(R·M)
clients into each round's aggregation. ``--save-state`` writes the final
``FGLState`` to an ``.npz`` (with the reference's PRNG ``key`` leaf, so the
JAX package resumes it too); ``--resume`` continues one at its round. A
checkpoint the JAX package wrote resumes too: every leaf but its PRNG
``key`` is taken, and the port's generator starts from ``--seed``, so its
later imputation noise differs from the reference's. Each round's wall
time is printed after the round lines. ``--trace`` runs the rounds under the
port's span recorder (``repro_torch.trace``) and then prints, for each span
of the round (``fgl.round``, ``fgl.local``, ``fgl.impute`` and its parts,
``fgl.aggregate``, ``fgl.evaluate``, ``fgl.graph``, ``kernel.*``), its calls
and its host and device milliseconds a round, the links proposed and wired
per imputation round (``fgl.links_proposed``, ``fgl.links_wired``), and how
often the classifier's graph inputs were built and reused
(``fgl.graph_built``, ``fgl.graph_reused``).

``--edge-mesh`` places the [N] server axis on a mesh of ranks
(``launch.mesh.make_edge_mesh``) and ``--sim-shard`` rotates the
imputation's candidate axis around one (``core/ring_topk.py``), one mesh for
both roles when both are given, as in the reference. Alone the process has
no process group and the meshes have size 1; under ``torchrun`` (env
rendezvous) they span the ranks of the world (``nccl`` when each rank has a
card of its own, ``gloo`` otherwise):

  torchrun --nproc-per-node 3 -m repro_torch.launch.fgl_train \\
      --dataset coauthor_cs --scale 1.0 --clients 6 --servers 3 --edge-mesh --sim-shard

``launch.edge_mesh --devices N`` starts the ranks itself. Only rank 0
prints and writes files.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from repro_torch import trace
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import registry
from repro_torch.core.fedgl import FGLState, resolve_device
from repro_torch.core.partition import (PARTITIONERS, count_missing_links,
                                        label_skew_entropy, make_partitioner,
                                        partition_graph)
from repro_torch.core.types import ClientBatch, FGLConfig, Graph
from repro_torch.data.synthetic_graphs import DATASETS, make_sbm_graph
from repro_torch.launch import mesh as mesh_lib

SERVER_METHODS = ("SpreadFGL", "spreadfgl_gossip", "spreadfgl_async")
IMPUTING_METHODS = ("FedGL",) + SERVER_METHODS


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=tuple(DATASETS), default="cora")
    ap.add_argument("--method", default="SpreadFGL", choices=registry.names())
    ap.add_argument("--clients", type=int, default=6)
    ap.add_argument("--servers", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--local-rounds", type=int, default=4)
    ap.add_argument("--imputation-interval", "-K", type=int, default=2)
    ap.add_argument("--top-k", type=int, default=4)
    ap.add_argument("--partitioner", default="label_prop",
                    choices=tuple(sorted(PARTITIONERS)),
                    help="client-split strategy (heterogeneity axis)")
    ap.add_argument("--alpha", type=float, default=1.0,
                    help="Dirichlet concentration for --partitioner dirichlet")
    ap.add_argument("--participation", type=float, default=1.0,
                    help="fraction of clients participating in each round's "
                         "aggregation (rho in (0,1]; 1.0 = everyone)")
    ap.add_argument("--label-ratio", type=float, default=0.3)
    ap.add_argument("--scale", type=float, default=0.15)
    ap.add_argument("--feature-noise", type=float, default=3.0)
    ap.add_argument("--signal-ratio", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the trainer runs: cuda launches the CUDA "
                         "kernels, cpu runs their plain PyTorch versions")
    ap.add_argument("--gossip-every", type=int, default=1,
                    help="cross-server exchange interval K for "
                         "spreadfgl_gossip (selecting a K > 1 forces that method)")
    ap.add_argument("--async-buffer", type=int, default=0,
                    help="FedBuff-style buffered aggregation: flush when B "
                         "client updates are buffered (0 = synchronous; "
                         "selecting B forces the spreadfgl_async method)")
    ap.add_argument("--delay-dist", default="zero",
                    choices=("zero", "uniform", "geometric"),
                    help="client arrival-delay distribution for --async-buffer")
    ap.add_argument("--dropout-rate", type=float, default=0.0,
                    help="per-round probability a client update is lost "
                         "mid-round (--async-buffer only; in [0, 1))")
    ap.add_argument("--json-out", default="")
    ap.add_argument("--save-state", default="",
                    help="write the final FGLState to this .npz")
    ap.add_argument("--resume", default="",
                    help="restore an FGLState .npz and continue at its round")
    ap.add_argument("--edge-mesh", action="store_true",
                    help="shard the stacked [N] edge-server axis over the ranks "
                         "(launch/mesh.py)")
    ap.add_argument("--sim-shard", action="store_true",
                    help="ring-rotate the imputation candidate axis around the "
                         "ranks (core/ring_topk.py)")
    ap.add_argument("--trace", action="store_true",
                    help="record the rounds' spans and link counters "
                         "(repro_torch.trace) and print them after the rounds")
    return ap


def _resolve_method(ap: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    """The reference's validation, and its mapping of flags to methods."""
    if not 0.0 < args.participation <= 1.0:
        ap.error("--participation must be in (0, 1]")
    if args.gossip_every < 1:
        ap.error("--gossip-every must be >= 1 (1 == exchange every round)")
    if args.gossip_every > 1:
        if args.method == "SpreadFGL":
            args.method = "spreadfgl_gossip"
        elif args.method != "spreadfgl_gossip":
            ap.error(f"--gossip-every applies to SpreadFGL/spreadfgl_gossip, "
                     f"not --method {args.method}")
    if args.async_buffer < 0:
        ap.error("--async-buffer must be >= 0 (0 == synchronous)")
    if args.async_buffer > args.clients:
        ap.error(f"--async-buffer {args.async_buffer} can never fill with "
                 f"only {args.clients} clients (one buffer slot per client)")
    if not 0.0 <= args.dropout_rate < 1.0:
        ap.error("--dropout-rate must be in [0, 1)")
    if args.async_buffer > 0:
        if args.method == "FedGL":
            args.method, args.servers = "spreadfgl_async", 1
        elif args.method == "SpreadFGL":
            args.method = "spreadfgl_async"
        elif args.method != "spreadfgl_async":
            ap.error(f"--async-buffer applies to FedGL/SpreadFGL/"
                     f"spreadfgl_async, not --method {args.method}")
    elif args.method == "spreadfgl_async":
        ap.error("--method spreadfgl_async needs --async-buffer >= 1")
    if args.sim_shard and args.method not in IMPUTING_METHODS:
        ap.error(f"--sim-shard needs an imputation round to shard; "
                 f"--method {args.method} has none")


def resume_state(path: str, template: FGLState) -> FGLState:
    """The ``FGLState`` in the ``.npz`` at ``path``, on ``template``'s device.

    A checkpoint of this package restores whole, its generator included. One
    the JAX package wrote holds a PRNG ``key`` instead of a generator: every
    other leaf is taken, and the generator stays ``template``'s.
    """
    with np.load(path, allow_pickle=False) as data:
        own = "gen" in data.files
    fields = {f.name: getattr(template, f.name) for f in dataclasses.fields(template)}
    if not own:
        fields.pop("gen")
    return dataclasses.replace(template, **ckpt_io.restore(path, fields))


def build_data(args: argparse.Namespace) -> Tuple[ClientBatch, Graph, np.ndarray]:
    """The synthetic graph of the flags, and its partition into clients:
    ``(batch, graph, assign)``."""
    graph = make_sbm_graph(DATASETS[args.dataset], scale=args.scale,
                           seed=args.seed + 1, feature_noise=args.feature_noise,
                           signal_ratio=args.signal_ratio)
    part = make_partitioner(args.partitioner, alpha=args.alpha)
    batch, assign = partition_graph(graph, args.clients, aug_max=12,
                                    seed=args.seed, label_ratio=args.label_ratio,
                                    partitioner=part)
    return batch, graph, assign


def config(args: argparse.Namespace) -> FGLConfig:
    """The ``FGLConfig`` the launcher trains with, from the flags."""
    return FGLConfig(hidden_dim=32, local_rounds=args.local_rounds,
                     imputation_interval=args.imputation_interval,
                     top_k_links=args.top_k, aug_max=12,
                     label_ratio=args.label_ratio,
                     gossip_every=args.gossip_every,
                     async_buffer=args.async_buffer,
                     delay_dist=args.delay_dist,
                     dropout_rate=args.dropout_rate,
                     participation=args.participation, seed=args.seed)


def parse(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The flags, validated, with the method they select."""
    ap = _parser()
    args = ap.parse_args(argv)
    _resolve_method(ap, args)
    return args


def main(argv: Optional[Sequence[str]] = None, *,
         data: Optional[Tuple[ClientBatch, Graph, np.ndarray]] = None) -> Dict[str, list]:
    """Train from the command line; returns the history it printed.
    ``data`` is :func:`build_data`'s result for these flags, when the caller
    already built it."""
    args = parse(argv)
    resolve_device(args.device)   # fail before building data, not after
    joined = mesh_lib.init_from_env(args.device)
    try:
        return _run(args, data)
    finally:
        if joined:
            dist.destroy_process_group()


def _run(args: argparse.Namespace,
         data: Optional[Tuple[ClientBatch, Graph, np.ndarray]]) -> Dict[str, list]:
    lead = not dist.is_initialized() or dist.get_rank() == 0
    say = _printer(lead)
    batch, graph, assign = data if data is not None else build_data(args)
    ent = label_skew_entropy(assign, graph.y, args.clients)
    say(f"[fgl] {args.dataset}: {graph.num_nodes} nodes, "
        f"{count_missing_links(graph, assign)} missing cross-client links")
    say(f"[fgl] partitioner={args.partitioner} "
        f"mean client label entropy={ent.mean():.3f} nats")
    if args.participation < 1.0:
        n_part = max(1, math.ceil(args.participation * args.clients))
        say(f"[fgl] partial participation: rho={args.participation} "
            f"({n_part} of {args.clients} clients aggregate per round)")
    cfg = config(args)
    kw = {"device": args.device}
    if args.method in SERVER_METHODS:
        kw["num_servers"] = args.servers
        if args.edge_mesh:
            kw["edge_mesh"] = mesh_lib.make_edge_mesh(args.servers)
            say(f"[fgl] edge mesh: {kw['edge_mesh'].size} device(s) for "
                f"N={args.servers} ({mesh_lib.describe(kw['edge_mesh'])})")
    if args.sim_shard:
        # One mesh, two roles: the [N] server axis is split over it, and the
        # candidate axis rotates around it as a ring.
        kw["sim_mesh"] = kw["edge_mesh"] if "edge_mesh" in kw else mesh_lib.make_sim_mesh()
        say(f"[fgl] sim shard: candidate axis over {kw['sim_mesh'].size} device(s)")
    if args.method == "spreadfgl_gossip":
        say(f"[fgl] gossip aggregation: cross-server exchange every "
            f"{args.gossip_every} round(s)")
    if args.method == "spreadfgl_async":
        say(f"[fgl] async aggregation: buffer B={args.async_buffer} of "
            f"M={args.clients}, delays={args.delay_dist}, "
            f"dropout={args.dropout_rate}")
    tr = registry.build(args.method, cfg, batch, **kw)
    if args.resume:
        state = resume_state(args.resume, tr.init(batch))
        say(f"[fgl] resumed {args.resume} at round {state.round}")
    with trace.recording() if args.trace else contextlib.nullcontext():
        if args.resume:
            state, hist = tr.fit(state=state, rounds=args.rounds)
        else:
            state, hist = tr.fit(batch, rounds=args.rounds)
    for i, r in enumerate(hist["round"]):
        say(f"[fgl] round {r:3d} loss={hist['loss'][i]:8.4f} "
            f"acc={hist['acc'][i]:.3f} f1={hist['f1'][i]:.3f}")
    say(f"[fgl] best acc={max(hist['acc']):.3f} f1={max(hist['f1']):.3f}")
    say("[fgl] round seconds: "
        + " ".join(f"{s:.3f}" for s in hist["seconds"]) + f" ({args.device})")
    if args.trace:
        for line in trace_lines(trace.drain(), len(hist["round"])):
            say(line)
    if args.save_state and lead:
        ckpt_io.save(args.save_state, state)
        say(f"[fgl] saved FGLState (round {state.round}) to {args.save_state}")
    if args.json_out and lead:
        with open(args.json_out, "w") as f:
            json.dump(hist, f)
    return hist


def trace_lines(rec: trace.Recording, rounds: int) -> list:
    """One line per span name, in the order the names first began (calls,
    host and device ms a round), the link counters per imputation round,
    and the classifier graph's builds and reuses."""
    by_name: Dict[str, list] = {}
    for s in rec.spans:
        by_name.setdefault(s.name, []).append(s)
    lines = []
    for name, spans in by_name.items():
        host = sum(s.host_ms for s in spans) / rounds
        dev = ("n/a" if any(s.device_ms is None for s in spans)
               else f"{sum(s.device_ms for s in spans) / rounds:.3f}")
        lines.append(f"[fgl] span {name}: {len(spans)} calls, host {host:.3f} ms a round, "
                     f"device {dev} ms a round")
    imputing = len(by_name.get("fgl.impute", []))
    links = {k: sum(v.values()) for k, v in rec.counters.items()}
    if imputing and "fgl.links_wired" in links:
        lines.append(f"[fgl] links per imputation round ({imputing}): proposed "
                     f"{links['fgl.links_proposed'] / imputing:.1f}, wired "
                     f"{links['fgl.links_wired'] / imputing:.1f}")
    built, reused = links.get("fgl.graph_built", 0), links.get("fgl.graph_reused", 0)
    if built:
        lines.append(f"[fgl] classifier graph: built {built:.0f}, reused {reused:.0f} "
                     f"({100 * reused / (built + reused):.1f} % of forwards)")
    return lines


def _printer(lead: bool):
    """``print`` on rank 0 (or without a process group), silence elsewhere."""
    return print if lead else (lambda *a, **k: None)


if __name__ == "__main__":
    main()
