"""FGL training launcher of the PyTorch/CUDA port.

  PYTHONPATH=src python -m repro_torch.launch.fgl_train \\
      --dataset coauthor_cs --scale 1.0 --method SpreadFGL --clients 6 \\
      --servers 3 --rounds 3 -K 2 [--device cuda]

The same flags, defaults and print lines as ``repro.launch.fgl_train``, with
``--impl`` replaced by ``--device {cuda,cpu}`` (default ``cuda``: the run
fails without a GPU rather than falling back). Flags for what the port does
not cover yet (partial participation, gossip, async, checkpoints, the edge
mesh and the sharded similarity search, and the methods ``fedsage_plus``,
``spreadfgl_gossip``, ``spreadfgl_async``) are accepted and raise
``NotImplementedError`` when set. Each round's wall time is printed after the
round lines.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

from repro_torch.core import registry
from repro_torch.core.fedgl import resolve_device
from repro_torch.core.partition import (PARTITIONERS, count_missing_links,
                                        label_skew_entropy, make_partitioner,
                                        partition_graph)
from repro_torch.core.types import FGLConfig
from repro_torch.data.synthetic_graphs import DATASETS, make_sbm_graph

# Every method name of the reference launcher; the unported ones raise.
METHODS = ("FedGL", "SpreadFGL", "fedavg_fusion", "fedsage_plus", "local",
           "spreadfgl_async", "spreadfgl_gossip")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=tuple(DATASETS), default="cora")
    ap.add_argument("--method", default="SpreadFGL", choices=METHODS)
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
                    help="fraction of clients per round (only 1.0 is ported)")
    ap.add_argument("--label-ratio", type=float, default=0.3)
    ap.add_argument("--scale", type=float, default=0.15)
    ap.add_argument("--feature-noise", type=float, default=3.0)
    ap.add_argument("--signal-ratio", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the trainer runs: cuda launches the CUDA "
                         "kernels, cpu runs their plain PyTorch versions")
    ap.add_argument("--gossip-every", type=int, default=1,
                    help="gossip exchange interval (not ported yet)")
    ap.add_argument("--async-buffer", type=int, default=0,
                    help="FedBuff-style buffer size (not ported yet)")
    ap.add_argument("--delay-dist", default="zero",
                    choices=("zero", "uniform", "geometric"),
                    help="async arrival-delay distribution (not ported yet)")
    ap.add_argument("--dropout-rate", type=float, default=0.0,
                    help="async mid-round dropout rate (not ported yet)")
    ap.add_argument("--json-out", default="")
    ap.add_argument("--save-state", default="", help="not ported yet")
    ap.add_argument("--resume", default="", help="not ported yet")
    ap.add_argument("--edge-mesh", action="store_true", help="not ported yet")
    ap.add_argument("--sim-shard", action="store_true", help="not ported yet")
    return ap


def _reject_unported(args: argparse.Namespace) -> None:
    unported = {
        "--participation": args.participation != 1.0,
        "--gossip-every": args.gossip_every != 1,
        "--async-buffer": args.async_buffer != 0,
        "--delay-dist": args.delay_dist != "zero",
        "--dropout-rate": args.dropout_rate != 0.0,
        "--save-state": bool(args.save_state),
        "--resume": bool(args.resume),
        "--edge-mesh": args.edge_mesh,
        "--sim-shard": args.sim_shard,
        f"--method {args.method}": args.method not in registry.names(),
    }
    hit = [flag for flag, is_set in unported.items() if is_set]
    if hit:
        raise NotImplementedError(f"not ported to repro_torch yet: {', '.join(hit)}")


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, list]:
    """Train from the command line; returns the history it printed."""
    args = _parser().parse_args(argv)
    _reject_unported(args)
    resolve_device(args.device)   # fail before building data, not after

    graph = make_sbm_graph(DATASETS[args.dataset], scale=args.scale,
                           seed=args.seed + 1, feature_noise=args.feature_noise,
                           signal_ratio=args.signal_ratio)
    part = make_partitioner(args.partitioner, alpha=args.alpha)
    batch, assign = partition_graph(graph, args.clients, aug_max=12,
                                    seed=args.seed, label_ratio=args.label_ratio,
                                    partitioner=part)
    ent = label_skew_entropy(assign, graph.y, args.clients)
    print(f"[fgl] {args.dataset}: {graph.num_nodes} nodes, "
          f"{count_missing_links(graph, assign)} missing cross-client links")
    print(f"[fgl] partitioner={args.partitioner} "
          f"mean client label entropy={ent.mean():.3f} nats")
    cfg = FGLConfig(hidden_dim=32, local_rounds=args.local_rounds,
                    imputation_interval=args.imputation_interval,
                    top_k_links=args.top_k, aug_max=12,
                    label_ratio=args.label_ratio, seed=args.seed)
    kw = {"device": args.device}
    if args.method == "SpreadFGL":
        kw["num_servers"] = args.servers
    tr = registry.build(args.method, cfg, batch, **kw)
    state, hist = tr.fit(batch, rounds=args.rounds)
    for i, r in enumerate(hist["round"]):
        print(f"[fgl] round {r:3d} loss={hist['loss'][i]:8.4f} "
              f"acc={hist['acc'][i]:.3f} f1={hist['f1'][i]:.3f}")
    print(f"[fgl] best acc={max(hist['acc']):.3f} f1={max(hist['f1']):.3f}")
    print("[fgl] round seconds: "
          + " ".join(f"{s:.3f}" for s in hist["seconds"]) + f" ({args.device})")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(hist, f)
    return hist


if __name__ == "__main__":
    main()
