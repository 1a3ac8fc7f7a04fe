"""Edge-server mesh launcher of the PyTorch/CUDA port.

Counterpart of ``repro.launch.edge_mesh``: places SpreadFGL's stacked
``[N]`` edge-server axis on a mesh of ranks (``launch/mesh.py``, one process
per device), so each rank runs the imputation round's generator for its
``N / size`` servers and gathers the rest.

  # 4 ranks, 4 edge servers, one server per rank:
  PYTHONPATH=src python -m repro_torch.launch.edge_mesh --devices 4 --servers 4

  # Gossip training: neighbor exchange every 4 rounds only, over the mesh:
  PYTHONPATH=src python -m repro_torch.launch.edge_mesh --devices 4 --servers 4 \\
      --gossip-every 4

``--devices N`` starts N ranks itself (``mesh.spawn``: rank r on
``cuda:(r % card count)``, ``nccl`` when each has a card of its own,
``gloo`` otherwise, or ``gloo`` on the CPU with ``--device cpu``), the
counterpart of the reference's emulated host devices. Without it the world
is what ``torchrun`` describes in the environment, or this process alone (a
size-1 mesh: the same numbers, no sharding). ``--gossip-every 0`` (the
default) keeps dense per-round Eq. 16 neighbor aggregation; any K >= 1
switches to ``spreadfgl_gossip``. ``--sim-shard`` also rotates the
imputation round's candidate axis around the same mesh as a ring
(``core/ring_topk.py``). The graph is the reference's: the dataset at scale
0.15. Only rank 0 prints; its first line gives the backend, world size and
device.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import torch.distributed as dist

from repro_torch.core.fedgl import resolve_device
from repro_torch.core.partition import partition_graph
from repro_torch.core.spreadfgl import make_spreadfgl, make_spreadfgl_gossip
from repro_torch.core.types import FGLConfig
from repro_torch.data.synthetic_graphs import DATASETS, make_sbm_graph
from repro_torch.launch import mesh as mesh_lib


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks to start (0 = the world torchrun describes, or this "
                         "process alone)")
    ap.add_argument("--dataset", choices=tuple(DATASETS), default="cora")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--servers", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--gossip-every", type=int, default=0,
                    help="cross-server exchange interval K (0 = dense per-round "
                         "Eq. 16 aggregation)")
    ap.add_argument("--sim-shard", action="store_true",
                    help="ring-rotate the imputation candidate axis around the mesh "
                         "(core/ring_topk.py)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where each rank computes: cuda launches the CUDA kernels, "
                         "cpu runs their plain PyTorch versions")
    return ap


def run(args: argparse.Namespace) -> Dict[str, list]:
    """One rank's run: the mesh, the data, ``args.rounds`` rounds. Returns
    the history (every rank's is the same)."""
    mesh = mesh_lib.make_edge_mesh(args.servers)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    say(f"[edge-mesh] {mesh_lib.describe(mesh)}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    say(f"[edge-mesh] {world} rank(s); mesh size {mesh.size} for N={args.servers} "
        f"edge servers")
    sim_mesh = mesh if args.sim_shard else None
    if args.sim_shard:
        say(f"[edge-mesh] sim shard: candidate slabs ring-rotate over {mesh.size} rank(s)")

    graph = make_sbm_graph(DATASETS[args.dataset], scale=0.15, seed=args.seed + 1,
                           feature_noise=3.0, signal_ratio=0.5)
    batch, _ = partition_graph(graph, args.clients, aug_max=12, seed=args.seed)
    cfg = FGLConfig(hidden_dim=32, local_rounds=4, imputation_interval=2, top_k_links=4,
                    aug_max=12, gossip_every=max(args.gossip_every, 1), seed=args.seed)
    if args.gossip_every > 0:
        say(f"[edge-mesh] gossip aggregation: neighbor exchange every "
            f"{args.gossip_every} round(s) over the mesh")
        tr = make_spreadfgl_gossip(cfg, batch, num_servers=args.servers,
                                   gossip_every=args.gossip_every, edge_mesh=mesh,
                                   sim_mesh=sim_mesh, device=args.device)
    else:
        tr = make_spreadfgl(cfg, batch, num_servers=args.servers, edge_mesh=mesh,
                            sim_mesh=sim_mesh, device=args.device)
    nb = args.servers // mesh.size
    say(f"[edge-mesh] each rank runs the generator of {nb} server(s), rank 0 "
        f"servers [0, {nb})")

    t0 = time.perf_counter()
    _, hist = tr.fit(batch, rounds=args.rounds)
    dt = time.perf_counter() - t0
    say(f"[edge-mesh] {args.rounds} rounds in {dt:.2f}s: best acc={max(hist['acc']):.3f} "
        f"f1={max(hist['f1']):.3f}")
    return hist


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, list]:
    """Run from the command line; returns rank 0's history."""
    args = _parser().parse_args(argv)
    resolve_device(args.device)
    if args.devices > 0:
        if args.device == "cuda":
            from repro_torch.kernels import build
            build.load()          # once here, so the ranks load and none compiles
        return mesh_lib.spawn(run, args.devices, args.device, args=(args,))[0]
    joined = mesh_lib.init_from_env(args.device)
    try:
        return run(args)
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
