"""End-to-end LM training driver with SpreadFGL gossip across pods.

  PYTHONPATH=src python examples_torch/train_lm_gossip.py --steps 200 [--device cuda|cpu]

The PyTorch/CUDA port of ``examples/train_lm_gossip.py``. Trains a
~125M-parameter xLSTM (the paper's aggregation technique lifted to LM
training) on ``--pods`` pods (4): each pod takes local steps on its shard of
every batch; every K steps parameters ring-gossip (Eq. 16) instead of
all-reducing. Compares the loss trajectory against classic all-reduce data
parallelism on the same token stream.

Where the reference re-execs itself with ``XLA_FLAGS`` for 4 host devices
and runs ``shard_map`` over a ``pod`` axis, the port starts one process per
pod (``launch.mesh.spawn``) joined by a process group: on the card
(``--device cuda``, the default; it raises without one) the pods share it
over ``gloo`` (``nccl`` where each has a card of its own), on the CPU over
``gloo``. Each pod starts from the same weights (seed 0) and takes its
``batch / pods`` rows of each batch (the reference's ``P("pod")`` split).
Both modes take the same local step (``train.step.make_train_step``), then
exchange leaf by leaf in place: mode ``allreduce`` averages the pods'
parameters after every step (``core.gossip.all_average``); mode ``spread``
averages each pod's with its two ring neighbors' every ``--gossip-every``
steps (``core.gossip.ring_gossip``, the exchange that
``make_train_step(aggregation="spread", pod_axis=mesh)`` makes inside its
step). The pod makes the exchange itself so that it can report each one:
its parameters' fingerprint and per-leaf sums before and after. Each
printed loss is the mean over the pods. Rank 0 prints.
"""
from __future__ import annotations

import argparse
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import gossip
from repro_torch.core.fedgl import resolve_device
from repro_torch.data.lm_data import token_batches
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim.adam import Adam
from repro_torch.train.step import init_state, leaves, make_train_step
from repro_torch.tree import tree_fingerprint

MODES = ("allreduce", "spread")


def _exchange(params: List[torch.Tensor], mesh, average: Callable) -> Dict[str, Any]:
    """``average(p, mesh)`` of each leaf written back in place; returns the
    pod's parameters' fingerprint (``tree_fingerprint``) and per-leaf f64
    sums before and after, and the per-leaf sums of |p| before."""
    def sums(fn=lambda p: p):
        return torch.stack([fn(p.double()).sum() for p in params]).tolist()

    seen = {"print_before": tree_fingerprint(params), "sum_before": sums(),
            "abs_before": sums(torch.abs)}
    for p in params:
        p.copy_(average(p, mesh))
    return dict(seen, print_after=tree_fingerprint(params), sum_after=sums())


def pod(args: Dict[str, Any]) -> Dict[str, Any]:
    """One pod, in a rank ``mesh.spawn`` started: both modes in turn, each
    from the same initial weights. Returns each mode's per-step losses (the
    mean over the pods), under ``"exchanges"`` each mode's exchanges as
    ``_exchange`` saw them, each with its step, and the pod's peak device
    memory (``"peak_bytes"``, 0 on the CPU)."""
    mesh = mesh_lib.make_host_mesh(pod=args["pods"])
    dev, rank, every = mesh.device, mesh.rank, max(args["gossip_every"], 1)
    cfg = configs.get_config("xlstm-125m", args["variant"], scan_layers=False, remat=False)
    rows = args["batch"] // mesh.size
    results: Dict[str, Any] = {"exchanges": {}}
    for mode in MODES:
        opt = Adam(lr=3e-4, clip_norm=1.0)
        state = init_state(cfg, opt, seed=0, device=dev)
        if mode == MODES[0] and rank == 0:
            n_params = sum(p.numel() for p in state.params.parameters())
            print(f"[example] xlstm-125m ({args['variant']}): {n_params / 1e6:.1f}M params on "
                  f"{mesh.size} simulated pods")
            print(f"[example] pods: {mesh_lib.describe(mesh)}")
        step = make_train_step(cfg, opt)
        average = gossip.all_average if mode == "allreduce" else gossip.ring_gossip
        data = token_batches(cfg, batch=args["batch"], seq_len=args["seq"], seed=42)
        losses, exchanges = [], []
        for i in range(args["steps"]):
            batch = {k: torch.from_numpy(v[rank * rows:(rank + 1) * rows]).to(dev)
                     for k, v in next(data).items()}
            state, metrics = step(state, batch)
            if mode == "allreduce" or (i + 1) % every == 0:
                with torch.no_grad():
                    seen = _exchange(list(leaves(state.params).values()), mesh, average)
                exchanges.append(dict(seen, step=i))
            loss = mesh_lib.all_reduce_sum(mesh, metrics["loss"].detach().float().reshape(1))
            losses.append(float(loss) / mesh.size)
            if rank == 0 and (i % 20 == 0 or i == args["steps"] - 1):
                print(f"[{mode:9s}] step {i:4d} loss {losses[-1]:.4f}", flush=True)
        results[mode], results["exchanges"][mode] = losses, exchanges
        del state, step
    results["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if rank == 0:
        a, s = results["allreduce"][-10:], results["spread"][-10:]
        print(f"\nfinal-10 mean loss: allreduce={np.mean(a):.4f} spread={np.mean(s):.4f}")
        print("gossip exchanges 2 neighbor copies every "
              f"{args['gossip_every']} steps vs a full all-reduce every step: "
              f"{2 / args['gossip_every'] / (2 * (mesh.size - 1) / mesh.size):.2f}x relative "
              "cross-pod traffic (see EXPERIMENTS.md §Perf)", flush=True)
    return results


def run(*, steps: int = 100, batch: int = 8, seq: int = 128, gossip_every: int = 4,
        variant: str = "full", pods: int = 4, device: str = "cuda",
        timeout: Optional[float] = None) -> Dict[str, Any]:
    """Start ``pods`` ranks of :func:`pod` and return rank 0's result, every
    rank's under ``"ranks"``. With ``timeout`` (seconds), pods still running
    then are killed and it raises ``TimeoutError``."""
    resolve_device(device)
    if pods < 2 or batch % pods:
        raise ValueError(f"--batch {batch} must split over --pods {pods} (at least 2)")
    args = {"steps": steps, "batch": batch, "seq": seq, "gossip_every": gossip_every,
            "variant": variant, "pods": pods}
    ranks = mesh_lib.spawn(pod, pods, device, args=(args,), timeout=timeout)
    return dict(ranks[0], ranks=ranks)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--gossip-every", type=int, default=4)
    ap.add_argument("--variant", default="full", choices=("full", "smoke"))
    ap.add_argument("--pods", type=int, default=4,
                    help="pods, one process each (the reference's 4 host devices)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the pods compute: cuda shares the card (or one card a "
                         "pod), cpu runs on the host")
    args = ap.parse_args(argv)
    return run(steps=args.steps, batch=args.batch, seq=args.seq,
               gossip_every=args.gossip_every, variant=args.variant, pods=args.pods,
               device=args.device)


if __name__ == "__main__":
    main()
