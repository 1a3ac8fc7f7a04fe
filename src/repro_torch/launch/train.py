"""LM training launcher of the PyTorch/CUDA port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --variant full --steps 6 --batch 2 --seq 2048 [--device cuda]

The flags of ``repro.launch.train`` (Adam with ``clip_norm=1.0`` and
``cosine_schedule(max(steps // 10, 1), steps)``), plus ``--device
{cuda,cpu}`` (default ``cuda``: the run fails without a GPU rather than
falling back), ``--microbatch`` (gradient accumulation over chunks of the
batch) and ``--remat/--no-remat`` (override the config's per-layer
recompute). Weights are random, drawn on the device from seed 0; tokens
come from ``data.lm_data.token_batches`` (seed 0), with a vlm's image
embeddings or whisper's audio frames. Every config of ``repro_torch.configs``
trains (the ten of ``launch.serve``); the default, ``--arch xlstm-125m
--variant smoke``, runs on the CPU with ``--device cpu``. A hybrid or ssm
``--seq`` is at most 128 or a multiple of 128. Each step is timed on the
host clock, ending in ``torch.cuda.synchronize()``. ``--checkpoint`` writes
the final parameters in the reference's layout (stacked layer groups,
``convert.lm_params_to_jax``), which ``repro.checkpoint.io.restore`` and
``repro_torch.launch.serve --checkpoint`` read. ``--layers N`` cuts the
config to its first N layers (``configs.cut_depth``: gemma3-12b's window
pattern with them).

``--aggregation spread --pods P`` trains P pods, the paper's edge servers:
P ranks of a mesh (``launch.mesh``), started here (``mesh.spawn``: rank r
on ``cuda:(r % card count)``, ``gloo`` where ranks share a card) or, under
``torchrun``, the world's. Each pod starts from the same weights, takes its
``B / P`` rows of each token batch (the reference's ``P("pod")`` split) and
averages its parameters with its ring neighbors' every ``--gossip-every``
steps. Every pod prints its step lines, tagged with its rank; ``main``
returns rank 0's results, and every rank's under ``"ranks"`` (without the
model).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import configs, convert
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core.fedgl import resolve_device
from repro_torch.data.lm_data import token_batches
from repro_torch.kernels import build
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.transformer import Transformer
from repro_torch.optim.adam import Adam, cosine_schedule
from repro_torch.train.step import TrainState, init_state, make_train_step


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_IDS, default="xlstm-125m")
    ap.add_argument("--variant", choices=("full", "smoke"), default="smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--aggregation", choices=("allreduce", "spread"), default="allreduce")
    ap.add_argument("--gossip-every", type=int, default=4)
    ap.add_argument("--pods", type=int, default=0,
                    help="pod axis size for --aggregation spread (0: the world)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to its first N layers (0: all)")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--microbatch", type=int, default=1,
                    help="accumulate gradients over this many chunks of the batch")
    ap.add_argument("--remat", action=argparse.BooleanOptionalAction, default=None,
                    help="recompute each layer group in the backward pass (default: "
                         "the config's)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model trains: cuda launches the CUDA kernels, "
                         "cpu runs their plain PyTorch versions")
    return ap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def optimizer(args: argparse.Namespace) -> Adam:
    """The reference launcher's optimizer: Adam, clipped at global norm 1,
    cosine schedule with a tenth of the steps of warm-up."""
    return Adam(lr=args.lr, clip_norm=1.0,
                schedule=cosine_schedule(max(args.steps // 10, 1), args.steps))


def setup(args: argparse.Namespace, model: Optional[Transformer] = None,
          pods: Optional[mesh_lib.Mesh] = None) -> Tuple[TrainState, Any, Any]:
    """(state, step function, token iterator) from the parsed flags; the
    kernels are built here, as set-up. ``model``: initial weights to train
    (moved to the device) instead of random ones; its config, depth
    included, takes the place of ``--arch``/``--variant``'s (``--remat``
    still applies). ``pods``: the pod mesh of ``--aggregation spread``; the
    iterator then gives this pod's rows of each batch."""
    dev = resolve_device(args.device)
    if model is not None:
        cfg = model.cfg
    elif args.layers:
        cfg = configs.cut_depth(configs.get_config(args.arch, args.variant), args.layers)
    else:
        cfg = configs.get_config(args.arch, args.variant)
    if args.remat is not None:
        cfg = dataclasses.replace(cfg, remat=args.remat)
    opt = optimizer(args)
    if model is not None:
        model = model.to(dev)
        model.cfg = cfg
    state = init_state(cfg, opt, seed=0, device=dev, model=model)
    step = make_train_step(cfg, opt, microbatch=args.microbatch, aggregation=args.aggregation,
                           gossip_every=args.gossip_every, pod_axis=pods)
    if dev.type == "cuda":
        build.load()
    _sync(dev)
    data = token_batches(cfg, batch=args.batch, seq_len=args.seq)
    if pods is not None and pods.size > 1:
        if args.batch % pods.size:
            raise ValueError(f"--batch {args.batch} does not split over {pods.size} pods")
        data = _pod_rows(data, pods)
    return state, step, data


def _pod_rows(data, pods: mesh_lib.Mesh):
    """This pod's rows of every batch: the ``P("pod")`` split."""
    for batch in data:
        rows = batch["tokens"].shape[0] // pods.size
        yield {k: v[pods.rank * rows:(pods.rank + 1) * rows] for k, v in batch.items()}


def main(argv: Optional[Sequence[str]] = None, *, model: Optional[Transformer] = None
         ) -> Dict[str, Any]:
    """Train from the command line. Returns the per-step ``losses``, MoE
    ``aux`` losses and ``seconds``, ``peak_bytes`` of device memory (CUDA)
    and the final ``state``; ``model`` as in ``setup``. Under ``--aggregation
    spread`` with ranks started here, rank 0's, every rank's under
    ``"ranks"``, and no state."""
    args = _parser().parse_args(argv)
    if args.aggregation != "spread":
        return _train(args, model)
    resolve_device(args.device)
    joined = mesh_lib.init_from_env(args.device)
    try:
        if dist.is_initialized() or args.pods <= 1:
            return _train(args, model, mesh_lib.make_host_mesh(pod=args.pods))
        if model is not None:
            raise ValueError("model= cannot be handed to pods started here; run under "
                             "torchrun, or cut the depth with --layers")
        if args.device == "cuda":
            build.load()          # once here, so the pods load and none compiles
        ranks = mesh_lib.spawn(spread_rank, args.pods, args.device, args=(args,))
        return dict(ranks[0], ranks=ranks)
    finally:
        if joined:
            dist.destroy_process_group()


def spread_rank(args: argparse.Namespace) -> Dict[str, Any]:
    """One pod of ``--aggregation spread``, in a rank ``mesh.spawn`` started:
    its results without the model."""
    out = _train(args, None, mesh_lib.make_host_mesh(pod=args.pods))
    out.pop("state")
    return out


def _train(args: argparse.Namespace, model: Optional[Transformer] = None,
           pods: Optional[mesh_lib.Mesh] = None) -> Dict[str, Any]:
    state, step, data = setup(args, model, pods)
    model = state.params
    cfg, dev = model.cfg, model.embed.tokens.device
    tag = f"[train pod {pods.rank}]" if pods is not None and pods.size > 1 else "[train]"
    if pods is not None:
        print(f"{tag} {mesh_lib.describe(pods)}, gossip every {args.gossip_every} step(s)")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{tag} {cfg.name}: {n_params / 1e6:.1f}M params on {dev}, "
          f"aggregation={args.aggregation}, remat={cfg.remat}, microbatch={args.microbatch}")
    losses, auxes, seconds = [], [], []
    t_start = time.perf_counter()
    for i in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        _sync(dev)
        seconds.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        auxes.append(float(metrics["aux"]))
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"{tag} step {i:4d} loss {losses[-1]:.4f} "
                  f"({time.perf_counter() - t_start:.1f}s)")
    if args.checkpoint and (pods is None or pods.rank == 0):
        ckpt_io.save(args.checkpoint, convert.lm_params_to_jax(model))
        print(f"{tag} saved params -> {args.checkpoint}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    return {"losses": losses, "aux": auxes, "seconds": seconds, "peak_bytes": peak,
            "state": state}


if __name__ == "__main__":
    main()
