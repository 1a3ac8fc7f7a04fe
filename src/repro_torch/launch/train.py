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
``repro_torch.launch.serve --checkpoint`` read. ``--aggregation spread``
needs pods on several cards and raises (ROADMAP.md, queue 1, item 11).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch import configs, convert
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core.fedgl import resolve_device
from repro_torch.data.lm_data import token_batches
from repro_torch.kernels import build
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
                    help="pod axis size for --aggregation spread")
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


def setup(args: argparse.Namespace, model: Optional[Transformer] = None
          ) -> Tuple[TrainState, Any, Any]:
    """(state, step function, token iterator) from the parsed flags; the
    kernels are built here, as set-up. ``model``: initial weights to train
    (moved to the device) instead of random ones; its config, depth
    included, takes the place of ``--arch``/``--variant``'s (``--remat``
    still applies)."""
    if args.aggregation == "spread":
        raise NotImplementedError("--aggregation spread places pods on several cards and is "
                                  "not ported yet (ROADMAP.md, queue 1, item 11)")
    dev = resolve_device(args.device)
    cfg = configs.get_config(args.arch, args.variant) if model is None else model.cfg
    if args.remat is not None:
        cfg = dataclasses.replace(cfg, remat=args.remat)
    opt = optimizer(args)
    if model is not None:
        model = model.to(dev)
        model.cfg = cfg
    state = init_state(cfg, opt, seed=0, device=dev, model=model)
    step = make_train_step(cfg, opt, microbatch=args.microbatch)
    if dev.type == "cuda":
        build.load()
    _sync(dev)
    return state, step, token_batches(cfg, batch=args.batch, seq_len=args.seq)


def main(argv: Optional[Sequence[str]] = None, *, model: Optional[Transformer] = None
         ) -> Dict[str, Any]:
    """Train from the command line. Returns the per-step ``losses``, MoE
    ``aux`` losses and ``seconds`` and the final ``state``; ``model`` as in
    ``setup``."""
    args = _parser().parse_args(argv)
    state, step, data = setup(args, model)
    model = state.params
    cfg, dev = model.cfg, model.embed.tokens.device
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train] {cfg.name}: {n_params / 1e6:.1f}M params on {dev}, "
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
            print(f"[train] step {i:4d} loss {losses[-1]:.4f} "
                  f"({time.perf_counter() - t_start:.1f}s)")
    if args.checkpoint:
        ckpt_io.save(args.checkpoint, convert.lm_params_to_jax(model))
        print(f"[train] saved params -> {args.checkpoint}")
    return {"losses": losses, "aux": auxes, "seconds": seconds, "state": state}


if __name__ == "__main__":
    main()
