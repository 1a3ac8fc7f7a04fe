"""Serving launcher of the PyTorch/CUDA port: batched generation.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
      --variant full --batch 8 --prompt-len 2048 --steps 64 [--device cuda]

The flags of ``repro.launch.serve`` plus ``--device {cuda,cpu}`` (default
``cuda``: the run fails without a GPU rather than falling back). Weights are
random, drawn on the device from seed 0; prompts come from
``numpy.random.default_rng(0)``, as in the reference. Prefill (through the
CUDA ``flash_attention`` kernel) and the decode loop are timed separately,
each clock reading after ``torch.cuda.synchronize()``. All ten configs of
``repro_torch.configs`` build: dense (qwen3-4b, gemma3-12b,
command-r-plus-104b, llama3-405b), MoE (olmoe-1b-7b, mixtral-8x7b), vlm
(llama-3.2-vision-11b), audio (whisper-medium), hybrid (hymba-1.5b) and ssm
(xlstm-125m). A vlm config attends to ``data.lm_data.memory_stub``'s image
embeddings and whisper encodes its f32 frames (seed 0), as the reference's
launcher passes them. A hybrid or ssm prompt is at most 128 tokens or a
multiple of 128 (the chunkwise scans take whole chunks).
``--checkpoint`` loads the weights from an
``.npz`` of ``transformer.init_model`` parameters that the JAX package wrote
(``repro.checkpoint.io.save``), through ``convert.lm_params_from_jax``.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import configs, convert
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core.fedgl import resolve_device
from repro_torch.data.lm_data import memory_stub
from repro_torch.kernels import build
from repro_torch.models import transformer
from repro_torch.serve.engine import ServeEngine


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_IDS, default="qwen3-4b")
    ap.add_argument("--variant", choices=("full", "smoke"), default="smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--checkpoint", default="",
                    help="an .npz of the JAX package's LM parameters to serve")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model runs: cuda launches the CUDA kernels, "
                         "cpu runs their plain PyTorch versions")
    return ap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def setup(args: argparse.Namespace, model: Optional[transformer.Transformer] = None
          ) -> Tuple[ServeEngine, np.ndarray, Optional[np.ndarray], Optional[torch.Generator]]:
    """The engine with its random model on the device, the prompts, the
    memory (image embeddings for a vlm config, audio frames for an
    encoder-decoder config, else None) and the sampling
    generator (None when greedy), from the parsed flags; the kernels are
    built here, as set-up. ``model``: a model to serve (moved to the
    device), whose config, depth included, takes the place of
    ``--arch``/``--variant``'s."""
    dev = resolve_device(args.device)
    cfg = configs.get_config(args.arch, args.variant) if model is None else model.cfg
    if model is not None:
        model = model.to(dev)
    elif args.checkpoint:
        model = convert.lm_params_from_jax(ckpt_io.load(args.checkpoint), cfg, device=dev)
    else:
        model = transformer.init_model(cfg, seed=0, device=dev)
    engine = ServeEngine(model, max_len=args.prompt_len + args.steps + 8)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len)).astype(np.int32)
    memory = memory_stub(cfg, args.batch)
    gen = None
    if args.temperature > 0:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    if dev.type == "cuda":
        build.load()
    _sync(dev)
    return engine, prompts, memory, gen


def main(argv: Optional[Sequence[str]] = None, *,
         model: Optional[transformer.Transformer] = None) -> Dict[str, Any]:
    """Serve from the command line. Returns ``prefill_s`` and ``decode_s``
    (seconds), ``tokens`` ([B, steps] numpy), the prefill ``logits``, and the
    ``engine``, ``prompts`` and ``memory`` it served; ``model`` as in
    ``setup``."""
    args = _parser().parse_args(argv)
    engine, prompts, memory, gen = setup(args, model)
    dev, cfg = engine.device, engine.model.cfg
    t0 = time.perf_counter()
    logits, cache = engine.prefill(prompts, memory)
    _sync(dev)
    t1 = time.perf_counter()
    tokens = engine.decode(cache, logits, steps=args.steps,
                           temperature=args.temperature, generator=gen)
    _sync(dev)
    t2 = time.perf_counter()
    prefill_s, decode_s = t1 - t0, t2 - t1
    out = tokens.cpu().numpy().astype(np.int32)
    print(f"[serve] {cfg.name} on {dev}: prefill {args.batch}x{args.prompt_len} tokens "
          f"in {prefill_s:.3f} s; {args.steps} decode steps in {decode_s:.3f} s "
          f"({decode_s / max(args.steps, 1) * 1e3:.2f} ms/step, "
          f"{args.batch * args.steps / decode_s:.1f} tok/s)")
    for i, row in enumerate(out[:4]):
        print(f"  request {i}: {row[:16].tolist()}...")
    return {"prefill_s": prefill_s, "decode_s": decode_s, "tokens": out, "logits": logits,
            "engine": engine, "prompts": prompts, "memory": memory}


if __name__ == "__main__":
    main()
