"""Batched serving example: prefill + greedy decode with KV/recurrent caches.

  PYTHONPATH=src python examples_torch/serve_lm.py --arch qwen3-4b [--device cuda|cpu]

The PyTorch/CUDA port of ``examples/serve_lm.py``. Serves a reduced-config
(smoke) model: batches 4 prompts, prefills them in one shot, then decodes 24
tokens per request. Works for every assigned architecture (GQA KV caches,
MoE experts, mamba/mLSTM recurrent states, whisper/VLM cross-attention
memory). On the card (``--device cuda``, the default; it raises without one)
the prefill's attention launches the CUDA ``flash_attention`` kernel, at
any head dim up to 240 (hymba-1.5b's smoke config has 20, zero-padded to
the kernel's 32); ``--device cpu`` runs its plain version.

The weights are random, drawn on the CPU from seed 0 and moved to the
device, so a run on the card and one on the CPU serve the same model. They
are not the reference's: JAX draws its own from ``jax.random.key(0)``
(``repro_torch.convert`` carries a JAX model across).
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import numpy as np

from repro_torch import configs
from repro_torch.core.fedgl import resolve_device
from repro_torch.data.lm_data import memory_stub
from repro_torch.models import transformer
from repro_torch.serve.engine import ServeEngine


def run(arch: str = "qwen3-4b", *, steps: int = 24, batch: int = 4, prompt_len: int = 16,
        temperature: float = 0.0, device: str = "cuda",
        model: Optional[transformer.Transformer] = None) -> Dict[str, Any]:
    """Serve ``arch``'s smoke config (or ``model``, moved to the device);
    returns the generated ``tokens`` [batch, steps], the ``prompts`` and
    the ``engine``."""
    dev = resolve_device(device)
    cfg = configs.get_config(arch, "smoke") if model is None else model.cfg
    if model is None:
        model = transformer.init_model(cfg, seed=0, device="cpu")
    engine = ServeEngine(model.to(dev), max_len=prompt_len + steps + 8)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(batch, prompt_len)).astype(np.int32)
    memory = memory_stub(cfg, batch)
    print(f"[serve] {cfg.name}: {batch} requests × "
          f"{prompt_len} prompt tokens -> {steps} new tokens")
    out = engine.generate(prompts, steps=steps, temperature=temperature, memory=memory)
    for i, row in enumerate(out):
        print(f"  request {i}: {row.tolist()}")
    return {"tokens": out, "prompts": prompts, "engine": engine}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_IDS, default="qwen3-4b")
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda launches the CUDA kernels, cpu runs their plain versions")
    args = ap.parse_args(argv)
    return run(args.arch, steps=args.steps, batch=args.batch, prompt_len=args.prompt_len,
               temperature=args.temperature, device=args.device)


if __name__ == "__main__":
    main()
