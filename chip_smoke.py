#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU and hold its kernels to account.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. Device: the card's name and power limit (``nvidia-smi``), then the build
   of every kernel in ``src/repro_torch/kernels/csrc`` with ``nvcc``.
2. Kernels against their plain PyTorch versions on the card, at the shapes
   the main paths give them plus ragged shapes: each kernel's time, the
   plain version's time, one library call's time (used nowhere in the port)
   and its bound on the card. ``sage_aggregate`` is timed at both layers of
   the Coauthor-CS classifier, on a random adjacency and on the main path's
   own ``a_norm``, against the bytes it must move (A and H read once, the
   output written once), and held bit for bit across two calls. ``flash_attention`` has
   two routes, checked and timed apart, both on the tensor cores: bf16, and
   f32 by three TF32 passes, against the bound of those passes and that of
   one f32 pass on the CUDA cores; the f32 route also at the main paths'
   own shape (q [2,32,2048,80], kv 8 heads: the f32 prefill and training
   step), with and without the row log-sum-exp, two calls bit for bit.
   ``sim_topk`` is checked at shapes that cross its split of the candidate
   axis and timed at SpreadFGL's, against the bound of the full gram and
   that of the cross-client pairs the data needs, and its general form as
   the ring top-k folds it: the candidate axis in 2, 3 and 4 slabs, each
   query shard folded over every slab with its running list, bit for bit
   the one-call kernel, one fold timed per slab count. ``sim_block``, which no
   path calls, is checked and timed at the Coauthor-CS server's gram.
   ``flash_attention``'s backward has two routes too, both on the tensor
   cores: bf16, and f32 by three TF32 passes. Each is held against its plain
   version at the training shape and in a windowed GQA case (with the
   forward's row log-sum-exp, and two runs bit for bit), and timed at the
   training shape against SDPA's backward (f32 without TF32) and the bounds
   of the five products the gradient needs and of the seven it computes (for
   f32, three TF32 passes at the TF32 peak, beside one f32 pass on the CUDA
   cores). At the MoE and vlm paths' head dim, D = 128: the bf16 forward at
   OLMoE-1B-7B's prefill (q [8,16,2048,128]), Llama-3.2-Vision-11B's (q
   [8,32,2048,128], kv [8,8,2048,128]) and Mixtral-8x7B's (q
   [2,32,8192,128], kv [2,8,8192,128], window 4096), and the bf16 training
   forward and backward at OLMoE's training shape (q [2,16,2048,128]), each
   held and timed as above (``cases`` of their entries). At the audio and
   hybrid paths' head dim, D = 64: the bf16 forward at Hymba-1.5B's prefill
   (q [8,25,2048,64], kv [8,5,2048,64], GQA 25:5, window 1024 and global)
   and Whisper-medium's decoder prompt (q [8,16,224,64]); the bf16 training
   forward and backward at Hymba's training shape (q [2,25,2048,64], kv 5
   heads, window 1024) and Whisper's decoder's (q [8,16,448,64]), two
   backward runs bit for bit; each held and timed as above. At gemma3-12b's
   head dim, D = 240: the bf16 forward at its prefill (q [8,16,2048,240], kv
   [8,8,2048,240], global and window 1024), the bf16 training forward and
   backward at its training shape (q [2,16,2048,240], kv 8 heads, window
   1024 and global), and the f32 route's forward and backward there
   (global) and at Whisper's decoder training shape (q [8,16,448,64]), each
   held and timed as above, two backward runs bit for bit. At hymba-1.5b's
   smoke config's head dim, 20, which no kernel instance has (q
   [2,5,128,20], kv 1 head, window 1024 and global): every kernel in bf16
   and f32, forward (with and without the row log-sum-exp) and backward,
   zero-padded to the instance 32 and cut back, one launch a call, held to
   the plain versions at head dim 20 with the limits above, two backward
   runs bit for bit, each timed beside SDPA and its bound at head dim 20.
3. Small training runs of every method and option (SpreadFGL, FedSage+,
   partial participation, async and gossip aggregation, GCN and GAT) and
   small f32 serving runs (the qwen3-4b, gemma3-12b, olmoe-1b-7b,
   mixtral-8x7b and llama-3.2-vision-11b smoke configs, the vlm with its
   cross gates at ``CROSS_GATE``, olmoe also at capacity factor
   ``TIGHT_CAPACITY``, where every layer must drop (token, k) slots on both
   devices) on the card against the same runs on the
   CPU (the kernels' plain versions), from the same weights, noise and
   prompts; the trainers draw their own participation masks and async
   schedules on both; whisper-medium's smoke config with its frames through
   the encoder, hymba-1.5b's at d_model 160 (``HYMBA_SMOKE``: head dim 32,
   an instance; phase 5 serves its smoke config's own 20), xlstm-125m's, and
   gemma3-12b's at head dim 240 (``GEMMA_D240_SMOKE``, its full config's).
   Then the qwen3-4b and olmoe-1b-7b smoke configs in
   bf16 on the card, the prefill through the tensor-core kernel against the
   same prefill with the plain version patched in. Small LM training runs
   (``repro_torch.launch.train``, the qwen3-4b, olmoe-1b-7b (also at
   ``TIGHT_CAPACITY``, dropping slots), llama-3.2-vision-11b, gemma3-12b
   (also at head dim 240), whisper-medium, hymba-1.5b (``HYMBA_SMOKE``) and
   xlstm-125m smoke configs
   in f32, 3 steps, remat on and off, 2 microbatches) on the
   card against the CPU, and a checkpoint written on the card served by
   ``repro_torch.launch.serve --checkpoint``. One training step of Qwen3-4B
   at full width, depth cut to 4 layers, in bf16 and in float32, through the
   kernels against the same step with the plain attention patched in.
4. The main paths, each with every kernel's launch counter set to 0 just
   before it and read just after: through
   ``repro_torch.launch.fgl_train.main``, SpreadFGL on full-size Coauthor-CS
   (6 clients, 3 servers, 3 rounds, 2 imputation rounds), then FedGL on
   full-size Cora; then, on one full-size Coauthor-CS batch built once, the
   rest of the FGL engine: through ``fgl_train.main``, FedSage+ (2 rounds),
   SpreadFGL with participation 0.5, ``spreadfgl_async`` (buffer 4, uniform
   delays, dropout 0.1) and ``spreadfgl_gossip`` (exchange every 2 rounds),
   3 rounds each; through ``registry.build``, SpreadFGL with GCN and with
   GAT classifiers, 3 rounds each; and the async run stopped after rounds
   0-1 with ``--save-state`` and continued for round 2 with ``--resume``,
   whose rounds equal the unstopped run's bit for bit. Through
   ``repro_torch.launch.serve.main``, Qwen3-4B at full width and depth
   serving a batch of 8 prompts of 2048 tokens for 64 greedy decode steps; then Qwen3-4B at full width and depth in float32,
   batch 2 x 2048-token prompts, prefill and 8 greedy decode steps through
   the f32 route, held against the same prefill with the plain version
   patched in. Through ``repro_torch.launch.train.main``, Qwen3-4B at full
   width and depth training in bf16 with remat, batch 2 x 2048 tokens, 6
   steps: 72 forward and 36 backward attention launches a step, all bf16.
   Then the distributed edge layer: the SpreadFGL main path's flags with
   ``--edge-mesh --sim-shard`` in this process (size-1 meshes), bit for bit
   the plain run; the same and ``--gossip-every 2`` on 3 gloo ranks sharing
   the card (``launch.mesh.spawn``), every rank within 1e-4 a round, its
   launches counted in the rank; ``launch.edge_mesh --devices 3``; and
   ``launch.train --aggregation spread --pods 2`` on Qwen3-4B at full width
   cut to 8 layers, 4 steps, the pods' mean held by every gossip exchange.
   Through ``repro_torch.train.step``, the same model in float32 (remat, the
   launcher's Adam), batch 2 x 2048, 4 steps: 72 f32 forward and 36 f32
   backward launches a step, none bf16. Through ``launch.serve.main``, bf16
   with random weights: OLMoE-1B-7B at full width and depth (batch 8 x
   2048, 64 decode steps; the share of (token, k) slots capacity dropped in
   each prefill layer, and how alike a group's router inputs are);
   Mixtral-8x7B at full width cut to 24 of 32 layers
   (batch 2 x 8192, 32 decode steps, across the 4096-slot ring buffer);
   Llama-3.2-Vision-11B at full width and depth with 1024 image tokens and
   its cross gates at ``CROSS_GATE`` (batch 8 x 2048, 64 decode steps; its
   logits must move with the memory). Through ``launch.train.main(model=)``,
   OLMoE-1B-7B at full width cut to 14 of 16 layers in bf16 with remat,
   batch 2 x 2048, 4 steps, aux above 0. Then, bf16 with random weights at
   full width and depth, each served through ``launch.serve.main`` and
   trained through ``launch.train.main`` (remat, 4 steps): Whisper-medium
   (24 + 24 layers, memory_stub's 1500 f32 frames; batch 8, a 224-token
   prompt and 224 greedy steps filling its 448 positions, its logits must
   move with the frames; training batch 8 x 448); Hymba-1.5B (batch 8 x
   2048, 64 steps across the 1024-slot ring buffers; training 2 x 2048);
   xLSTM-125M (batch 8 x 2048, 64 steps; training 8 x 2048; no kernel on
   its path). Each prints its times, peak memory and flash launches. Then
   gemma3-12b (head dim 240), bf16 with random weights: served at full width
   and depth (48 layers, batch 8 x 2048, 64 decode steps across the
   1024-slot ring buffers; 48 bf16 forward launches a prefill), its prefill
   beside the dry-run's one-card record; trained at full width cut to 12
   layers (2 steps) and 18 (4 steps, remat, batch 2 x 2048), the second the
   deepest multiple of 6 whose peak stays under 90 % of the card's memory
   by the bytes a layer adds between the two.
   After the serving and training main paths of Qwen3-4B, the H100 cost
   model (``launch.dryrun.run_one``, counted on meta tensors, no card time)
   of the same prefill and training step on the one-card mesh is held
   against their measured seconds (its ``compute_s`` a bound) and peak
   memory (the step's within 10 %); then the fleet's Qwen3-4B records and
   ``gossip_dryrun``'s line are printed.
5. The four examples of ``examples_torch/`` on the card, each with the launch
   counters set to 0 just before and read just after, its wall seconds and
   peak memory printed: ``quickstart`` (its rounds bit for bit a plain
   ``fit(rounds=10)`` from the same initial state, ``sage_aggregate`` and
   ``sim_topk`` launched); ``spreadfgl_multiserver`` (each of its six
   methods: losses finite, accuracies in [0, 1], ``sage_aggregate``
   launched, and ``sim_topk`` by the methods with the imputation round);
   ``serve_lm`` for each of the ten arch ids (one f32 flash launch per
   attention layer, hymba-1.5b at head dim 20, greedy tokens equal to the
   CPU's from the same weights); ``train_lm_gossip`` at xLSTM-125M full
   width on 4 pods sharing the card, cut to ``GOSSIP_EXAMPLE_STEPS`` steps a
   mode (the pods identical after every all-reduce step, their mean kept by
   every gossip exchange, losses finite).
6. One JSON line describing every kernel, the card line, and the result line
   ``{"ok": true, "device": {...}}`` last.

Without a CUDA device, or without the repository around it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.roofline import hw  # noqa: E402

# The H100's data-sheet rates: float32 outside the tensor cores, dense TF32
# and bf16 on the tensor cores, and HBM3.
F32_FLOPS, TF32_FLOPS, BF16_FLOPS = hw.PEAK_FLOPS_F32, hw.PEAK_FLOPS_TF32, hw.PEAK_FLOPS_BF16
HBM_BYTES_PER_S = hw.HBM_BW

SPREAD_ARGS = ["--dataset", "coauthor_cs", "--scale", "1.0", "--method", "SpreadFGL",
               "--clients", "6", "--servers", "3", "--rounds", "3", "-K", "2"]
FEDGL_ARGS = ["--dataset", "cora", "--scale", "1.0", "--method", "FedGL", "--rounds", "2"]
# The rest of the FGL engine, each run on one full-size Coauthor-CS batch at
# the launcher's defaults (K = 2).
ENGINE_ARGS = ["--dataset", "coauthor_cs", "--scale", "1.0", "--clients", "6",
               "--servers", "3"]
ENGINE_RUNS = (("fedsage_plus", ["--method", "fedsage_plus"], 2),   # (what, flags, rounds)
               ("participation 0.5", ["--participation", "0.5"], 3),
               ("spreadfgl_async", ["--async-buffer", "4", "--delay-dist", "uniform",
                                    "--dropout-rate", "0.1"], 3),
               ("spreadfgl_gossip", ["--gossip-every", "2"], 3))
ENGINE_KINDS = ("gcn", "gat")
# The distributed edge layer: the ring top-k's slab counts at the Coauthor-CS
# imputation shape; the edge and sim meshes on the main path's flags, in this
# process (size-1 meshes) and on EDGE_RANKS gloo ranks sharing the card, one
# server each; the edge-mesh launcher at its own size (cora at scale 0.15);
# spread LM training of Qwen3-4B at full width cut to SPREAD_LAYERS layers,
# two pods sharing the card, each with the main training path's 2 x 2048.
RING_SLABS = (2, 3, 4)
EDGE_FLAGS = ["--edge-mesh", "--sim-shard"]
EDGE_RANKS = 3
EDGE_MESH_ARGS = ["--servers", "3", "--clients", "6", "--rounds", "2", "--sim-shard"]
SPREAD_LAYERS = 8
SPREAD_TRAIN_ARGS = ["--arch", "qwen3-4b", "--variant", "full", "--batch", "4", "--seq",
                     "2048", "--steps", "4", "--lr", "3e-4", "--log-every", "1",
                     "--aggregation", "spread", "--pods", "2", "--gossip-every", "2",
                     "--layers", str(SPREAD_LAYERS)]
SERVE_ARGS = ["--arch", "qwen3-4b", "--variant", "full", "--batch", "8",
              "--prompt-len", "2048", "--steps", "64"]
TRAIN_ARGS = ["--arch", "qwen3-4b", "--variant", "full", "--batch", "2", "--seq", "2048",
              "--steps", "6", "--lr", "3e-4", "--log-every", "1"]
# The f32 training path: the same model, optimizer and batch in float32, 4 steps.
F32_TRAIN_ARGS = ["--arch", "qwen3-4b", "--variant", "full", "--batch", "2", "--seq", "2048",
                  "--steps", "4", "--lr", "3e-4"]
# olmoe's smoke config routes top-2 of 4 experts with capacity factor 2.0,
# which drops nothing; its runs at this factor drop (token, k) slots.
TIGHT_CAPACITY = 0.5
# hymba's smoke config has head dim 20 (d 100, 5 heads), which the flash
# kernels run zero-padded to 32 (phase 2's D20_CASES, phase 5's serve_lm);
# these small runs, card against CPU, take the instance 32 itself at this
# width, on both devices.
HYMBA_SMOKE = {"d_model": 160, "head_dim": 32}
# gemma3-12b's smoke config at its full config's head dim, 240 (d_model 128,
# 4 q heads of 240): its small runs, card against CPU, take the D = 240
# instances on a model's path.
GEMMA_D240_SMOKE = {"head_dim": 240}
# Small training runs, card against CPU: (arch, extra flags, smoke config
# overrides). The last one's checkpoint is served by serve --checkpoint.
SMALL_TRAIN_RUNS = (("qwen3-4b", ["--no-remat"], {}),
                    ("qwen3-4b", ["--remat", "--microbatch", "2"], {}),
                    ("olmoe-1b-7b", ["--remat"], {}),
                    ("olmoe-1b-7b", ["--remat"], {"capacity_factor": TIGHT_CAPACITY}),
                    ("llama-3.2-vision-11b", ["--no-remat", "--microbatch", "2"], {}),
                    ("gemma3-12b", ["--no-remat", "--microbatch", "2"], {}),
                    ("whisper-medium", ["--remat"], {}),
                    ("hymba-1.5b", ["--remat"], HYMBA_SMOKE),
                    ("xlstm-125m", ["--no-remat", "--microbatch", "2"], {}),
                    ("gemma3-12b", ["--remat", "--microbatch", "2"], GEMMA_D240_SMOKE),
                    ("gemma3-12b", ["--remat"], {}))
# The MoE and vlm paths: OLMoE-1B-7B serving at full width and depth;
# Mixtral-8x7B at full width cut to MIXTRAL_LAYERS of 32 layers, its
# 8192-token prompts past the 4096-slot window; Llama-3.2-Vision-11B at full
# width and depth with memory_stub's 1024 image tokens; OLMoE-1B-7B training
# cut to OLMOE_TRAIN_LAYERS of 16. Memory forces both cuts, time neither:
# each is the deepest whose peak, from the bytes a layer adds (Mixtral 2.90
# GB of bf16 weights; OLMoE training 5.04 GB of weights, gradients and f32
# moments) plus what a 4-layer and an 8-layer run measured beside their
# weights, stays 10 % below the card's 85 GB.
OLMOE_SERVE_ARGS = ["--arch", "olmoe-1b-7b", "--variant", "full", "--batch", "8",
                    "--prompt-len", "2048", "--steps", "64"]
MIXTRAL_SERVE_ARGS = ["--arch", "mixtral-8x7b", "--variant", "full", "--batch", "2",
                      "--prompt-len", "8192", "--steps", "32"]
MIXTRAL_LAYERS = 24
VLM_SERVE_ARGS = ["--arch", "llama-3.2-vision-11b", "--variant", "full", "--batch", "8",
                  "--prompt-len", "2048", "--steps", "64"]
OLMOE_TRAIN_ARGS = ["--arch", "olmoe-1b-7b", "--variant", "full", "--batch", "2", "--seq",
                    "2048", "--steps", "4", "--lr", "3e-4", "--log-every", "1"]
OLMOE_TRAIN_LAYERS = 14
# The vlm's cross-block gates are 0 at init, and tanh(0) = 0 removes the
# memory from the result: every vlm run here sets them to this.
CROSS_GATE = 0.5
# The audio, hybrid and ssm paths, each at full width and depth with random
# bf16 weights. Whisper-medium: memory_stub's 1500 f32 frames, a 224-token
# prompt and 224 greedy steps fill its 448 learned positions, as Whisper's own
# decoding does; training at its 448 positions. Hymba-1.5B: 2048-token
# prompts past its 1024-slot ring buffers. xLSTM-125M launches no kernel.
WHISPER_SERVE_ARGS = ["--arch", "whisper-medium", "--variant", "full", "--batch", "8",
                      "--prompt-len", "224", "--steps", "224"]
WHISPER_TRAIN_ARGS = ["--arch", "whisper-medium", "--variant", "full", "--batch", "8",
                      "--seq", "448", "--steps", "4", "--lr", "3e-4", "--log-every", "1"]
HYMBA_SERVE_ARGS = ["--arch", "hymba-1.5b", "--variant", "full", "--batch", "8",
                    "--prompt-len", "2048", "--steps", "64"]
HYMBA_TRAIN_ARGS = ["--arch", "hymba-1.5b", "--variant", "full", "--batch", "2",
                    "--seq", "2048", "--steps", "4", "--lr", "3e-4", "--log-every", "1"]
XLSTM_SERVE_ARGS = ["--arch", "xlstm-125m", "--variant", "full", "--batch", "8",
                    "--prompt-len", "2048", "--steps", "64"]
XLSTM_TRAIN_ARGS = ["--arch", "xlstm-125m", "--variant", "full", "--batch", "8",
                    "--seq", "2048", "--steps", "4", "--lr", "3e-4", "--log-every", "1"]
# gemma3-12b, whose head dim is 240 (3840 / 16 heads): served at full width
# and depth (48 layers, 5 local of window 1024 : 1 global), 2048-token
# prompts past the 1024-slot ring buffers; trained at full width cut to
# GEMMA_TRAIN_LAYERS of 48 (a multiple of 6 keeps the 5:1 pattern). Memory
# forces the cut: 18 layers peaked at 72.1 GB, and each layer adds ~2.66 GB
# of bf16 weights and gradients and f32 moments (12 bytes a parameter), so
# 24 would pass 90 % of the card's 85 GB. _gemma_paths measures the bytes a
# layer adds (GEMMA_PROBE_LAYERS against GEMMA_TRAIN_LAYERS) and holds the
# cut to that rule.
GEMMA_SERVE_ARGS = ["--arch", "gemma3-12b", "--variant", "full", "--batch", "8",
                    "--prompt-len", "2048", "--steps", "64"]
GEMMA_TRAIN_LAYERS = 18
GEMMA_PROBE_LAYERS = 12
GEMMA_TRAIN_ARGS = ["--arch", "gemma3-12b", "--variant", "full", "--batch", "2", "--seq",
                    "2048", "--lr", "3e-4", "--log-every", "1"]


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


_TYPES = {"__nv_bfloat16": "bf16", "__half": "f16"}


def _template_args(rest: str) -> list:
    """The integer, bool and type arguments of the mangled template argument
    list that ``rest`` starts with, up to the ``Ev`` that closes it and names
    the void return: ``IfLi4EEv...`` gives ``['f32', '4']``, ``ILi80ELb1EEv``
    ``['80', 'true']``."""
    out, i = [], 1
    while i < len(rest) and not rest.startswith("Ev", i):
        m = re.match(r"Li(-?\d+)E|(\d+)|f|Lb([01])E", rest[i:])
        if not m:
            i += 1
        elif m.group(1) is not None:
            out.append(m.group(1))
            i += m.end()
        elif m.group(3) is not None:
            out.append("true" if m.group(3) == "1" else "false")
            i += m.end()
        elif m.group(2) is not None:    # a name: its length, then its characters
            name = rest[i + m.end():i + m.end() + int(m.group(2))]
            if name in _TYPES:
                out.append(_TYPES[name])
            i += m.end() + len(name)
        else:
            out.append("f32")
            i += 1
    return out


def _kernel_name(mangled: str) -> str:
    """``sim_block_kernel<bf16, 4>`` from a mangled kernel name: the kernel's
    name and the integer and type arguments among its template arguments."""
    for i in range(len(mangled)):      # a name is its length, then its characters
        m = re.match(r"\d+", mangled[i:])
        if not m:
            continue
        end = i + m.end()
        ident = mangled[end:end + int(m.group())]
        if ident.endswith("_kernel"):
            rest = mangled[end + len(ident):]
            targs = _template_args(rest) if rest.startswith("I") else []
            return ident + (f"<{', '.join(targs)}>" if targs else "")
    return mangled


def _ptxas_report(log: str):
    """One line per kernel instance of a ``-Xptxas -v`` log: its registers and
    spills, named by the kernel and its template arguments."""
    name, spill = "?", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name, spill = _kernel_name(line.split("'")[1]), ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            yield f"{name}: {line.split(':', 1)[1].strip()}; {spill}"


def _sass_counts(lib: Path, ops=("HGMMA", "UTMALDG", "HMMA")) -> dict:
    """Per kernel instance of a built library, by ``cuobjdump -sass``: how
    many of its instructions are each of ``ops`` (HGMMA is wgmma, UTMALDG a
    TMA load, HMMA mma.sync)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True,
                          timeout=600).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _kernel_name(m.group(1))
            counts[name] = dict.fromkeys(ops, 0)
        elif name:
            for op in ops:
                counts[name][op] += len(re.findall(rf"\b{op}\b", line))
    return counts


# The bf16 flash_attention kernels that must run wgmma fed by TMA: the
# forward's serving and training kernels and the backward's dK/dV and dQ.
WGMMA_FLASH_KERNELS = ("flash_attention_tc_kernel", "flash_attention_tc_lse_kernel",
                       "flash_attention_bwd_dkdv_tc_kernel", "flash_attention_bwd_dq_tc_kernel")
# The f32 forward, and the f32 backward's dK/dV and dQ kernels: TF32 wgmma
# fed by TMA.
WGMMA_F32_FWD_KERNELS = ("flash_attention_f32_kernel",)
WGMMA_F32_BWD_KERNELS = ("flash_attention_bwd_dkdv_f32_kernel",
                         "flash_attention_bwd_dq_f32_kernel")


def _check_flash_sass(ptxas: dict) -> None:
    """Every instance of the bf16 forward (serving and training kernels), of
    the bf16 backward's dK/dV and dQ kernels, of the f32 forward and of the
    f32 backward's dK/dV and dQ kernels, each head dim, runs wgmma fed by
    TMA and no mma.sync: a hard failure
    otherwise. Prints each instance's counts beside its registers and spills
    (``ptxas``: the ``-Xptxas -v`` line of each instance)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kflash

    counts = _sass_counts(build.library_path())
    for kind in WGMMA_FLASH_KERNELS + WGMMA_F32_FWD_KERNELS + WGMMA_F32_BWD_KERNELS:
        for d in kflash.HEAD_DIMS:
            name = f"{kind}<{d}>"
            c = counts.get(name)
            print(f"[smoke] sass {name}: {c} ; ptxas {ptxas.get(name)}")
            if c is None or not c["HGMMA"] or not c["UTMALDG"] or c["HMMA"]:
                raise AssertionError(f"{name} is not a wgmma kernel fed by TMA: {c}")


def _time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(flops: float, nbytes: float, peak: float = F32_FLOPS):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _counters():
    """Each kernel's launch counter, as (module, attribute)."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import sage_aggregate as ksage
    from repro_torch.kernels import sim_topk as ksim
    return {"sage_aggregate": (ksage, "launches"), "sim_topk": (ksim, "launches"),
            "sim_block": (ksim, "block_launches"),
            "flash_attention_tc": (kflash, "launches_tc"),
            "flash_attention_tc_lse": (kflash, "launches_tc_lse"),
            "flash_attention_f32": (kflash, "launches_f32"),
            "flash_attention_bwd": (kflash, "launches_bwd"),
            "flash_attention_bwd_tc": (kflash, "launches_bwd_tc"),
            "flash_attention_bwd_f32": (kflash, "launches_bwd_f32")}


def _attn_layers(cfg) -> int:
    """Decoder layers whose prefill or training attention goes through
    ``ops.mha``: every layer but the ssm family's (whisper's encoder runs
    plain attention)."""
    from repro_torch.models.transformer import _block_kind
    return sum(_block_kind(cfg, i) in ("attn", "hybrid", "encdec_dec")
               for i in range(cfg.num_layers))


def _structural_zero(name: str) -> bool:
    """An attention key bias (``...attn.bk``, ``...cross.bk``): its gradient
    is 0 in exact arithmetic (q . bk shifts all of a query's logits alike,
    which the softmax ignores), so each device's value is rounding noise, and
    so are the Adam steps it drives."""
    return name.endswith(".bk")


def _open_gates(model):
    """A vlm model's cross-block gates set to ``CROSS_GATE``; others as they are."""
    for cp in getattr(model, "cross_blocks", ()):
        cp.gate.data.fill_(CROSS_GATE)
    return model


@contextlib.contextmanager
def _moe_log(cfg, first: Optional[int] = None):
    """Within the block, each MoE layer routed (only the first ``first``, if
    given) logs two 0-d tensors, left on the device: ``drop``, the share of
    its (token, k) slots that capacity drops, and ``cos``, the mean over
    token groups of the squared norm of the group's mean unit router input
    (the mean cosine of two of its tokens, self-pairs included). It wraps
    ``moe.route`` and ``moe.slot_positions``, which ``apply_moe`` calls once
    each a layer."""
    from repro_torch.models import moe

    log = {"drop": [], "cos": []}
    route, slot_positions = moe.route, moe.slot_positions

    def logged_route(router, xt, top_k):
        if first is None or len(log["cos"]) < first:
            u = torch.nn.functional.normalize(xt.float(), dim=-1).mean(dim=1)
            log["cos"].append((u * u).sum(-1).mean())
        return route(router, xt, top_k)

    def logged_positions(topi, num_experts):
        pos = slot_positions(topi, num_experts)
        if first is None or len(log["drop"]) < first:
            _, t, k = topi.shape
            cap = max(1, int(cfg.capacity_factor * t * k / num_experts))
            log["drop"].append(1.0 - (pos < cap).float().mean())
        return pos

    moe.route, moe.slot_positions = logged_route, logged_positions
    try:
        yield log
    finally:
        moe.route, moe.slot_positions = route, slot_positions


def _reset_launches() -> None:
    from repro_torch.kernels import flash_attention as kflash
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)
    kflash.launches = 0           # the sum of the flash forward kernels


def _launches() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in _counters().items()}


# -- phase 2: kernels against their plain versions ---------------------------

def _check_sage(dev, gen):
    from repro_torch.core import gnn
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sage_aggregate as ksage
    from repro_torch.launch import fgl_train

    def inputs(m, n, d):
        a = (torch.rand((m, n, n), generator=gen, device=dev) < 2e-3).float()
        a = a / torch.clamp_min(a.sum(-1, keepdim=True), 1.0)   # the main path's a_norm
        return a, torch.randn((m, n, d), generator=gen, device=dev)

    def timed(adj, h, iters):
        """Kernel, plain and library ms, and the bound of the work these
        inputs need: A and H read once and the output written once, against
        2 nnz d operations at the f32 peak (the kernels run on the CUDA
        cores, so ``bound_f32_ms`` is the same bound)."""
        m, n, d = h.shape
        nnz = int((adj != 0).sum().item())
        ms = _time_ms(lambda: ksage.launch(adj, h), iters)
        plain_ms = _time_ms(lambda: ref.sage_aggregate(adj, h), iters)
        lib_ms = _time_ms(lambda: torch.bmm(adj, h) / torch.clamp_min(
            adj.sum(-1, keepdim=True), 1.0), iters)
        bound_ms, bound_by = _bound(2.0 * nnz * d, 4.0 * (m * n * n + 2 * m * n * d))
        print(f"[smoke] sage_aggregate [{m},{n},{n}]x[{m},{n},{d}] ({nnz} nonzeros) "
              f"ms={ms:.4f} plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f} "
              f"bound_ms={bound_ms:.4f} ({bound_by}) -> {ms / bound_ms:.2f}x the bound")
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "bound_f32_ms": bound_ms, "nnz": nnz,
                "shape": f"[{m},{n},{n}]x[{m},{n},{d}]"}

    def held(adj, h, what):
        """The kernel's output within 1e-4 of the plain version's (f32 sums
        of up to n terms in another order), and two calls bit for bit."""
        m, n, d = h.shape
        out = ops.sage_aggregate(adj, h)
        err = (out - ref.sage_aggregate(adj, h)).abs().max().item()
        same = torch.equal(out, ops.sage_aggregate(adj, h))
        print(f"[smoke] sage_aggregate [{m},{n},{n}]x[{m},{n},{d}] {what}max_abs_err={err:.3g}, "
              f"two calls bit for bit: {same}")
        if not err <= 1e-4:
            raise AssertionError(f"sage_aggregate disagrees with its plain version: {err}")
        if not same:
            raise AssertionError("sage_aggregate: two calls on the same inputs differ")
        return err

    # Ragged, then FedGL's Cora layers 1 and 2 (n_pad = 914, 1433 features,
    # hidden 32) and SpreadFGL's Coauthor-CS layer 2 (n_pad = 6123), which is
    # timed, with grad_h through the autograd Function where h needs a
    # gradient on the main path (layer 2). Layer 1 of Coauthor-CS, the
    # dominant shape, follows; then both layers on the main path's own
    # adjacency (SPREAD_ARGS's batch, normalised as gnn.apply_sage does).
    errs = []
    layer2 = None
    for m, n, d, with_grad in ((3, 1001, 77, True), (6, 914, 1433, False),
                               (6, 914, 32, True), (6, 6123, 32, True)):
        adj, h = inputs(m, n, d)
        errs.append(held(adj, h, ""))
        if with_grad:
            g = torch.randn_like(h)
            grads = []
            for fn in (ops.sage_aggregate, ref.sage_aggregate):
                x = h.clone().requires_grad_(True)
                torch.sum(fn(adj, x) * g).backward()
                grads.append(x.grad)
            gerr = (grads[0] - grads[1]).abs().max().item()
            print(f"[smoke] sage_aggregate grad_h [{m},{n},{d}] max_abs_err={gerr:.3g}")
            if not gerr <= 1e-4:
                raise AssertionError(f"sage_aggregate grad_h disagrees: {gerr}")
            errs.append(gerr)
            del g, grads
        if n == 6123:
            layer2 = timed(adj, h, 10)
        del adj, h

    m, n, d = 6, 6123, 6805
    adj, h = inputs(m, n, d)
    errs.append(held(adj, h, "random A "))
    layer1 = timed(adj, h, 10)
    del adj, h
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    batch, _, _ = fgl_train.build_data(fgl_train.parse(SPREAD_ARGS))
    a_norm = gnn.normalize_adjacency(torch.as_tensor(batch.adj).to(dev),
                                     torch.as_tensor(batch.node_mask).to(dev))
    row_max = int((a_norm != 0).sum(-1).max().item())
    print(f"[smoke] sage_aggregate: the main path's a_norm {list(a_norm.shape)} built in "
          f"{time.perf_counter() - t0:.1f} s (host): {int((a_norm != 0).sum().item())} "
          f"nonzeros, at most {row_max} a row")
    main_path = {"row_max": row_max}
    del batch
    for label, width in (("layer1", d), ("layer2", 32)):
        h = torch.randn((m, n, width), generator=gen, device=dev)
        errs.append(held(a_norm, h, "main path a_norm "))
        main_path[label] = timed(a_norm, h, 10)
        del h
    del a_norm
    torch.cuda.empty_cache()
    return {"name": "sage_aggregate", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sage_aggregate.cu",
            "replaces": "src/repro/kernels/sage_aggregate.py:52",
            "max_abs_err": max(errs), **layer1, "layer2": layer2, "main_path": main_path}


def _topk_err(h, vals, idx, rvals, ridx):
    """Max score error, and the largest score gap between two candidates the
    kernel and the plain version chose differently (must be a near tie)."""
    if not torch.equal(idx < 0, ridx < 0):
        raise AssertionError("sim_topk: unfilled slots differ from the plain version")
    finite = torch.isfinite(rvals)
    err = (vals[finite] - rvals[finite]).abs().max().item() if finite.any() else 0.0
    diff = (idx != ridx).nonzero()
    gap = 0.0
    if len(diff):
        b, r, _ = diff.unbind(1)
        hq = h[b, r].double()
        s_k = (hq * h[b, idx[tuple(diff.T)].long()].double()).sum(-1)
        s_r = (hq * h[b, ridx[tuple(diff.T)].long()].double()).sum(-1)
        gap = (s_k - s_r).abs().max().item()
    return err, gap, len(diff)


def _sim_inputs(gen, dev, nb, n, n_pad, c, n_local):
    """Class-probability rows, the client of each flat slot (slot // n_pad),
    95 % of each client's first n_local slots targets."""
    h = torch.softmax(3 * torch.randn((nb, n, c), generator=gen, device=dev), -1)
    slot = torch.arange(n, device=dev)
    cid = (slot // n_pad).to(torch.int32)            # client of each flat slot
    node = (torch.rand((nb, n), generator=gen, device=dev) < 0.95).float()
    return h, cid, node * ((slot % n_pad) < n_local).float()


def _check_sim(dev, gen):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sim_topk as ksim

    def inputs(*shape):
        return _sim_inputs(gen, dev, *shape)

    k = 4
    # Ragged with shifted indices; a shape whose candidate axis the kernel
    # splits into chunks whose lists it merges (on an H100, 17 chunks of 256,
    # the last holding one candidate); then the main path's shapes (12 aug
    # slots per client): FedGL on Cora, one server of 6 clients, n_pad = 914,
    # c = 7; SpreadFGL on Coauthor-CS, N = 3 servers of 2 clients,
    # n_pad = 6123, c = 15, which is timed.
    errs = []
    for (nb, n, n_pad, c, n_local), off in (((2, 1237, 400, 7, 390), 100),
                                           ((2, 4097, 1200, 15, 1190), 0),
                                           ((1, 5484, 914, 7, 902), 0),
                                           ((3, 12246, 6123, 15, 6111), 0)):
        h, cid, tmask = inputs(nb, n, n_pad, c, n_local)
        chunks, chunk_len, depth = ksim.plan(nb, n, c, k)
        vals, idx = ops.sim_topk(h, cid, tmask, k, col_offset=off)
        rvals, ridx = ref.sim_topk(h, cid, tmask, k, col_offset=off)
        unshift = lambda i: torch.where(i >= 0, i - off, i)  # noqa: E731
        err, gap, nd = _topk_err(h, vals, unshift(idx), rvals, unshift(ridx))
        print(f"[smoke] sim_topk [{nb},{n},{c}] k={k} col_offset={off} chunks={chunks} "
              f"chunk_len={chunk_len} (last chunk {n - (chunks - 1) * chunk_len}) "
              f"max_abs_err={err:.3g} idx_differ={nd} max_tie_gap={gap:.3g}")
        if not (err <= 1e-5 and gap <= 1e-5):
            raise AssertionError(f"sim_topk disagrees with its plain version: "
                                 f"err={err} tie_gap={gap}")
        errs.append(err)
    ms = _time_ms(lambda: ksim.launch(h, cid, tmask, k), 20)
    plain_ms = _time_ms(lambda: ref.sim_topk(h, cid, tmask, k), 3)

    def library():
        gram = torch.bmm(h, h.transpose(1, 2))
        keep = (cid[:, None] != cid[None, :]) & (tmask[:, None, :] > 0)
        return torch.topk(gram.masked_fill_(~keep, -math.inf), k, dim=-1)
    lib_ms = _time_ms(library, 3)
    # Two bounds: the full gram, and the pairs this run's data needs, those of
    # a row with a target of another client (no row takes its own client's
    # candidates, and no row a candidate outside the mask). Bytes: h, ids and
    # mask read once, the top-k written.
    nbytes = 4.0 * nb * n * (c + 2) + 8.0 * nb * n * k
    full_ms, _ = _bound(2.0 * nb * n * n * c, nbytes)
    cids = cid.long().expand(nb, n)
    own = torch.stack([torch.bincount(row)[row] for row in cids])  # rows of j's client
    pairs = ((tmask > 0) * (n - own)).sum().item()
    bound_ms, bound_by = _bound(2.0 * pairs * c, nbytes)
    print(f"[smoke] sim_topk main-path ms={ms:.4f} plain_ms={plain_ms:.3f} "
          f"library_ms={lib_ms:.3f} bound_ms={bound_ms:.4f} ({bound_by}, {pairs:.0f} pairs "
          f"of a row and another client's target) bound_full_gram_ms={full_ms:.4f} "
          f"chunks={chunks} chunk_len={chunk_len}")
    del h
    torch.cuda.empty_cache()
    return {"name": "sim_topk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sim_topk.cu",
            "replaces": "src/repro/kernels/sim_topk.py:136",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "bound_full_gram_ms": full_ms, "chunks": chunks,
            "shape": f"[{nb},{n},{c}] k={k}"}


def _check_sim_ring(dev, gen):
    """The ring top-k's folds at Coauthor-CS's imputation shape [3, 12246, 15],
    k = 4: the candidate axis in 2, 3 and 4 slabs, each query shard folded
    over every slab in ring order (``core.ring_topk.fold_slab``, the
    kernel's general form with a running list), as the ranks of a mesh would,
    in one process. Bit for bit the one-call kernel's result, and the plain
    version's under the tie rule. One fold timed at each slab count against
    its plain version, the library's ``bmm`` + mask + ``topk`` on the slab
    and a ``topk`` merge with the running list, and its bound (the pairs of
    a row and another client's target in the slab; bytes: both shards, ids
    and masks read once, the running list read and the result written)."""
    from repro_torch.core import ring_topk
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sim_topk as ksim

    nb, n, n_pad, c, n_local, k = 3, 12246, 6123, 15, 6111, 4
    h, cid, tmask = _sim_inputs(gen, dev, nb, n, n_pad, c, n_local)
    cid = cid.expand(nb, n)
    want_v, want_i = ksim.launch(h, cid, tmask, k)
    rv, ri = ref.sim_topk(h, cid, tmask, k)
    out = {}
    for slabs in RING_SLABS:
        shard = -(-n // slabs)
        hp = ring_topk._pad_axis(h, 1, slabs, 0.0)
        cp = ring_topk._pad_axis(cid, 1, slabs, -1)
        mp = ring_topk._pad_axis(tmask, 1, slabs, 0.0)
        part = [slice(r * shard, (r + 1) * shard) for r in range(slabs)]
        got_v, got_i = [], []
        for me in range(slabs):
            run = None
            for step in range(slabs):
                o = (me - step) % slabs
                run = ring_topk.fold_slab(run, hp[:, part[me]], cp[:, part[me]], hp[:, part[o]],
                                          cp[:, part[o]], mp[:, part[o]], k, o * shard)
                if me == 0 and step == 1:
                    run0, first = (run[0].clone(), run[1].clone()), part[o]
            got_v.append(run[0])
            got_i.append(run[1])
        got_v, got_i = torch.cat(got_v, 1)[:, :n], torch.cat(got_i, 1)[:, :n]
        if not (torch.equal(got_i, want_i) and torch.equal(got_v, want_v)):
            raise AssertionError(f"ring top-k over {slabs} slabs differs from the one-call "
                                 f"kernel")
        err, gap, nd = _topk_err(h, got_v, got_i, rv, ri)
        if not (err <= 1e-5 and gap <= 1e-5):
            raise AssertionError(f"ring top-k over {slabs} slabs disagrees with the plain "
                                 f"version: err={err} tie_gap={gap}")
        # One fold: shard 0's rows against the slab before it, with shard 0's
        # list after its first fold.
        q, qc = hp[:, part[0]], cp[:, part[0]]
        cand, cc, cm = hp[:, first], cp[:, first], mp[:, first]
        off = first.start
        ms = _time_ms(lambda: ops.sim_topk(cand, cc, cm, k, col_offset=off, rows=q,  # noqa: B023
                                           row_cid=qc, run=run0), 20)  # noqa: B023
        plain_ms = _time_ms(lambda: ref.sim_topk(cand, cc, cm, k, off, rows=q,  # noqa: B023
                                                 row_cid=qc, run=run0), 3)  # noqa: B023

        def library():
            gram = torch.bmm(q, cand.transpose(1, 2))  # noqa: B023
            keep = (qc[:, :, None] != cc[:, None, :]) & (cm[:, None, :] > 0)  # noqa: B023
            v, i = torch.topk(gram.masked_fill_(~keep, -math.inf), k, dim=-1)
            return torch.topk(torch.cat([run0[0], v], -1), k, dim=-1)  # noqa: B023
        lib_ms = _time_ms(library, 3)
        own = torch.stack([((cm[b] > 0)[None, :] & (cc[b][None, :] == qc[b][:, None])).sum(1)
                           for b in range(nb)])
        pairs = ((cm > 0).sum(1, keepdim=True) - own).clamp_min(0).sum().item()
        nbytes = 4.0 * nb * shard * (2 * c + 3) + 2 * 8.0 * nb * shard * k
        bound_ms, bound_by = _bound(2.0 * pairs * c, nbytes)
        chunks = ksim.plan(nb, shard, c, k, nq=shard)[0]
        print(f"[smoke] sim_topk ring {slabs} slabs of [{nb},{shard},{c}] k={k}: bit for bit the "
              f"one-call kernel; idx_differ_from_plain={nd} max_abs_err={err:.3g} "
              f"max_tie_gap={gap:.3g}; one fold ms={ms:.4f} plain_ms={plain_ms:.3f} "
              f"library_ms={lib_ms:.3f} bound_ms={bound_ms:.4f} ({bound_by}, {pairs:.0f} "
              f"pairs) chunks={chunks}; {slabs} folds a rank per imputation round")
        out[str(slabs)] = {"shape": f"[{nb},{shard},{c}] x [{nb},{shard},{c}] k={k}",
                           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by,
                           "folds_per_round": slabs, "max_abs_err": err}
    del h, hp
    torch.cuda.empty_cache()
    return out


def _check_flash(dev, gen):
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ops, ref

    def inputs(b, hq, hkv, sq, skv, d, dtype):
        return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))

    # f32 (3-pass TF32 route): ragged with a window (gemma3's local layers)
    # and GQA 2:1; a 40-token prompt, the shape the reference's ops.mha gets
    # wrong.
    # bf16 (tensor-core route): MQA at D = 128; one query against a ragged
    # cache with GQA 4:1 at D = 64; more queries than keys with a window at
    # D = 32; then the serving main path's prefill, Qwen3-4B as configured (32
    # q heads, 8 kv heads, head dim 80) at batch 8 and 2048 tokens. Limits:
    # f32 1e-5 (both sides compute in f32); bf16 2e-2 (P is rounded to bf16
    # before P V, and a bf16 output may round the other way).
    errs = {torch.float32: [], torch.bfloat16: []}
    for b, hq, hkv, sq, skv, d, window, dtype in (
            (2, 4, 2, 200, 200, 32, 64, torch.float32),
            (2, 4, 2, 40, 40, 32, None, torch.float32),
            (1, 8, 1, 300, 300, 128, None, torch.bfloat16),
            (1, 8, 2, 1, 1000, 64, None, torch.bfloat16),
            (1, 4, 2, 130, 100, 32, 50, torch.bfloat16),
            (8, 32, 8, 2048, 2048, 80, None, torch.bfloat16)):
        q, k, v = inputs(b, hq, hkv, sq, skv, d, dtype)
        route = "launches_tc" if dtype == torch.bfloat16 else "launches_f32"
        before = getattr(kflash, route)
        out = ops.mha(q, k, v, causal=True, window=window).float()
        if getattr(kflash, route) != before + 1:
            raise AssertionError(f"flash_attention {dtype} did not take its route ({route})")
        plain = ref.flash_attention(q, k, v, causal=True, window=window).float()
        err = (out - plain).abs().max().item()
        limit = 1e-5 if dtype == torch.float32 else 2e-2
        print(f"[smoke] flash_attention {route[9:]} q[{b},{hq},{sq},{d}] "
              f"kv[{b},{hkv},{skv},{d}] window={window} {str(dtype).split('.')[-1]} "
              f"max_abs_err={err:.3g} (limit {limit:g})")
        if not err <= limit:
            raise AssertionError(f"flash_attention disagrees with its plain version: {err}")
        errs[dtype].append(err)
        del out, plain
    main_shape = (b, hq, hkv, sq, skv, d)
    # Causal work only (query i sees i + 1 keys); bytes: q and the output at
    # Hq heads, k and v at Hkv heads, in the inputs' type. The f32 route runs
    # three TF32 passes of that work: its bound is theirs at the TF32 peak,
    # beside that of one f32 pass on the CUDA cores.
    flops = 4.0 * b * hq * d * (sq * (sq + 1) / 2)
    io = 2 * b * hq * sq * d + 2 * b * hkv * skv * d
    entries = []
    for dtype, source in ((torch.bfloat16, "flash_attention_tc.cu"),
                          (torch.float32, "flash_attention.cu")):
        name = str(dtype).split(".")[-1]
        if dtype == torch.float32:
            # The f32 route at the same shape, from f32 draws (bf16 values
            # would make the split exact), held to 1e-5 before it is timed.
            q, k, v = inputs(b, hq, hkv, sq, skv, d, dtype)
            err = (ops.mha(q, k, v, causal=True) - ref.flash_attention(q, k, v)).abs().max().item()
            print(f"[smoke] flash_attention f32 q[{b},{hq},{sq},{d}] kv[{b},{hkv},{skv},{d}] "
                  f"window=None float32 max_abs_err={err:.3g} (limit 1e-05)")
            if not err <= 1e-5:
                raise AssertionError(f"flash_attention disagrees with its plain version: {err}")
            errs[dtype].append(err)
            route = "tensor cores, 3 TF32 passes"
            bound_ms, bound_by = _bound(3 * flops, 4 * io, peak=TF32_FLOPS)
            extra = {"bound_f32_ms": _bound(flops, 4 * io)[0]}
            bound_note = (f"({bound_by}, 3 TF32 passes at {TF32_FLOPS / 1e12:.0f} TFLOP/s) "
                          f"bound_f32_ms={extra['bound_f32_ms']:.4f}")
        else:
            route = "tensor cores"
            bound_ms, bound_by = _bound(flops, 2 * io, peak=BF16_FLOPS)
            extra = {}
            bound_note = f"({bound_by}, bf16 peak {BF16_FLOPS / 1e12:.0f} TFLOP/s)"
        ms = _time_ms(lambda: kflash.launch(q, k, v), 10)
        lse_ms = _time_ms(lambda: kflash.launch(q, k, v, with_lse=True), 10)
        plain_ms = _time_ms(lambda: ref.flash_attention(q, k, v), 3)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                 enable_gqa=True), 10)
        print(f"[smoke] flash_attention {route} {name} main-path ms={ms:.3f} "
              f"(with the training path's row log-sum-exp {lse_ms:.3f}) "
              f"plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f} bound_ms={bound_ms:.4f} "
              f"{bound_note} -> {flops / ms / 1e9:.1f} TFLOP/s")
        entries.append({"name": f"flash_attention ({name}, {route})", "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{source}",
                        "replaces": "src/repro/kernels/flash_attention.py:98",
                        "max_abs_err": max(errs[dtype]), "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                        "ms_with_lse": lse_ms, **extra,
                        "shape": "q[{0},{1},{3},{5}] kv[{0},{2},{4},{5}] ".format(*main_shape)
                                 + f"{name} causal"})
    del q, k, v
    torch.cuda.empty_cache()
    entries[1]["cases"] = [_check_flash_f32_main(dev, gen)]
    return entries


# The f32 route's launches on the main paths all run at one shape: the f32
# Qwen3-4B prefill (36 a prefill, without the row log-sum-exp) and training
# step (72 a step, with it), batch 2 x 2048, 32 q heads, 8 kv heads of 80.
F32_MAIN_SHAPE = (2, 32, 8, 2048, 80)


def _check_flash_f32_main(dev, gen):
    """The f32 forward at the main paths' own shape (``F32_MAIN_SHAPE``):
    the output within 1e-5 of the plain version and the row log-sum-exp
    within 1e-5, two calls bit for bit; timed without the log-sum-exp (the
    prefill's call) and with it (the training step's) against the plain
    version, SDPA in f32 (TF32 off) and the bound of three TF32 passes of
    the causal work at the TF32 peak. Returns the entry's case."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref

    b, hq, hkv, s, d = F32_MAIN_SHAPE
    q = torch.randn((b, hq, s, d), generator=gen, device=dev)
    k, v = (torch.randn((b, hkv, s, d), generator=gen, device=dev) for _ in range(2))
    o, lse = kflash.launch(q, k, v, with_lse=True)
    again, lse_again = kflash.launch(q, k, v, with_lse=True)
    same = torch.equal(o, again) and torch.equal(lse, lse_again)
    err = (o - ref.flash_attention(q, k, v)).abs().max().item()
    lse_err = (lse - ref.flash_attention_lse(q, k)).abs().max().item()
    del o, lse, again, lse_again
    shape = f"q[{b},{hq},{s},{d}] kv[{b},{hkv},{s},{d}] f32 causal"
    print(f"[smoke] flash_attention f32 main paths' shape {shape}: output max_abs_err "
          f"{err:.3g} (limit 1e-05); lse max_abs_err {lse_err:.3g} (limit 1e-05); two calls "
          f"bit for bit: {same}")
    if not (err <= 1e-5 and lse_err <= 1e-5 and same):
        raise AssertionError(f"flash_attention f32 at {shape}: output {err}, lse {lse_err}, "
                             f"bit for bit {same}")
    flops = 4.0 * d * b * hq * _causal_pairs(s, s, None)
    io = 2 * b * hq * s * d + 2 * b * hkv * s * d
    ms = _time_ms(lambda: kflash.launch(q, k, v), 20)
    lse_ms = _time_ms(lambda: kflash.launch(q, k, v, with_lse=True), 20)
    plain_ms = _time_ms(lambda: ref.flash_attention(q, k, v), 3)
    lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                             enable_gqa=True), 20)
    bound_ms, bound_by = _bound(3 * flops, 4 * io, peak=TF32_FLOPS)
    print(f"[smoke] flash_attention f32 (3 TF32 passes) main paths' shape {shape}: "
          f"ms={ms:.4f} (with the row log-sum-exp {lse_ms:.4f}) plain_ms={plain_ms:.3f} "
          f"library_ms={lib_ms:.3f} (SDPA f32) bound_ms={bound_ms:.4f} ({bound_by}, 3 TF32 "
          f"passes at {TF32_FLOPS / 1e12:.0f} TFLOP/s) -> {bound_ms / ms:.2f} of the bound")
    del q, k, v
    torch.cuda.empty_cache()
    return {"what": "the main paths' shape (f32 Qwen3-4B prefill and training)", "shape": shape,
            "max_abs_err": err, "lse_max_abs_err": lse_err, "ms": ms, "ms_with_lse": lse_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def _causal_pairs(sq: int, skv: int, window) -> float:
    """(query, key) pairs a causal, end-aligned, optionally windowed head sees."""
    qpos = torch.arange(sq, dtype=torch.float64) + (skv - sq)
    seen = torch.clamp(qpos + 1, 0, skv)
    if window:
        seen = torch.clamp(seen, max=window)
    return seen.sum().item()


def _plain_by_head(fn, q, *rest, **kw):
    """``fn`` (a plain attention version) run per batch row and kv head and
    concatenated: the same function on the same inputs, with the plain
    version's f32 logits held to one kv group at a time."""
    b, hq = q.shape[:2]
    hkv = rest[0].shape[1]
    grp = hq // hkv
    outs = [[fn(q[i:i + 1, h * grp:(h + 1) * grp], *(t[i:i + 1, h:h + 1] for t in rest), **kw)
             for h in range(hkv)] for i in range(b)]
    return torch.cat([torch.cat(row, dim=1) for row in outs], dim=0)


# The bf16 forward at the MoE and vlm paths' head dim, D = 128: OLMoE's
# prefill (MHA), Llama-3.2-Vision's (GQA 4:1) and Mixtral's (window 4096).
D128_CASES = (("OLMoE-1B-7B prefill", 8, 16, 16, 2048, 128, None),
              ("Llama-3.2-Vision-11B prefill", 8, 32, 8, 2048, 128, None),
              ("Mixtral-8x7B prefill", 2, 32, 8, 8192, 128, 4096))
# At the audio and hybrid paths' head dim, D = 64: Hymba's prefill (GQA 25:5,
# a group of 5) on its windowed layers (1024) and its global ones, and
# Whisper's decoder prompt (MHA, no RoPE: the kernel sees q, k, v alike).
D64_CASES = (("Hymba-1.5B prefill, windowed layers", 8, 25, 5, 2048, 64, 1024),
             ("Hymba-1.5B prefill, global layers", 8, 25, 5, 2048, 64, None),
             ("Whisper-medium decoder prefill", 8, 16, 16, 224, 64, None))
# At gemma3-12b's head dim, D = 240: its prefill (GQA 16:8) on its global
# layers and its local ones (window 1024).
D240_CASES = (("Gemma3-12B prefill, global layers", 8, 16, 8, 2048, 240, None),
              ("Gemma3-12B prefill, local layers", 8, 16, 8, 2048, 240, 1024))


def _check_flash_cases(dev, gen, shapes):
    """The bf16 forward at each of ``shapes`` (what, b, hq, hkv, s, d,
    window), each held against the plain version (run per batch row and kv
    head) within 2e-2 and timed against SDPA (for a window, with a boolean
    mask and k, v repeated to the q heads) and its bound: the causal
    (windowed) pairs' two products at the bf16 peak, or q, k, v and the
    output read and written once."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ops, ref

    cases = []
    for what, b, hq, hkv, s, d, window in shapes:
        q = torch.randn((b, hq, s, d), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((b, hkv, s, d), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        before = kflash.launches_tc
        out = ops.mha(q, k, v, causal=True, window=window)
        if kflash.launches_tc != before + 1:
            raise AssertionError("flash_attention bf16 did not take its route (launches_tc)")
        plain = _plain_by_head(ref.flash_attention, q, k, v, causal=True, window=window)
        err = (out.float() - plain.float()).abs().max().item()
        del out, plain
        ms = _time_ms(lambda: kflash.launch(q, k, v, window=window), 10)
        plain_ms = _time_ms(lambda: _plain_by_head(ref.flash_attention, q, k, v, causal=True,
                                                   window=window), 1)
        if window:      # SDPA's masked kernel takes no GQA: k, v repeated beforehand
            pos = torch.arange(s, device=dev)
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
            kr, vr = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
            lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask),
                              10)
            del kr, vr, mask
        else:
            lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), 10)
        flops = 4.0 * d * b * hq * _causal_pairs(s, s, window)
        bound_ms, bound_by = _bound(flops, 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d),
                                    peak=BF16_FLOPS)
        shape = f"q[{b},{hq},{s},{d}] kv[{b},{hkv},{s},{d}] bf16 causal" + (
            f" window {window}" if window else "")
        print(f"[smoke] flash_attention tensor cores bf16 {what} {shape}: max_abs_err={err:.3g} "
              f"(limit 2e-2) ms={ms:.3f} plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f} "
              f"bound_ms={bound_ms:.4f} ({bound_by}, bf16 peak) -> "
              f"{flops / ms / 1e9:.1f} TFLOP/s")
        if not err <= 2e-2:
            raise AssertionError(f"flash_attention at D = {d} ({what}) disagrees with its plain "
                                 f"version: {err}")
        cases.append({"what": what, "shape": shape, "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": lib_ms})
        del q, k, v
        torch.cuda.empty_cache()
    return cases


def _check_sim_block(dev, gen):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sim_topk as ksim

    # Ragged f32 from a normal; then class-probability rows (softmax), the
    # data sim_block's callers hold: ragged in bf16, and the Coauthor-CS
    # server's gram (12246 flat slots x 15 classes, the A̅ = H Hᵀ that
    # sim_topk fuses away) in bf16 and f32, the latter timed. The rule is the
    # JAX tests': |d| <= tol * (1 + |plain|), tol 1e-5 (f32) or 3e-2 (bf16).
    errs = []
    for b, n, c, dtype, probs in ((33, 70, 7, torch.float32, False),
                                  (1000, 1237, 15, torch.bfloat16, True),
                                  (12246, 12246, 15, torch.bfloat16, True),
                                  (12246, 12246, 15, torch.float32, True)):
        rows, h = (torch.randn(shape, generator=gen, device=dev)
                   for shape in ((b, c), (n, c)))
        if probs:
            rows, h = torch.softmax(3 * rows, -1), torch.softmax(3 * h, -1)
        rows, h = rows.to(dtype), h.to(dtype)
        before = ksim.block_launches
        out = ops.sim_block(rows, h).float()
        if ksim.block_launches != before + 1:
            raise AssertionError("sim_block did not launch its kernel")
        plain = ref.sim_block(rows, h).float()
        diff = (out - plain).abs()
        tol = 1e-5 if dtype == torch.float32 else 3e-2
        excess = (diff - tol * (1 + plain.abs())).max().item()
        err = diff.max().item()
        print(f"[smoke] sim_block [{b},{c}]x[{n},{c}] {str(dtype).split('.')[-1]} "
              f"max_abs_err={err:.3g} (limit {tol:g} x (1 + |plain|))")
        if not excess <= 0:
            raise AssertionError(f"sim_block disagrees with its plain version: {err}")
        errs.append(err)
        del out, plain, diff
    ms = _time_ms(lambda: ksim.launch_block(rows, h), 20)
    plain_ms = _time_ms(lambda: ref.sim_block(rows, h), 5)
    lib_ms = _time_ms(lambda: rows @ h.T, 20)
    bound_ms, bound_by = _bound(2.0 * b * n * c, 4.0 * (b * c + n * c + b * n))
    print(f"[smoke] sim_block [{b},{c}]x[{n},{c}] f32 ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) -> "
          f"{4.0 * b * n / ms / 1e9:.2f} TB/s of output")
    del rows, h
    torch.cuda.empty_cache()
    return {"name": "sim_block", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sim_block.cu",
            "replaces": "src/repro/kernels/sim_topk.py:184",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "shape": f"[{b},{c}]x[{n},{c}] f32"}


def _check_flash_bwd(dev, gen):
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref

    # The training path's two kernels: the forward keeping each row's
    # log-sum-exp (in bf16 a kernel of its own, flash_attention_tc_lse_kernel)
    # and the backward (bf16 by wgmma fed by TMA, f32 by three TF32 passes). A
    # windowed GQA case, then the training shape (Qwen3-4B as configured,
    # batch 2 x 2048), each in f32 and in bf16; each route is timed at the
    # training shape, the f32 one on f32 draws (bf16 values would make the
    # split exact). Limits: the forward's output as _check_flash's (f32 1e-5,
    # bf16 2e-2) and its row log-sum-exp within 1e-5 of the plain one
    # (logsumexp of the plain logits); f32 gradients within 1e-5 of each
    # tensor's max |grad| of the plain formula in float64, or within the
    # plain f32 version's own error against it where that is larger; bf16
    # within 2e-2 of max |grad| of the plain version; a second run bit for bit
    # equal to the first.
    def timed(q, k, v, o, do, lse):
        """Kernel, plain and library ms of the backward, and its bounds: the
        five products the gradient needs (S, dP, dQ, dK, dV) over the causal
        pairs, and the seven the kernels compute (S and dP again in the dQ
        kernel, which needs no atomics), at the bf16 peak, or for f32 in three
        TF32 passes at the TF32 peak (beside one f32 pass on the CUDA cores);
        bytes: q, k, v, O, dO and L read once, dQ, dK, dV written once. The
        library call is SDPA's backward through autograd (f32 without TF32)."""
        b, hq, sq, d = q.shape
        hkv, skv = k.shape[1], k.shape[2]
        pairs = b * hq * (sq * (sq + 1) / 2)
        ms = _time_ms(lambda: kflash.launch_bwd(q, k, v, o, do, lse), 10)
        plain_ms = _time_ms(lambda: ref.flash_attention_bwd(q, k, v, o, do, lse), 3)
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
        lib_ms = _time_ms(lambda: torch.autograd.grad(sdpa, (qg, kg, vg), do,
                                                      retain_graph=True), 10)
        del sdpa, qg, kg, vg
        flops = 10.0 * d * pairs
        nbytes = q.element_size() * (4 * b * hq * sq * d + 4 * b * hkv * skv * d) + 4 * b * hq * sq
        f32 = q.dtype == torch.float32
        passes, peak = (3, TF32_FLOPS) if f32 else (1, BF16_FLOPS)
        bound_ms, bound_by = _bound(passes * flops, nbytes, peak=peak)
        bound7_ms, _ = _bound(passes * 1.4 * flops, nbytes, peak=peak)
        extra = {"bound_f32_ms": _bound(flops, nbytes)[0]} if f32 else {}
        route = "3-pass TF32" if f32 else "tensor cores"
        name = "f32" if f32 else "bf16"
        print(f"[smoke] flash_attention backward {name} ({route}) main-path ms={ms:.3f} "
              f"plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f} (SDPA backward) "
              f"bound_ms={bound_ms:.4f} ({bound_by}, {passes} x {flops / 1e9:.1f} GFLOP of "
              f"five products at {peak / 1e12:.0f} TFLOP/s) bound_7_products_ms={bound7_ms:.4f}"
              + (f" bound_f32_cuda_cores_ms={extra['bound_f32_ms']:.4f}" if f32 else "")
              + f" -> {flops / ms / 1e9:.1f} TFLOP/s of five products, "
              f"{1.4 * flops / ms / 1e9:.1f} of seven")
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "bound_7_products_ms": bound7_ms, **extra,
                "shape": f"q[{b},{hq},{sq},{d}] kv[{b},{hkv},{skv},{d}] {name} causal"}

    def timed_lse_forward(q, k, v):
        """The bf16 training forward: its plain version computes the output
        and the row log-sum-exp; the library's is SDPA's forward on inputs
        that need a gradient (it keeps its own log-sum-exp for the
        backward). Bound: the two products over the causal pairs; q, k, v
        read and the output written in bf16, the log-sum-exp in f32."""
        b, hq, sq, d = q.shape
        hkv, skv = k.shape[1], k.shape[2]
        ms = _time_ms(lambda: kflash.launch(q, k, v, with_lse=True), 10)
        plain_ms = _time_ms(lambda: (ref.flash_attention(q, k, v),
                                     ref.flash_attention_lse(q, k)), 3)
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            qg, kg, vg, is_causal=True, enable_gqa=True), 10)
        flops = 4.0 * d * b * hq * (sq * (sq + 1) / 2)
        nbytes = 2 * (2 * b * hq * sq * d + 2 * b * hkv * skv * d) + 4 * b * hq * sq
        bound_ms, bound_by = _bound(flops, nbytes, peak=BF16_FLOPS)
        shape = f"q[{b},{hq},{sq},{d}] kv[{b},{hkv},{skv},{d}] bf16 causal"
        print(f"[smoke] flash_attention training forward bf16 {shape} ms={ms:.3f} "
              f"plain_ms={plain_ms:.3f} library_ms={lib_ms:.3f} (SDPA forward needing a "
              f"gradient) bound_ms={bound_ms:.4f} ({bound_by}, bf16 peak) -> "
              f"{flops / ms / 1e9:.1f} TFLOP/s")
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "shape": shape}

    # Beside Qwen3-4B's shapes, OLMoE-1B-7B's training shape in bf16 (batch
    # 2 x 2048, 16 heads of 128, MHA): its forward and backward are each
    # timed too, as cases of their entries.
    errs = {"fwd": [], torch.float32: [], torch.bfloat16: []}
    times, d128 = {}, {}
    for b, hq, hkv, sq, skv, d, window, dtype in (
            (1, 8, 2, 1000, 1000, 64, 100, torch.float32),
            (1, 8, 2, 1000, 1000, 64, 100, torch.bfloat16),
            (2, 32, 8, 2048, 2048, 80, None, torch.float32),
            (2, 16, 16, 2048, 2048, 128, None, torch.bfloat16),
            (2, 32, 8, 2048, 2048, 80, None, torch.bfloat16)):
        q = torch.randn((b, hq, sq, d), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((b, hkv, skv, d), generator=gen, device=dev).to(dtype)
                for _ in range(2))
        do = torch.randn((b, hq, sq, d), generator=gen, device=dev).to(dtype)
        route = "launches_tc_lse" if dtype == torch.bfloat16 else "launches_f32"
        bwd_route = "launches_bwd_tc" if dtype == torch.bfloat16 else "launches_bwd_f32"
        before = getattr(kflash, route)
        o, lse = kflash.launch(q, k, v, window=window, with_lse=True)
        if getattr(kflash, route) != before + 1:
            raise AssertionError(f"flash_attention {dtype} with its row log-sum-exp did not "
                                 f"take its kernel ({route})")
        bwd_before = getattr(kflash, bwd_route)
        o_err = (o.float() - ref.flash_attention(q, k, v, window=window).float()
                 ).abs().max().item()
        o_limit = 1e-5 if dtype == torch.float32 else 2e-2
        lse_err = (lse - ref.flash_attention_lse(q, k, window=window)).abs().max().item()
        got = kflash.launch_bwd(q, k, v, o, do, lse, window=window)
        again = kflash.launch_bwd(q, k, v, o, do, lse, window=window)
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        del again
        if getattr(kflash, bwd_route) != bwd_before + 2:
            raise AssertionError(f"flash_attention backward {dtype} did not take its kernel "
                                 f"({bwd_route})")
        plain = ref.flash_attention_bwd(q, k, v, o, do, lse, window=window)
        exact = (ref.flash_attention_bwd(*(t.double() for t in (q, k, v, o, do, lse)),
                                         window=window)
                 if dtype == torch.float32 else plain)
        name = str(dtype).split(".")[-1]
        line = []
        for gname, g, p, e in zip(("dq", "dk", "dv"), got, plain, exact):
            scale = e.abs().max().item()
            err = (g.double() - e.double()).abs().max().item()
            if dtype == torch.float32:
                own = (p.double() - e).abs().max().item()
                limit = max(1e-5 * scale, own)
                line.append(f"{gname} {err:.3g} (limit {limit:.3g}: plain's own {own:.3g})")
            else:
                limit = 2e-2 * scale
                line.append(f"{gname} {err:.3g} (limit {limit:.3g})")
            if not err <= limit:
                raise AssertionError(f"flash_attention backward {name} {gname} disagrees "
                                     f"with its plain version: {err} > {limit}")
            errs[dtype].append(err)
        print(f"[smoke] flash_attention training forward q[{b},{hq},{sq},{d}] "
              f"kv[{b},{hkv},{skv},{d}] window={window} {name} ({route[9:]}): output "
              f"max_abs_err {o_err:.3g} (limit {o_limit:g}); lse max_abs_err {lse_err:.3g} "
              f"(limit 1e-05)")
        print(f"[smoke] flash_attention backward q[{b},{hq},{sq},{d}] kv[{b},{hkv},{skv},{d}] "
              f"window={window} {name} ({bwd_route[9:]}): max_abs_err {'; '.join(line)}; two "
              f"runs bit for bit: {same}")
        if not o_err <= o_limit:
            raise AssertionError(f"flash_attention {name} with its row log-sum-exp: output "
                                 f"disagrees with its plain version by {o_err}")
        if not lse_err <= 1e-5:
            raise AssertionError(f"flash_attention {name}: row log-sum-exp off by {lse_err}")
        if not same:
            raise AssertionError("flash_attention backward: two runs differ")
        if dtype == torch.bfloat16:
            errs["fwd"].append(o_err)
        del got, plain, exact
        if d == 128:            # OLMoE's training shape: a case of each entry
            d128["bwd"] = dict(timed(q, k, v, o, do, lse), what="OLMoE-1B-7B training",
                               max_abs_err=max(errs[dtype][-3:]))
            d128["fwd"] = dict(timed_lse_forward(q, k, v), what="OLMoE-1B-7B training",
                               max_abs_err=o_err)
        elif sq == 2048:        # the training shape: each route timed
            times[dtype] = timed(q, k, v, o, do, lse)
        if dtype == torch.float32 or d == 128:
            del q, k, v, o, do, lse
        torch.cuda.empty_cache()

    fwd = timed_lse_forward(q, k, v)
    del q, k, v, o, do, lse
    torch.cuda.empty_cache()
    bwd = "src/repro_torch/kernels/csrc/"
    replaces = "src/repro/kernels/flash_attention.py:98 (no VJP: a new kernel)"
    return [{"name": "flash_attention (bf16, tensor cores, keeping the row log-sum-exp)",
             "route": "cuda", "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
             "replaces": "src/repro/kernels/flash_attention.py:98",
             "max_abs_err": max(errs["fwd"]), **fwd, "cases": [d128["fwd"]]},
            {"name": "flash_attention_bwd (bf16, tensor cores)", "route": "cuda",
             "source": bwd + "flash_attention_bwd_tc.cu", "replaces": replaces,
             "max_abs_err": max(errs[torch.bfloat16]), **times[torch.bfloat16],
             "cases": [d128["bwd"]]},
            {"name": "flash_attention_bwd (f32, tensor cores, 3 TF32 passes)", "route": "cuda",
             "source": bwd + "flash_attention_bwd.cu", "replaces": replaces,
             "max_abs_err": max(errs[torch.float32]), **times[torch.float32]}]


# The training path's forward (keeping the row log-sum-exp) and backward at
# the hybrid and audio paths' shapes: Hymba's (batch 2 x 2048, GQA 25:5,
# window 1024) and Whisper's decoder (batch 8 x 448, MHA).
D64_TRAIN_CASES = (("Hymba-1.5B training", 2, 25, 5, 2048, 64, 1024),
                   ("Whisper-medium decoder training", 8, 16, 16, 448, 64, None))
# And at gemma3-12b's training shape (batch 2 x 2048, GQA 16:8), on its local
# layers (window 1024) and its global ones: in bf16 (these cases), and in f32
# on the 3-pass TF32 routes (D240_F32_CASES, _check_flash_f32_cases).
D240_TRAIN_CASES = (("Gemma3-12B training, local layers", 2, 16, 8, 2048, 240, 1024),
                    ("Gemma3-12B training, global layers", 2, 16, 8, 2048, 240, None))
D240_F32_CASES = (("Gemma3-12B training, global layers", 2, 16, 8, 2048, 240, None),)
# The f32 routes at Whisper's decoder training shape (batch 8 x 448, MHA).
D64_F32_CASES = (("Whisper-medium decoder training", 8, 16, 16, 448, 64, None),)
# hymba-1.5b's smoke config (the examples' serve_lm): head dim 20, which no
# kernel instance has, so q, k, v (and o, dO) go zero-padded to the next, 32
# (``flash_attention.at_kernel_head_dim``); its windowed layers (window 64,
# its smoke window) and its global ones, 5 heads over 1 kv head, 128 tokens.
# Every kernel holds them: the bf16 forward (_check_flash_cases), the bf16
# training forward and backward (_check_flash_train_cases), the f32 ones
# (_check_flash_f32_cases).
D20_CASES = (("Hymba-1.5B smoke, windowed layers", 2, 5, 1, 128, 20, 64),
             ("Hymba-1.5B smoke, global layers", 2, 5, 1, 128, 20, None))


def _check_flash_train_cases(dev, gen, shapes):
    """The bf16 training forward and backward at each of ``shapes`` (what,
    b, hq, hkv, s, d, window), with _check_flash_bwd's limits: the output
    within 2e-2 of the plain version, the row log-sum-exp within 1e-5, each
    gradient within 2e-2 of its max |grad| of the plain backward, a second
    run bit for bit equal. Each is timed against SDPA (with a boolean mask
    and k, v repeated to the q heads for a window; its backward through
    autograd) and its bound over the causal (windowed) pairs: two products
    (forward) or five (backward) at the bf16 peak, or the bytes read and
    written once. Returns (forward cases, backward cases)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref

    fwd_cases, bwd_cases = [], []
    for what, b, hq, hkv, s, d, window in shapes:
        q, do = (torch.randn((b, hq, s, d), generator=gen, device=dev).to(torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn((b, hkv, s, d), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        before = (kflash.launches_tc_lse, kflash.launches_bwd_tc)
        o, lse = kflash.launch(q, k, v, window=window, with_lse=True)
        got = kflash.launch_bwd(q, k, v, o, do, lse, window=window)
        again = kflash.launch_bwd(q, k, v, o, do, lse, window=window)
        if (kflash.launches_tc_lse, kflash.launches_bwd_tc) != (before[0] + 1, before[1] + 2):
            raise AssertionError("flash_attention bf16 training kernels did not take their "
                                 "routes (launches_tc_lse, launches_bwd_tc)")
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        del again
        o_err = (o.float() - ref.flash_attention(q, k, v, window=window).float()
                 ).abs().max().item()
        lse_err = (lse - ref.flash_attention_lse(q, k, window=window)).abs().max().item()
        plain = ref.flash_attention_bwd(q, k, v, o, do, lse, window=window)
        errs, line = [], []
        for gname, g, p in zip(("dq", "dk", "dv"), got, plain):
            limit = 2e-2 * p.float().abs().max().item()
            err = (g.float() - p.float()).abs().max().item()
            line.append(f"{gname} {err:.3g} (limit {limit:.3g})")
            if not err <= limit:
                raise AssertionError(f"flash_attention backward bf16 ({what}) {gname} "
                                     f"disagrees with its plain version: {err} > {limit}")
            errs.append(err)
        del got, plain
        shape = f"q[{b},{hq},{s},{d}] kv[{b},{hkv},{s},{d}] bf16 causal" + (
            f" window {window}" if window else "")
        print(f"[smoke] flash_attention training forward {what} {shape}: output max_abs_err "
              f"{o_err:.3g} (limit 0.02); lse max_abs_err {lse_err:.3g} (limit 1e-05); "
              f"backward max_abs_err {'; '.join(line)}; two runs bit for bit: {same}")
        if not (o_err <= 2e-2 and lse_err <= 1e-5 and same):
            raise AssertionError(f"flash_attention training kernels at {what}: output {o_err}, "
                                 f"lse {lse_err}, bit for bit {same}")

        qg = q.detach().requires_grad_(True)
        if window:      # SDPA's masked kernel takes no GQA: k, v repeated beforehand
            pos = torch.arange(s, device=dev)
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
            kg, vg = (t.repeat_interleave(hq // hkv, dim=1).requires_grad_(True)
                      for t in (k, v))
            sdpa = lambda: F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)  # noqa: E731
        else:
            kg, vg = k.detach().requires_grad_(True), v.detach().requires_grad_(True)
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qg, kg, vg, is_causal=True, enable_gqa=True)
        pairs = b * hq * _causal_pairs(s, s, window)
        io = 2 * b * hq * s * d + 2 * b * hkv * s * d
        fwd_ms = _time_ms(lambda: kflash.launch(q, k, v, window=window, with_lse=True), 10)
        fwd_plain = _time_ms(lambda: (ref.flash_attention(q, k, v, window=window),
                                      ref.flash_attention_lse(q, k, window=window)), 3)
        fwd_lib = _time_ms(sdpa, 10)
        fwd_bound, fwd_by = _bound(4.0 * d * pairs, 2 * io + 4 * b * hq * s, peak=BF16_FLOPS)
        bwd_ms = _time_ms(lambda: kflash.launch_bwd(q, k, v, o, do, lse, window=window), 10)
        bwd_plain = _time_ms(lambda: ref.flash_attention_bwd(q, k, v, o, do, lse,
                                                             window=window), 3)
        out = sdpa()
        bwd_lib = _time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                                       retain_graph=True), 10)
        bwd_bound, bwd_by = _bound(10.0 * d * pairs, 2 * (2 * io) + 4 * b * hq * s,
                                   peak=BF16_FLOPS)
        print(f"[smoke] flash_attention training forward bf16 {what} {shape}: ms={fwd_ms:.3f} "
              f"plain_ms={fwd_plain:.3f} library_ms={fwd_lib:.3f} (SDPA forward needing a "
              f"gradient) bound_ms={fwd_bound:.4f} ({fwd_by}, bf16 peak); backward "
              f"ms={bwd_ms:.3f} plain_ms={bwd_plain:.3f} library_ms={bwd_lib:.3f} (SDPA "
              f"backward) bound_ms={bwd_bound:.4f} ({bwd_by}, five products at the bf16 "
              f"peak) -> {10.0 * d * pairs / bwd_ms / 1e9:.1f} TFLOP/s of five products")
        fwd_cases.append({"what": what, "shape": shape, "max_abs_err": o_err, "ms": fwd_ms,
                          "plain_ms": fwd_plain, "bound_ms": fwd_bound, "bound_by": fwd_by,
                          "library_ms": fwd_lib})
        bwd_cases.append({"what": what, "shape": shape, "max_abs_err": max(errs), "ms": bwd_ms,
                          "plain_ms": bwd_plain, "bound_ms": bwd_bound, "bound_by": bwd_by,
                          "library_ms": bwd_lib})
        del q, k, v, o, do, lse, qg, kg, vg, out
        torch.cuda.empty_cache()
    return fwd_cases, bwd_cases


def _check_flash_f32_cases(dev, gen, shapes):
    """The f32 route's forward (keeping the row log-sum-exp) and backward at
    each of ``shapes`` (what, b, hq, hkv, s, d, window; causal), from f32
    draws, with _check_flash_bwd's limits: the output within 1e-5 of the
    plain version, the row log-sum-exp within 1e-5, each gradient within
    1e-5 of its max |grad| of the plain formula in float64 (or within the
    plain f32 version's own error against it, where that is larger), a
    second backward bit for bit. Each pass is timed (the forward as serving
    calls it, without the log-sum-exp, and with it) against SDPA in f32
    without TF32 (for a window, with a boolean mask and k, v repeated to the
    q heads; its backward through autograd) and the bound of three TF32
    passes of its products over the causal (windowed) pairs, two forward
    and five backward, at the TF32 peak, beside one f32 pass on the CUDA
    cores. Returns (forward cases, backward cases)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref

    def sdpa_of(q, k, v, window, grad=False):
        """SDPA on these inputs as a call, and its inputs (leaves needing a
        gradient where ``grad``): for a window, k and v repeated to the q
        heads and the boolean mask made beforehand."""
        if window:      # SDPA's masked kernel takes no GQA
            k, v = (t.repeat_interleave(q.shape[1] // k.shape[1], dim=1) for t in (k, v))
        q, k, v = (t.detach().requires_grad_(grad) for t in (q, k, v))
        if not window:
            return (lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                           enable_gqa=True)), (q, k, v)
        pos = torch.arange(q.shape[2], device=q.device)
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        return (lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)), (q, k, v)

    fwd_cases, bwd_cases = [], []
    for what, b, hq, hkv, s, d, window in shapes:
        q, do = (torch.randn((b, hq, s, d), generator=gen, device=dev) for _ in range(2))
        k, v = (torch.randn((b, hkv, s, d), generator=gen, device=dev) for _ in range(2))
        before = (kflash.launches_f32, kflash.launches_bwd_f32)
        o, lse = kflash.launch(q, k, v, window=window, with_lse=True)
        got = kflash.launch_bwd(q, k, v, o, do, lse, window=window)
        again = kflash.launch_bwd(q, k, v, o, do, lse, window=window)
        if (kflash.launches_f32, kflash.launches_bwd_f32) != (before[0] + 1, before[1] + 2):
            raise AssertionError("flash_attention f32 training kernels did not take their "
                                 "routes (launches_f32, launches_bwd_f32)")
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        del again
        o_err = (o - ref.flash_attention(q, k, v, window=window)).abs().max().item()
        lse_err = (lse - ref.flash_attention_lse(q, k, window=window)).abs().max().item()
        plain = ref.flash_attention_bwd(q, k, v, o, do, lse, window=window)
        exact = ref.flash_attention_bwd(*(t.double() for t in (q, k, v, o, do, lse)),
                                        window=window)
        errs, line = [], []
        for gname, g, p, e in zip(("dq", "dk", "dv"), got, plain, exact):
            err = (g.double() - e).abs().max().item()
            own = (p.double() - e).abs().max().item()
            limit = max(1e-5 * e.abs().max().item(), own)
            line.append(f"{gname} {err:.3g} (limit {limit:.3g}: plain's own {own:.3g})")
            if not err <= limit:
                raise AssertionError(f"flash_attention backward f32 ({what}) {gname} "
                                     f"disagrees with its plain version: {err} > {limit}")
            errs.append(err)
        del got, plain, exact
        shape = f"q[{b},{hq},{s},{d}] kv[{b},{hkv},{s},{d}] f32 causal" + (
            f" window {window}" if window else "")
        print(f"[smoke] flash_attention f32 training forward {what} {shape}: output "
              f"max_abs_err {o_err:.3g} (limit 1e-05); lse max_abs_err {lse_err:.3g} (limit "
              f"1e-05); backward max_abs_err {'; '.join(line)}; two runs bit for bit: {same}")
        if not (o_err <= 1e-5 and lse_err <= 1e-5 and same):
            raise AssertionError(f"flash_attention f32 kernels at {what}: output {o_err}, "
                                 f"lse {lse_err}, bit for bit {same}")

        pairs = b * hq * _causal_pairs(s, s, window)
        io = 2 * b * hq * s * d + 2 * b * hkv * s * d
        fwd_ms = _time_ms(lambda: kflash.launch(q, k, v, window=window), 10)
        lse_ms = _time_ms(lambda: kflash.launch(q, k, v, window=window, with_lse=True), 10)
        fwd_plain = _time_ms(lambda: ref.flash_attention(q, k, v, window=window), 3)
        fwd_lib = _time_ms(sdpa_of(q, k, v, window)[0], 10)
        fwd_bound, fwd_by = _bound(3 * 4.0 * d * pairs, 4 * io, peak=TF32_FLOPS)
        bwd_ms = _time_ms(lambda: kflash.launch_bwd(q, k, v, o, do, lse, window=window), 5)
        bwd_plain = _time_ms(lambda: ref.flash_attention_bwd(q, k, v, o, do, lse,
                                                             window=window), 2)
        sdpa, grad_leaves = sdpa_of(q, k, v, window, grad=True)
        out = sdpa()
        bwd_lib = _time_ms(lambda: torch.autograd.grad(out, grad_leaves, do,
                                                       retain_graph=True), 5)
        bwd_bytes = 4 * (2 * io) + 4 * b * hq * s
        bwd_bound, bwd_by = _bound(3 * 10.0 * d * pairs, bwd_bytes, peak=TF32_FLOPS)
        f32_fwd, f32_bwd = _bound(4.0 * d * pairs, 4 * io)[0], _bound(10.0 * d * pairs,
                                                                      bwd_bytes)[0]
        print(f"[smoke] flash_attention f32 (3 TF32 passes) {what} {shape}: forward "
              f"ms={fwd_ms:.3f} (with the row log-sum-exp {lse_ms:.3f}) plain_ms={fwd_plain:.3f} "
              f"library_ms={fwd_lib:.3f} (SDPA f32) bound_ms={fwd_bound:.4f} ({fwd_by}, 3 TF32 "
              f"passes) bound_f32_ms={f32_fwd:.4f}; backward ms={bwd_ms:.3f} "
              f"plain_ms={bwd_plain:.3f} library_ms={bwd_lib:.3f} (SDPA f32 backward) "
              f"bound_ms={bwd_bound:.4f} ({bwd_by}, 3 TF32 passes of five products) "
              f"bound_f32_ms={f32_bwd:.4f} -> {10.0 * d * pairs / bwd_ms / 1e9:.1f} TFLOP/s of "
              f"five products")
        fwd_cases.append({"what": what, "shape": shape, "max_abs_err": o_err, "ms": fwd_ms,
                          "ms_with_lse": lse_ms, "plain_ms": fwd_plain, "bound_ms": fwd_bound,
                          "bound_by": fwd_by, "bound_f32_ms": f32_fwd, "library_ms": fwd_lib})
        bwd_cases.append({"what": what, "shape": shape, "max_abs_err": max(errs), "ms": bwd_ms,
                          "plain_ms": bwd_plain, "bound_ms": bwd_bound, "bound_by": bwd_by,
                          "bound_f32_ms": f32_bwd, "library_ms": bwd_lib})
        del q, k, v, o, do, lse, sdpa, grad_leaves, out
        torch.cuda.empty_cache()
    return fwd_cases, bwd_cases


# -- phase 3: the card's training run against the CPU's ----------------------

SMALL_RUNS = (  # (what, registry method, builder keywords, FGLConfig fields)
    ("SpreadFGL", "SpreadFGL", {"num_servers": 2}, {}),
    ("FedSage+", "fedsage_plus", {}, {}),
    ("SpreadFGL participation 0.5", "SpreadFGL", {"num_servers": 2}, {"participation": 0.5}),
    ("spreadfgl_async", "spreadfgl_async", {"num_servers": 2},
     {"async_buffer": 2, "delay_dist": "uniform", "dropout_rate": 0.1}),
    ("spreadfgl_gossip", "spreadfgl_gossip", {"num_servers": 4, "gossip_every": 2}, {}),
    ("SpreadFGL gcn", "SpreadFGL", {"num_servers": 2}, {"gnn_kind": "gcn"}),
    ("SpreadFGL gat", "SpreadFGL", {"num_servers": 2}, {"gnn_kind": "gat"}),
)


def _state_to(state, where):
    """``state`` with every tensor moved to ``where`` (the generator stays)."""
    from repro_torch.tree import tree_map

    def opt(o):
        return type(o)(o.step.to(where), tree_map(lambda t: t.to(where), o.mu),
                       tree_map(lambda t: t.to(where), o.nu))
    return dataclasses.replace(
        state, batch=state.batch.to(where),
        **{f: tree_map(lambda t: t.to(where), getattr(state, f))
           for f in ("params", "ae_params", "as_params")},
        **{f: opt(getattr(state, f)) for f in ("opt_state", "ae_opt", "as_opt")})


def _check_small_run(dev):
    from repro_torch.core import imputation, registry
    from repro_torch.core.partition import partition_graph
    from repro_torch.core.types import FGLConfig
    from repro_torch.data.synthetic_graphs import DATASETS, make_sbm_graph

    graph = make_sbm_graph(DATASETS["cora"], scale=0.1, seed=1, feature_noise=3.0,
                           signal_ratio=0.5)
    batch, _ = partition_graph(graph, 4, aug_max=8, seed=0)
    base = FGLConfig(hidden_dim=16, local_rounds=2, imputation_interval=1, top_k_links=3,
                     aug_max=8)
    for what, method, kw, fields in SMALL_RUNS:
        cfg = dataclasses.replace(base, **fields)
        # Same weights on both devices: drawn on the CPU.
        state0 = registry.build(method, cfg, batch, device="cpu", **kw).init(batch)
        hists = {}
        for where in ("cpu", dev.type):
            tr = registry.build(method, cfg, batch, device=where, **kw)
            state = _state_to(state0, where)
            noise_gen = torch.Generator().manual_seed(1)
            noises = [imputation.sample_noise(noise_gen, tr.m_per * batch.n_pad,
                                              batch.num_classes, lead=(tr.n_servers,))
                      for _ in range(3)]
            _, hists[where] = tr.fit(state=state, rounds=3,
                                     noise=lambda r: noises[r].to(where))
        diffs = {key: max(abs(a - b) for a, b in zip(hists[dev.type][key], hists["cpu"][key]))
                 for key in ("loss", "acc", "f1")}
        print(f"[smoke] small {what} run {dev.type} vs cpu: max |d| "
              + " ".join(f"{k}={v:.3g}" for k, v in diffs.items()))
        if not all(d <= 1e-4 for d in diffs.values()):  # three fitted rounds of f32 in other orders
            raise AssertionError(f"{what}: the card's run disagrees with the CPU's: "
                                 f"{hists[dev.type]} vs {hists['cpu']}")


def _check_small_serve(dev):
    from repro_torch import configs
    from repro_torch.data.lm_data import memory_stub
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine

    # qwen3-4b's smoke config with a 40-token prompt (below 128 queries);
    # gemma3-12b's, whose window-64 layer's ring buffer wraps on a 200-token
    # prompt; olmoe-1b-7b's (MoE, 4 experts top-2), at its capacity factor
    # and at TIGHT_CAPACITY, where its prefill must drop (token, k) slots on
    # both devices; mixtral-8x7b's (MoE, both layers' window-64 ring buffers
    # wrap on a 200-token prompt); llama-3.2-vision-11b's with memory_stub's
    # image embeddings and its cross-block gates at CROSS_GATE; whisper-medium's
    # with memory_stub's frames through the encoder; hymba-1.5b's at
    # HYMBA_SMOKE's width, a 128-token prompt past its window-64 layer's ring
    # buffer; xlstm-125m's with a 256-token prompt across a chunk; gemma3-12b's
    # again at head dim 240 (GEMMA_D240_SMOKE), its full config's. Same weights
    # on both devices (drawn on the CPU), f32: the card's prefill takes the
    # f32 route, once per attention layer (none for xlstm).
    for arch, prompt_len, over in (("qwen3-4b", 40, {}), ("gemma3-12b", 200, {}),
                                   ("olmoe-1b-7b", 40, {}),
                                   ("olmoe-1b-7b", 40, {"capacity_factor": TIGHT_CAPACITY}),
                                   ("mixtral-8x7b", 200, {}),
                                   ("llama-3.2-vision-11b", 40, {}),
                                   ("whisper-medium", 40, {}), ("hymba-1.5b", 128, HYMBA_SMOKE),
                                   ("xlstm-125m", 256, {}), ("gemma3-12b", 200, GEMMA_D240_SMOKE)):
        cfg = configs.get_config(arch, "smoke", **over)
        cpu_model = _open_gates(transformer.init_model(cfg, seed=0, device="cpu"))
        prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, prompt_len))
        memory = memory_stub(cfg, 2)
        logits, tokens, drops = {}, {}, {}
        for where in ("cpu", dev.type):
            model = cpu_model if where == "cpu" else copy.deepcopy(cpu_model).to(dev)
            engine = ServeEngine(model, max_len=prompt_len + 16)
            before = _launches()
            with _moe_log(cfg) as log:
                out, cache = engine.prefill(prompts, memory)
            after = _launches()
            drops[where] = [float(t) for t in log["drop"]]
            logits[where] = out.cpu()
            tokens[where] = engine.decode(cache, out, steps=8).cpu()
        routes = {name: after[name] - before[name]
                  for name in ("flash_attention_f32", "flash_attention_tc",
                               "flash_attention_tc_lse")}
        err = (logits[dev.type] - logits["cpu"]).abs().max().item()
        same = torch.equal(tokens[dev.type], tokens["cpu"])
        tight = "capacity_factor" in over
        print(f"[smoke] small {cfg.name} serving run {dev.type} vs cpu, prompt "
              f"{prompt_len}{f', capacity factor {cfg.capacity_factor}' if tight else ''}"
              f"{f', d_model {cfg.d_model}' if 'd_model' in over else ''}"
              f"{f', head dim {cfg.head_dim}' if 'head_dim' in over else ''}: "
              f"prefill logits max |d| = {err:.3g}, 8 greedy tokens identical: {same}; card "
              f"prefill launches {routes}" + (
                  f"; dropped share of (token, k) slots by layer, card "
                  f"{[round(x, 4) for x in drops[dev.type]]}, cpu "
                  f"{[round(x, 4) for x in drops['cpu']]}" if cfg.is_moe else ""))
        if tight and not all(min(d) > 0 for d in drops.values()):
            raise AssertionError(f"{cfg.name} at capacity factor {cfg.capacity_factor}: "
                                 f"a prefill layer dropped nothing ({drops})")
        if routes != {"flash_attention_f32": _attn_layers(cfg), "flash_attention_tc": 0,
                      "flash_attention_tc_lse": 0}:
            raise AssertionError(f"{cfg.name} (f32): expected {_attn_layers(cfg)} f32-route "
                                 f"launches and no tensor-core launch, got {routes}")
        if not err <= 1e-4:     # two layers of f32 in other orders
            raise AssertionError(f"{cfg.name}: the card's prefill logits disagree with "
                                 f"the CPU's by {err}")
        if not same:
            raise AssertionError(f"{cfg.name}: greedy tokens differ: "
                                 f"{tokens[dev.type].tolist()} vs {tokens['cpu'].tolist()}")


def _check_bf16_serve(dev):
    from repro_torch import configs
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine

    # qwen3-4b's and olmoe-1b-7b's smoke configs in bf16 (head dim 32), a
    # 200-token prompt: the prefill on the card through ops.mha (the
    # tensor-core kernel), then the same prefill with the plain version
    # patched in here. Limit, stated before the first run: logits within 2e-2
    # of max |logit|; the greedy tokens of 8 decode steps from each are
    # printed, not held.
    for arch in ("qwen3-4b", "olmoe-1b-7b"):
        cfg = dataclasses.replace(configs.get_config(arch, "smoke"), dtype="bfloat16")
        model = transformer.init_model(cfg, seed=0, device=dev)
        prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 200))
        engine = ServeEngine(model, max_len=216)
        before = _launches()
        out_kernel, cache = engine.prefill(prompts)
        after = _launches()
        tok_kernel = engine.decode(cache, out_kernel, steps=8)
        kernel_mha = ops.mha
        ops.mha = lambda q, k, v, *, causal=True, window=None: ref.flash_attention(  # noqa: E731
            q, k, v, causal=causal, window=window)
        try:
            out_plain, cache = engine.prefill(prompts)
            tok_plain = engine.decode(cache, out_plain, steps=8)
        finally:
            ops.mha = kernel_mha
        routes = {name: after[name] - before[name] for name in
                  ("flash_attention_tc", "flash_attention_f32", "flash_attention_tc_lse")}
        err = (out_kernel.float() - out_plain.float()).abs().max().item()
        scale = out_plain.float().abs().max().item()
        agree = (tok_kernel == tok_plain).float().mean().item()
        print(f"[smoke] small {cfg.name} bf16 serving run, prompt 200: prefill logits "
              f"kernel vs plain max |d| = {err:.3g} (limit 2e-2 x max |logit| = "
              f"{2e-2 * scale:.3g}); greedy tokens agree {agree:.3f} of 2 x 8; launches "
              f"{routes}")
        if routes != {"flash_attention_tc": cfg.num_layers, "flash_attention_f32": 0,
                      "flash_attention_tc_lse": 0}:
            raise AssertionError(f"{cfg.name} (bf16): expected {cfg.num_layers} bf16-route "
                                 f"launches and no f32-route launch, got {routes}")
        if not (torch.isfinite(out_kernel).all() and err <= 2e-2 * scale):
            raise AssertionError(f"{cfg.name} (bf16): the kernel's prefill logits disagree "
                                 f"with the plain version's by {err}")


def _update_check(before, after, ref_before, ref_after, kept):
    """The worst change of a parameter in one step against the reference
    run's, as a share of the largest change of its leaf there, over the
    elements ``kept``."""
    worst = 0.0
    for name, want in ref_after.items():
        delta, ref_delta = after[name] - before[name], want - ref_before[name]
        err = (delta - ref_delta).abs()[kept[name]]
        if err.numel():
            worst = max(worst, err.max().item() / max(ref_delta.abs().max().item(), 1e-30))
    return worst


def _check_small_train(dev):
    from repro_torch import configs
    from repro_torch.launch import serve, train
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import step as tstep

    # Three steps of the launcher's set-up (Adam, clipped, cosine schedule)
    # at each smoke config (f32) on the card and on the CPU, from the same
    # weights (drawn on the CPU). Limits: losses and final parameters within
    # 1e-4 (three steps of f32 in other orders); each step's change of each
    # parameter within 1e-2 of the largest change of its leaf in the CPU's
    # step, over the elements whose CPU gradient was at least 1e-5 of its
    # leaf's largest, or exactly 0, at every step so far (Adam's first steps
    # move a parameter by about lr whatever its gradient's size, so one
    # within f32 rounding of 0 may move either way; an exact 0, as of an
    # expert no token reached, is 0 on both), which must be 99 % of them
    # (98 % for xlstm: the rows of its tied 512-row table that no batch's token
    # holds get only the softmax's gradient, below 1e-5 of the leaf's largest).
    # An attention key bias (whisper's bk) is left out of both comparisons:
    # its gradient is 0 in exact arithmetic, so on either device its value and
    # the Adam steps it drives are rounding noise (_structural_zero). The
    # card's launches: each attention layer's forward once per microbatch and
    # step, twice with remat; its backward once (none for xlstm). Then train
    # --checkpoint on the card writes a file, which serve --checkpoint serves:
    # its prefill logits equal the trained model's.
    def params(state):
        return {n: t.detach().cpu().double() for n, t in state.params.state_dict().items()}

    for arch, extra, over in SMALL_TRAIN_RUNS:
        argv = ["--arch", arch, "--variant", "smoke", "--steps", "3", "--batch", "4",
                "--seq", "80", "--log-every", "3", *extra]
        cpu_model = _open_gates(transformer.init_model(
            configs.get_config(arch, "smoke", **over), seed=0, device="cpu"))
        runs, kept_steps, drops = [], [], {}
        for i, where in enumerate(("cpu", dev.type)):
            flags = train._parser().parse_args(argv + ["--device", where])
            state, step_fn, data = train.setup(flags, copy.deepcopy(cpu_model))
            cfg = state.params.cfg
            snaps, losses, kept = [params(state)], [], None
            before = _launches()
            for _ in range(flags.steps):
                batch = {k: torch.from_numpy(v).to(where) for k, v in next(data).items()}
                if i == 0:      # the CPU's gradients: which elements each step holds
                    grads = tstep.loss_and_grads(state.params, cfg, batch, flags.microbatch)[2]
                    new = {n: ((g.abs() >= 1e-5 * g.abs().max()) | (g == 0))
                           & (not _structural_zero(n)) for n, g in grads.items()}
                    kept = new if kept is None else {n: kept[n] & new[n] for n in new}
                    kept_steps.append(kept)
                with _moe_log(cfg) as log:
                    state, metrics = step_fn(state, batch)
                drops.setdefault(where, []).extend(float(t) for t in log["drop"])
                losses.append(float(metrics["loss"]))
                snaps.append(params(state))
            after = _launches()
            runs.append((losses, snaps))
        per = _attn_layers(cfg) * flags.steps * flags.microbatch
        want = {"flash_attention_f32": per * (2 if cfg.remat else 1), "flash_attention_tc": 0,
                "flash_attention_tc_lse": 0, "flash_attention_bwd": per,
                "flash_attention_bwd_f32": per, "flash_attention_bwd_tc": 0}
        got = {name: after[name] - before[name] for name in want}
        (cpu_losses, cpu_snaps), (losses, snaps) = runs
        dloss = max(abs(a - b) for a, b in zip(losses, cpu_losses))
        dparam = max((t - cpu_snaps[-1][n]).abs().max().item() for n, t in snaps[-1].items()
                     if not _structural_zero(n))
        dstep = [_update_check(snaps[i], snaps[i + 1], cpu_snaps[i], cpu_snaps[i + 1], kept)
                 for i, kept in enumerate(kept_steps)]
        kept = kept_steps[-1]
        share = sum(k.sum().item() for k in kept.values()) / sum(k.numel() for k in kept.values())
        if cfg.is_moe:
            print(f"[smoke] small train {arch} (capacity factor {cfg.capacity_factor}): "
                  f"dropped share of (token, k) slots, layers x steps (twice with remat), "
                  f"card {[round(x, 4) for x in drops[dev.type]]}, cpu "
                  f"{[round(x, 4) for x in drops['cpu']]}")
        if "capacity_factor" in over and not all(min(d) > 0 for d in drops.values()):
            raise AssertionError(f"small train {arch} at capacity factor "
                                 f"{cfg.capacity_factor}: a layer dropped nothing ({drops})")
        print(f"[smoke] small train {arch} {' '.join(extra)}{f' {over}' if over else ''} "
              f"{dev.type} vs cpu: 3 steps, "
              f"max |d| loss {dloss:.3g} params {dparam:.3g} (limit 1e-4); each step's "
              f"change vs the cpu's {[float(f'{x:.3g}') for x in dstep]} of its leaf's "
              f"largest (limit 1e-2, over {100 * share:.2f} % of the elements); card "
              f"launches {got}")
        if got != want:
            raise AssertionError(f"small train {arch}: launched {got}, expected {want}")
        min_share = 0.98 if arch == "xlstm-125m" else 0.99
        if not (dloss <= 1e-4 and dparam <= 1e-4 and max(dstep) <= 1e-2
                and share >= min_share):
            raise AssertionError(f"small train {arch}: the card's run disagrees with the "
                                 f"CPU's (loss {dloss}, params {dparam}, steps {dstep}, "
                                 f"share {share})")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = str(Path(tmp) / "params.npz")
        out = train.main(argv + ["--device", dev.type, "--checkpoint", path],
                         model=copy.deepcopy(cpu_model))
        model = out["state"].params
        served = serve.main(["--arch", arch, "--variant", "smoke", "--checkpoint", path,
                             "--batch", "2", "--prompt-len", "40", "--steps", "4",
                             "--device", dev.type])
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))  # serve's
    direct, _ = ServeEngine(model, max_len=48).prefill(prompts)
    err = (served["logits"] - direct).abs().max().item()
    print(f"[smoke] {arch} checkpoint written by train --checkpoint on the card, served by "
          f"serve --checkpoint: prefill logits against the trained model's max |d| = "
          f"{err:.3g}")
    if not (err <= 1e-6 and torch.isfinite(direct).all()):
        raise AssertionError(f"serve --checkpoint of a trained model's file differs by {err}")


def _check_whole_step(dev, dtype: str = "bfloat16"):
    from repro_torch import configs
    from repro_torch.data.lm_data import token_batches
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer
    from repro_torch.optim.adam import SGD
    from repro_torch.train import step

    # Qwen3-4B at full width, depth cut to 4 layers, remat, batch 1 x 2048,
    # in bf16 or f32: one step's loss and gradients through the kernels, then
    # with the plain attention patched into ops.mha (autograd through it).
    # Limits, bf16: loss within 1e-3 x loss, every leaf's gradient within 2e-2
    # of that leaf's max |grad| (P and dS are rounded to bf16). f32: the
    # kernels hold each attention output and gradient to 1e-5 of the plain
    # f32 version (f32 sums in other orders, the split's 2^-22), and four
    # layers add four such perturbations to the same computation: loss within
    # 1e-5 x loss, every leaf's gradient within 1e-4 of its max |grad|. wq's
    # gradient not zero.
    f32 = dtype == "float32"
    cfg = configs.get_config("qwen3-4b", "full", num_layers=4, dtype=dtype)
    model = transformer.init_model(cfg, seed=0, device=dev)
    step.init_state(cfg, SGD(), model=model)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in next(token_batches(cfg, batch=1, seq_len=2048)).items()}
    before = _launches()
    total_k, _, grads_k = step.loss_and_grads(model, cfg, batch)
    torch.cuda.synchronize()
    after = _launches()
    kernel_mha = ops.mha
    ops.mha = lambda q, k, v, *, causal=True, window=None: ref.flash_attention(  # noqa: E731
        q, k, v, causal=causal, window=window)
    try:
        total_p, _, grads_p = step.loss_and_grads(model, cfg, batch)
    finally:
        ops.mha = kernel_mha
    fwd, bwd = (("flash_attention_f32", "flash_attention_bwd_f32") if f32 else
                ("flash_attention_tc_lse", "flash_attention_bwd_tc"))
    names = ("flash_attention_tc_lse", "flash_attention_bwd", "flash_attention_bwd_tc",
             "flash_attention_bwd_f32", "flash_attention_tc", "flash_attention_f32")
    got = {name: after[name] - before[name] for name in names}
    want = {name: 0 for name in names}
    want.update({fwd: 2 * cfg.num_layers, "flash_attention_bwd": cfg.num_layers,
                 bwd: cfg.num_layers})
    loss_limit, grad_limit = (1e-5, 1e-4) if f32 else (1e-3, 2e-2)
    dloss = abs(total_k.item() - total_p.item())
    worst, worst_name = 0.0, ""
    for name, g in grads_k.items():
        rel = (g.float() - grads_p[name].float()).abs().max().item() / max(
            grads_p[name].float().abs().max().item(), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    wq = grads_k["blocks.0.attn.wq"].float().abs().max().item()
    print(f"[smoke] whole step qwen3-4b full width, 4 layers, {dtype}, 1 x 2048: loss kernel "
          f"{total_k.item():.6f} plain {total_p.item():.6f} (|d| {dloss:.3g}, limit "
          f"{loss_limit:g} x loss); worst gradient {worst_name} off by {worst:.3g} of its max "
          f"|grad| (limit {grad_limit:g}); max |wq grad| {wq:.3g}; launches {got}")
    if got != want:
        raise AssertionError(f"whole step {dtype}: launched {got}, expected {want}")
    if not (dloss <= loss_limit * abs(total_p.item()) and worst <= grad_limit and wq > 0):
        raise AssertionError(f"whole step {dtype}: the kernels' step disagrees with the plain "
                             f"one")
    del model, grads_k, grads_p
    torch.cuda.empty_cache()


# -- phase 4: the main paths --------------------------------------------------

def _expected_launches(flags, start: int = 0, gnn_kind: str = "sage") -> dict:
    """The launches a run of the launcher's flags implies, from its rounds,
    local steps, K, method and layer count. Classifier forwards run in the
    local steps and the evaluation every round, and in the embeddings on
    each imputation round of the SpreadFGL generator, which launches
    ``sim_topk`` once. Each forward launches ``sage_aggregate`` once per
    layer after the first (GAT's attention launches none); layer 1's mean
    is launched once per batch the trainer sees: its first, and each that
    an imputation round (SpreadFGL's or FedSage+'s) puts in its place.
    FedSage+'s imputation is plain products."""
    from repro_torch.launch import fgl_train

    rounds = range(start, start + flags.rounds)
    imputations = sum(r % flags.imputation_interval == 0 for r in rounds)
    spread = flags.method in ("FedGL", "SpreadFGL", "spreadfgl_gossip", "spreadfgl_async")
    forwards = flags.rounds * (flags.local_rounds + 1) + (imputations if spread else 0)
    replaces = spread or flags.method == "fedsage_plus"
    batches = 1 + (imputations if replaces else 0) if forwards else 0
    layers = 0 if gnn_kind == "gat" else fgl_train.config(flags).num_layers
    return {"sage_aggregate": (batches + forwards * (layers - 1)) if layers else 0,
            "sim_topk": imputations if spread else 0}


def _check_run(what, hist, counts, want, wall):
    got = {k: counts[k] for k in want}
    print(f"[smoke] path {what}: {wall:.1f} s wall, rounds {hist['round']}, round seconds "
          f"{[round(s, 3) for s in hist['seconds']]}, losses "
          f"{[round(v, 4) for v in hist['loss']]}, launches {got} (expected {want})")
    if not all(math.isfinite(v) for v in hist["loss"]):
        raise AssertionError(f"{what}: non-finite loss: {hist['loss']}")
    if got != want:
        raise AssertionError(f"{what}: launched {got}, expected {want}")


def _main_path(args):
    from repro_torch.launch import fgl_train

    flags = fgl_train.parse(args)
    _reset_launches()
    t0 = time.perf_counter()
    hist = fgl_train.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launches()
    _check_run(f"fgl_train {' '.join(args)} (data included)", hist, counts,
               _expected_launches(flags), wall)
    return counts, hist


def _engine_paths():
    """The rest of the FGL engine on one full-size Coauthor-CS batch, each
    run with the launch counters set to 0 just before it and read just
    after: the launcher's runs, the GCN and GAT classifiers, and the async
    run stopped after rounds 0-1 and resumed for round 2."""
    from repro_torch.core import registry
    from repro_torch.launch import fgl_train

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    data = fgl_train.build_data(fgl_train.parse(ENGINE_ARGS))
    print(f"[smoke] Coauthor-CS graph and partition built once in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    runs, hists = [], {}

    def run(what, fn, want):
        _reset_launches()
        t0 = time.perf_counter()
        hist = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _launches()
        _check_run(what, hist, counts, want, wall)
        runs.append(counts)
        torch.cuda.empty_cache()
        return hist

    for what, extra, rounds in ENGINE_RUNS:
        argv = ENGINE_ARGS + extra + ["--rounds", str(rounds)]
        hists[what] = run(f"fgl_train {' '.join(argv[len(ENGINE_ARGS):])}",
                          lambda: fgl_train.main(argv, data=data),
                          _expected_launches(fgl_train.parse(argv)))
    flags = fgl_train.parse(ENGINE_ARGS + ["--rounds", "3"])
    for kind in ENGINE_KINDS:
        def fit(kind=kind):
            cfg = dataclasses.replace(fgl_train.config(flags), gnn_kind=kind)
            tr = registry.build(flags.method, cfg, data[0], num_servers=flags.servers,
                                device=flags.device)
            return tr.fit(data[0], rounds=flags.rounds)[1]
        hists[kind] = run(f"registry.build SpreadFGL gnn_kind={kind}", fit,
                          _expected_launches(flags, gnn_kind=kind))

    # Stop the async run after rounds 0-1 and resume it for round 2.
    what, extra, _ = ENGINE_RUNS[2]
    argv = ENGINE_ARGS + extra
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = str(Path(tmp) / "state.npz")
        first = run(f"{what}, rounds 0-1 then --save-state",
                    lambda: fgl_train.main(argv + ["--rounds", "2", "--save-state", path],
                                           data=data),
                    _expected_launches(fgl_train.parse(argv + ["--rounds", "2"])))
        second = run(f"{what}, --resume for round 2",
                     lambda: fgl_train.main(argv + ["--rounds", "1", "--resume", path],
                                            data=data),
                     _expected_launches(fgl_train.parse(argv + ["--rounds", "1"]), start=2))
    whole = hists[what]
    for key in ("round", "loss", "acc", "f1"):
        if first[key] + second[key] != whole[key]:
            raise AssertionError(f"{what}: the stopped and resumed run's {key} "
                                 f"{first[key] + second[key]} differs from the whole "
                                 f"run's {whole[key]}")
    print(f"[smoke] path {what} stopped after rounds 0-1 and resumed for round 2: "
          f"rounds 0-2 equal the whole run's bit for bit")
    print(f"[smoke] the rest of the FGL engine: {time.perf_counter() - t_phase:.1f} s wall")
    return runs, hists


def _edge_rank(argvs):
    """One rank of the edge mesh (started by ``mesh.spawn``): the Coauthor-CS
    batch built once, then ``fgl_train.main`` for each of ``argvs``, each
    with the launch counters set to 0 just before and read just after."""
    from repro_torch.launch import fgl_train

    data = fgl_train.build_data(fgl_train.parse(argvs[0]))
    out = []
    for argv in argvs:
        _reset_launches()
        t0 = time.perf_counter()
        hist = fgl_train.main(argv, data=data)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        out.append({"hist": hist, "launches": _launches(),
                    "wall": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    return out


def _same_history(what, got, want, tol):
    """Rounds equal, and loss, accuracy and F1 within ``tol`` a round (0:
    bit for bit)."""
    if got["round"] != want["round"]:
        raise AssertionError(f"{what}: rounds {got['round']} against {want['round']}")
    for key in ("loss", "acc", "f1"):
        gap = max(abs(a - b) for a, b in zip(got[key], want[key]))
        if not gap <= tol:
            raise AssertionError(f"{what}: {key} {got[key]} against {want[key]} "
                                 f"(largest gap {gap:.3g} > {tol})")


def _edge_paths(spread_hist, gossip_hist):
    """The distributed edge layer's FGL paths, each run with the launch
    counters set to 0 just before it and read just after: (b) the main
    path's flags with ``--edge-mesh --sim-shard`` in this process, where
    both meshes have size 1, bit for bit the plain run; (c) the same flags,
    and with ``--gossip-every 2``, on ``EDGE_RANKS`` gloo ranks sharing the
    card, one server each (``mesh.spawn``), every rank within 1e-4 a round
    of the run in one process and launching per rank what its flags imply,
    ``sim_topk`` once per slab of the ring; then ``launch.edge_mesh
    --devices 3`` at its own size, within 1e-4 of the same launcher in one
    process. Returns each run's launches, every rank's included."""
    from repro_torch.launch import edge_mesh, fgl_train
    from repro_torch.launch import mesh as mesh_lib

    t_phase = time.perf_counter()
    argv = SPREAD_ARGS + EDGE_FLAGS
    flags = fgl_train.parse(argv)
    _reset_launches()
    t0 = time.perf_counter()
    hist = fgl_train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    one = _launches()
    _check_run(f"fgl_train {' '.join(argv)} (size-1 meshes, data included)", hist, one,
               _expected_launches(flags), wall)
    _same_history("size-1 meshes", hist, spread_hist, 0.0)
    print("[smoke] path with --edge-mesh --sim-shard in one process: bit for bit the plain run")
    torch.cuda.empty_cache()

    argvs = [SPREAD_ARGS + EDGE_FLAGS,
             ENGINE_ARGS + ["--gossip-every", "2", "--rounds", "3"] + EDGE_FLAGS]
    t0 = time.perf_counter()
    ranks = mesh_lib.spawn(_edge_rank, EDGE_RANKS, "cuda", args=(argvs,))
    wall = time.perf_counter() - t0
    runs = [one]
    for i, (argv, want_hist) in enumerate(zip(argvs, (spread_hist, gossip_hist))):
        want = _expected_launches(fgl_train.parse(argv))
        want["sim_topk"] *= EDGE_RANKS          # one fold per slab of the ring
        for r, rank in enumerate(ranks):
            got = rank[i]
            _check_run(f"rank {r} of {EDGE_RANKS} (gloo, one card): fgl_train "
                       f"{' '.join(argv)}", got["hist"], got["launches"], want, got["wall"])
            _same_history(f"rank {r}: {' '.join(argv)}", got["hist"], want_hist, 1e-4)
            runs.append(got["launches"])
    print(f"[smoke] paths on {EDGE_RANKS} gloo ranks sharing the card: {wall:.1f} s wall "
          f"(rank start, data and both runs); every rank within 1e-4 a round of one process")
    from repro_torch.core import ring_topk
    # A server's flat slots: its clients' n_pad = 6123 (Coauthor-CS, 6 clients).
    n_flat = flags.clients // flags.servers * 6123
    per_send = flags.servers * ring_topk.ring_rotation_bytes(n_flat, 15, EDGE_RANKS)
    print(f"[smoke] ring rotation on {EDGE_RANKS} ranks: {per_send:.0f} bytes a send "
          f"({flags.servers} servers' slabs of [{-(-n_flat // EDGE_RANKS)},15] with ids and "
          f"mask), {EDGE_RANKS - 1} sends a rank an imputation round: "
          f"{flags.servers * ring_topk.ring_total_bytes(n_flat, 15, EDGE_RANKS):.0f} bytes "
          f"(an all-gather of the candidates: "
          f"{flags.servers * ring_topk.allgather_bytes(n_flat, 15, EDGE_RANKS):.0f})")

    t0 = time.perf_counter()
    spread = edge_mesh.main(EDGE_MESH_ARGS + ["--devices", str(EDGE_RANKS)])
    wall = time.perf_counter() - t0
    alone = edge_mesh.main(EDGE_MESH_ARGS)
    _same_history("launch.edge_mesh --devices 3", spread, alone, 1e-4)
    print(f"[smoke] launch.edge_mesh {' '.join(EDGE_MESH_ARGS)} --devices {EDGE_RANKS}: "
          f"{wall:.1f} s wall, losses {[round(v, 4) for v in spread['loss']]}, within 1e-4 a "
          f"round of one process")
    print(f"[smoke] the distributed FGL paths: {time.perf_counter() - t_phase:.1f} s wall")
    torch.cuda.empty_cache()
    return runs


def _spread_pod(args):
    """One pod of spread training (started by ``mesh.spawn``):
    ``launch.train.spread_rank`` with the launch counters set to 0 just
    before and read just after, and every gossip exchange checked: the mean
    over the pods of the f32 averages it computes (before their cast to the
    parameters' dtype) against the mean of the parameters before it,
    elementwise, relative to the largest |mean|. The exchange's host seconds
    and the check's are summed apart."""
    from repro_torch.core import gossip
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train

    average = gossip._ring_average
    rel, spent = [], {"exchange_s": 0.0, "check_s": 0.0}

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def checked(p, mesh):
        sync()
        t0 = time.perf_counter()
        out = average(p, mesh)
        sync()
        t1 = time.perf_counter()
        before = mesh_lib.all_reduce_sum(mesh, p.float())
        after = mesh_lib.all_reduce_sum(mesh, out)
        rel.append(((after - before).abs().max()
                    / before.abs().max().clamp_min(1e-30)).item())
        spent["exchange_s"] += t1 - t0
        spent["check_s"] += time.perf_counter() - t1
        return out

    gossip._ring_average = checked
    _reset_launches()
    out = train.spread_rank(args)
    sync()
    return dict(out, **spent, launches=_launches(), mean_rel=max(rel, default=None),
                exchanges=len(rel))


def _spread_train_path():
    """``launch.train --aggregation spread --pods 2 --gossip-every 2`` on
    Qwen3-4B at full width cut to ``SPREAD_LAYERS`` layers, both pods on
    the card over gloo, 4 steps: per rank its step seconds, tokens a second,
    peak memory and launches, and the mean of the pods' parameters kept by
    every gossip step (1e-5 relative)."""
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train

    flags = train._parser().parse_args(SPREAD_TRAIN_ARGS)
    cfg = configs.get_config(flags.arch, flags.variant, num_layers=flags.layers)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = mesh_lib.spawn(_spread_pod, flags.pods, "cuda", args=(flags,))
    wall = time.perf_counter() - t0
    gossip_steps = sum((i + 1) % flags.gossip_every == 0 for i in range(flags.steps))
    per_step = {"flash_attention_tc_lse": cfg.num_layers * (2 if cfg.remat else 1),
                "flash_attention_bwd_tc": cfg.num_layers, "flash_attention_bwd_f32": 0,
                "flash_attention_tc": 0, "flash_attention_f32": 0}
    want = {name: n * flags.steps for name, n in per_step.items()}
    rows = flags.batch // flags.pods
    plain = [i for i in range(1, flags.steps) if (i + 1) % flags.gossip_every]
    runs = []
    for r, rank in enumerate(ranks):
        secs, losses = rank["seconds"], rank["losses"]
        step_s = float(np.median([secs[i] for i in plain]))
        gossip_s = [secs[i] for i in range(flags.steps) if (i + 1) % flags.gossip_every == 0]
        got = {name: rank["launches"][name] for name in want}
        print(f"[smoke] spread train pod {r} of {flags.pods} (gloo, one card): {cfg.num_layers} "
              f"layers, {rows} x {flags.seq} tokens a step; losses "
              f"{[round(x, 4) for x in losses]}; step seconds {[round(x, 3) for x in secs]}; "
              f"steps {plain} without gossip {step_s:.3f} s, {rows * flags.seq / step_s:.0f} "
              f"tokens/s; gossip steps {[round(x, 3) for x in gossip_s]} s, of which the "
              f"exchange {rank['exchange_s']:.3f} s and the check's all-reduces "
              f"{rank['check_s']:.3f} s in all; peak memory {rank['peak_bytes'] / 1e9:.2f} GB; "
              f"{rank['exchanges']} leaf exchanges, pods' mean kept within "
              f"{rank['mean_rel']:.3g} relative; launches {got} (expected {want})")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"spread train pod {r}: non-finite loss {losses}")
        if got != want:
            raise AssertionError(f"spread train pod {r}: launched {got}, expected {want}")
        if rank["exchanges"] == 0 or rank["exchanges"] % gossip_steps:
            raise AssertionError(f"spread train pod {r}: {rank['exchanges']} exchanges in "
                                 f"{gossip_steps} gossip steps")
        if not rank["mean_rel"] <= 1e-5:
            raise AssertionError(f"spread train pod {r}: gossip moved the pods' mean by "
                                 f"{rank['mean_rel']:.3g} relative")
        runs.append(rank["launches"])
    if ranks[0]["losses"] == ranks[1]["losses"]:
        raise AssertionError("spread train: both pods report the same losses on other rows")
    print(f"[smoke] spread train {' '.join(SPREAD_TRAIN_ARGS)}: {wall:.1f} s wall (pod start, "
          f"build and steps)")
    return runs


def _serve_main_path(args, model=None, measured: Optional[dict] = None):
    """``launch.serve.main(args, model=model)`` with the launch counters set to
    0 just before and read just after: prefill seconds, decode ms a step, peak
    memory and flash launches; for an MoE config the share of (token, k)
    slots that capacity dropped in each prefill layer; for a vlm, a second
    prefill with other image embeddings, whose logits must differ. The
    prefill seconds and peak go into ``measured`` when given."""
    from repro_torch import configs
    from repro_torch.data.lm_data import memory_stub
    from repro_torch.launch import serve

    flags = serve._parser().parse_args(args)
    cfg = configs.get_config(flags.arch, flags.variant) if model is None else model.cfg
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    with _moe_log(cfg, first=cfg.num_layers) as log:     # the prefill's layers
        out = serve.main(args, model=model)
    counts = _launches()
    drops, cos = ([float(t) for t in log[key]] for key in ("drop", "cos"))
    peak = torch.cuda.max_memory_allocated()
    if measured is not None:
        measured.update(seconds=out["prefill_s"], peak=peak, batch=flags.batch,
                        seq=flags.prompt_len)
    logits, tokens = out["logits"], out["tokens"]
    n_params = sum(p.numel() for p in out["engine"].model.parameters())
    print(f"[smoke] main path serve {' '.join(args)}: {cfg.num_layers} layers, "
          f"{n_params / 1e9:.2f} B parameters ({cfg.active_params() / 1e9:.2f} B active, "
          f"{cfg.dtype}); prefill {out['prefill_s']:.3f} s, decode "
          f"{out['decode_s'] / flags.steps * 1e3:.2f} ms/step over {flags.steps} steps; peak "
          f"memory {peak / 1e9:.2f} GB; flash launches {counts}; card {_card_line()}")
    if cfg.is_moe:
        print(f"[smoke] {cfg.name} prefill: share of (token, k) slots dropped by capacity "
              f"(factor {cfg.capacity_factor}), layer by layer: "
              f"{[round(x, 4) for x in drops]}; mean cosine of two router inputs of a "
              f"group: {[round(x, 4) for x in cos]}")
        if len(drops) != cfg.num_layers or not all(0 <= x < 1 for x in drops):
            raise AssertionError(f"{cfg.name}: dropped shares {drops}")
    if cfg.cross_attn_interval or cfg.is_encdec:
        other = memory_stub(cfg, flags.batch, rng=np.random.default_rng(1))
        moved, _ = out["engine"].prefill(out["prompts"], other)
        diff = (moved - logits).abs().max().item()
        print(f"[smoke] {cfg.name}: prefill logits with other "
              + (f"image embeddings differ by max |d| = {diff:.3g} (cross gates {CROSS_GATE})"
                 if cfg.cross_attn_interval else f"audio frames differ by max |d| = {diff:.3g}"))
        if not diff > 1e-3 * logits.abs().max().item():
            raise AssertionError(f"{cfg.name}: the logits do not depend on the memory ({diff})")
        del moved
    if logits.shape != (flags.batch, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits of shape {tuple(logits.shape)} are not "
                             f"finite [{flags.batch}, {cfg.vocab_size}]")
    if tokens.shape != (flags.batch, flags.steps) or not (
            (tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise AssertionError(f"generated tokens of shape {tokens.shape} out of range")
    # One bf16 prefill: the bf16 route launches once per attention layer (the
    # encoder's attention and the ssm family's layers are plain), the f32 route
    # never; decode attention is plain.
    if (counts["flash_attention_tc"] != _attn_layers(cfg) or counts["flash_attention_f32"]
            or counts["flash_attention_tc_lse"]):
        raise AssertionError(f"flash_attention launched {counts} times, expected "
                             f"{_attn_layers(cfg)} on the bf16 route (one per attention layer "
                             f"of one prefill) and none on the f32 route or the training "
                             f"kernel")
    del out, logits
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _moe_vlm_serve_paths(dev):
    """OLMoE-1B-7B at full width and depth; Mixtral-8x7B at full width cut to
    ``MIXTRAL_LAYERS`` layers; Llama-3.2-Vision-11B at full width and depth
    with its cross gates at ``CROSS_GATE``: each through
    ``launch.serve.main``, random bf16 weights from seed 0."""
    from repro_torch import configs
    from repro_torch.models import transformer

    runs = [_serve_main_path(OLMOE_SERVE_ARGS)]
    cfg = configs.get_config("mixtral-8x7b", "full", num_layers=MIXTRAL_LAYERS,
                             window_pattern=(4096,) * MIXTRAL_LAYERS)
    runs.append(_serve_main_path(MIXTRAL_SERVE_ARGS,
                                 transformer.init_model(cfg, seed=0, device=dev)))
    cfg = configs.get_config("llama-3.2-vision-11b", "full")
    runs.append(_serve_main_path(VLM_SERVE_ARGS, _open_gates(
        transformer.init_model(cfg, seed=0, device=dev))))
    return runs


def _f32_serve_path(dev):
    """Qwen3-4B at full width and depth in float32: batch 2 x 2048-token
    prompts, prefill and 8 greedy decode steps through the f32 route, with the
    launch counters set to 0 just before and read just after; then the same
    prefill and decode with the plain version patched in. Limit, stated before
    the first run: last-position logits within 1e-4 of max |logit|; the
    greedy tokens' agreement is printed, not held."""
    from repro_torch import configs
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine

    cfg = dataclasses.replace(configs.get_config("qwen3-4b", "full"), dtype="float32")
    model = transformer.init_model(cfg, seed=0, device=dev)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 2048))
    engine = ServeEngine(model, max_len=2048 + 8)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = engine.prefill(prompts)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        return logits, engine.decode(cache, logits, steps=8), prefill_s

    _reset_launches()
    out_kernel, tok_kernel, kernel_s = run()
    counts = _launches()
    kernel_mha = ops.mha
    ops.mha = lambda q, k, v, *, causal=True, window=None: ref.flash_attention(  # noqa: E731
        q, k, v, causal=causal, window=window)
    try:
        out_plain, tok_plain, plain_s = run()
    finally:
        ops.mha = kernel_mha
    err = (out_kernel - out_plain).abs().max().item()
    scale = out_plain.abs().max().item()
    agree = (tok_kernel == tok_plain).float().mean().item()
    print(f"[smoke] path serve {cfg.name} float32, batch 2 x 2048 tokens: "
          f"{cfg.num_layers} layers, {cfg.active_params() / 1e9:.2f} B parameters; prefill "
          f"{kernel_s:.3f} s through the f32 route, {plain_s:.3f} s through the plain version; "
          f"last logits kernel vs plain max |d| = {err:.3g} (limit 1e-4 x max |logit| = "
          f"{1e-4 * scale:.3g}); greedy tokens agree {agree:.3f} of 2 x 8; launches {counts}")
    if (counts["flash_attention_f32"] != cfg.num_layers or counts["flash_attention_tc"]
            or counts["flash_attention_tc_lse"]):
        raise AssertionError(f"{cfg.name} (f32): expected {cfg.num_layers} f32-route launches "
                             f"and no bf16-route launch, got {counts}")
    if out_kernel.shape != (2, cfg.vocab_size) or not torch.isfinite(out_kernel).all():
        raise AssertionError(f"f32 prefill logits of shape {tuple(out_kernel.shape)} are not "
                             f"finite [2, {cfg.vocab_size}]")
    if not err <= 1e-4 * scale:
        raise AssertionError(f"{cfg.name} (f32): the kernel's prefill logits disagree with "
                             f"the plain version's by {err}")
    del model, engine
    torch.cuda.empty_cache()
    return counts


def _train_main_path(measured: Optional[dict] = None):
    """Qwen3-4B at full width and depth training in bf16 with remat, batch
    2 x 2048, 6 steps through ``launch.train.main``, with the launch
    counters set to 0 just before and read just after. The median step's
    seconds and the peak go into ``measured`` when given."""
    from repro_torch import configs
    from repro_torch.launch import train

    flags = train._parser().parse_args(TRAIN_ARGS)
    cfg = configs.get_config(flags.arch, flags.variant)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    out = train.main(TRAIN_ARGS)
    counts = _launches()
    peak = torch.cuda.max_memory_allocated()
    losses, secs = out["losses"], out["seconds"]
    n_params = sum(p.numel() for p in out["state"].params.parameters())
    step_s = float(np.median(secs[1:]))
    if measured is not None:
        measured.update(seconds=step_s, peak=peak, batch=flags.batch, seq=flags.seq)
    tokens = flags.batch * flags.seq
    share = 6.0 * n_params * tokens / step_s / BF16_FLOPS
    per_step = {"flash_attention_tc_lse": cfg.num_layers * (2 if cfg.remat else 1),
                "flash_attention_bwd": cfg.num_layers, "flash_attention_bwd_tc": cfg.num_layers,
                "flash_attention_bwd_f32": 0, "flash_attention_tc": 0,
                "flash_attention_f32": 0}
    want = {name: n * flags.steps for name, n in per_step.items()}
    got = {name: counts[name] for name in want}
    print(f"[smoke] main path train {' '.join(TRAIN_ARGS)}: {cfg.num_layers} layers, "
          f"{n_params / 1e9:.3f} B parameters ({cfg.dtype}, remat={cfg.remat}); losses "
          f"{[round(x, 4) for x in losses]}; step seconds {[round(x, 3) for x in secs]}; "
          f"median of steps 1-{flags.steps - 1} {step_s:.3f} s, {tokens / step_s:.0f} tokens/s, "
          f"{100 * share:.1f} % of the bf16 dense peak (6 N tokens); peak memory "
          f"{peak / 1e9:.2f} GB; launches {got} (expected {want}: {per_step} a step)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if got != want:
        raise AssertionError(f"train: launched {got}, expected {want}")
    del out
    torch.cuda.empty_cache()
    return counts


def _dryrun_held(cfg, what: str, got: dict, kind: str, card: str) -> None:
    """``launch.dryrun.run_one`` of ``cfg`` at the batch and length a main
    path just ran (``got``: seconds, peak, batch, seq) on the one-card mesh,
    printed beside the measured seconds and peak: ``compute_s`` may not
    exceed the measured seconds, ``collective_s`` is 0, and a training
    step's counted peak lies within 10 % of ``max_memory_allocated``."""
    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_card_mesh

    t0 = time.perf_counter()
    rec = dryrun.run_one(cfg, InputShape(what, got["seq"], got["batch"], kind), make_card_mesh())
    counted = time.perf_counter() - t0
    secs, peak = got["seconds"], got["peak"]
    print(f"[smoke] dry-run {cfg.name} {what} {got['batch']} x {got['seq']} on one card "
          f"(counted on meta in {counted:.1f} s, {rec['extra']['ops']} ops): compute_s "
          f"{rec['compute_s']:.4f} ({rec['flops'] / 1e12:.2f} TFLOP), memory_s "
          f"{rec['memory_s']:.4f} ({rec['hbm_bytes'] / 1e9:.1f} GB eager traffic), "
          f"collective_s {rec['collective_s']:.4f}, memory/device "
          f"{rec['memory_per_device'] / 1e9:.2f} GB; measured {secs:.4f} s, "
          f"{peak / 1e9:.2f} GB peak; measured/compute_s {secs / rec['compute_s']:.2f}, "
          f"measured/memory_s {secs / rec['memory_s']:.2f}, "
          f"peak/memory_per_device {peak / rec['memory_per_device']:.4f}; card {card}")
    if rec["collective_s"] != 0:
        raise AssertionError(f"dry-run {what}: one card has no collectives, got "
                             f"{rec['collective_s']}")
    if not rec["compute_s"] <= secs:
        raise AssertionError(f"dry-run {cfg.name} {what}: compute_s {rec['compute_s']:.4f} is "
                             f"no bound of the measured {secs:.4f} s")
    if kind == "train" and not abs(rec["memory_per_device"] / peak - 1) <= 0.10:
        raise AssertionError(f"dry-run train step: memory_per_device "
                             f"{rec['memory_per_device'] / 1e9:.2f} GB is not within 10 % "
                             f"of the measured peak {peak / 1e9:.2f} GB")


def _check_dryrun(serve: dict, train: dict, card: str) -> None:
    """The H100 cost model (``launch.dryrun.run_one``, counted on meta
    tensors on the host) on the one-card mesh, held against what the serving
    and training main paths measured just before: no card time of its own.
    ``compute_s`` is a bound, so it may not exceed the measured seconds; the
    training step's counted peak must lie within 10 % of
    ``torch.cuda.max_memory_allocated``. Then the fleet's records of
    Qwen3-4B and ``gossip_dryrun``'s line, as the cost model gives them."""
    from repro_torch import configs
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.launch import dryrun, gossip_dryrun
    from repro_torch.launch.mesh import make_production_mesh

    cfg = configs.get_config("qwen3-4b", "full")
    for what, got, kind in (("prefill", serve, "prefill"), ("train step", train, "train")):
        _dryrun_held(cfg, what, got, kind, card)
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        for multi in (False, True):
            rec = dryrun.run_one(cfg, INPUT_SHAPES[shape], make_production_mesh(multi_pod=multi),
                                 arch=cfg.name)
            print(f"[smoke] dry-run {cfg.name} x {shape} x {rec['mesh']} ({rec['chips']} H100): "
                  f"compute_s {rec['compute_s']:.4f}, memory_s {rec['memory_s']:.4f}, "
                  f"collective_s {rec['collective_s']:.4f} "
                  f"({ {a: round(v, 4) for a, v in rec['axis_seconds'].items()} }), dominant "
                  f"{rec['dominant']}, memory/device {rec['memory_per_device'] / 1e9:.2f} GB")
    g = gossip_dryrun.run(cfg.name, 8)
    print(f"[smoke] gossip dry-run {cfg.name} K=8 over {g['link']}: allreduce "
          f"{g['allreduce_bytes'] / 1e9:.3f} GB ({g['allreduce_s'] * 1e3:.2f} ms), spread "
          f"{g['spread_bytes_per_step'] / 1e9:.3f} GB a step ({g['spread_s_per_step'] * 1e3:.2f} "
          f"ms), ratio {g['ratio']:.3f}")


def _lm_train_path(args, model=None, what: str = "", measured: Optional[dict] = None):
    """``launch.train.main(args, model=model)`` in bf16 with remat (the full
    config's), with the launch counters set to 0 just before and read just
    after: each step one forward keeping the row log-sum-exp per attention
    layer, twice with remat (the ssm family keeps its activations and has no
    attention), and one bf16 backward per attention layer. Prints step
    seconds, tokens/s, the share of the bf16 peak that 6 x active parameters
    x tokens make (decoder tokens; an encoder-decoder's encoder adds more),
    peak memory and the launches; losses (and an MoE's aux losses, above 0)
    finite. The median step's seconds and the peak go into ``measured``
    when given."""
    from repro_torch import configs
    from repro_torch.launch import train

    flags = train._parser().parse_args(args)
    cfg = configs.get_config(flags.arch, flags.variant) if model is None else model.cfg
    if model is None and flags.layers:
        cfg = configs.cut_depth(cfg, flags.layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    out = train.main(args, model=model)
    counts = _launches()
    peak = torch.cuda.max_memory_allocated()
    losses, auxes, secs = out["losses"], out["aux"], out["seconds"]
    n_params = sum(p.numel() for p in out["state"].params.parameters())
    step_s = float(np.median(secs[1:]))
    if measured is not None:
        measured.update(seconds=step_s, peak=peak, batch=flags.batch, seq=flags.seq)
    tokens = flags.batch * flags.seq
    share = 6.0 * cfg.active_params() * tokens / step_s / BF16_FLOPS
    layers = _attn_layers(cfg)
    per_step = {"flash_attention_tc_lse": layers * (2 if cfg.remat else 1),
                "flash_attention_bwd": layers, "flash_attention_bwd_tc": layers,
                "flash_attention_bwd_f32": 0, "flash_attention_tc": 0,
                "flash_attention_f32": 0}
    want = {name: n * flags.steps for name, n in per_step.items()}
    got = {name: counts[name] for name in want}
    print(f"[smoke] path train {cfg.name}{what} {' '.join(args)}: {n_params / 1e9:.3f} B "
          f"parameters ({cfg.active_params() / 1e9:.3f} B active, {cfg.dtype}, "
          f"remat={cfg.remat}); losses {[round(x, 4) for x in losses]}"
          + (f"; aux {[round(x, 4) for x in auxes]}" if cfg.is_moe else "")
          + f"; step seconds {[round(x, 3) for x in secs]}; median of steps "
          f"1-{flags.steps - 1} {step_s:.3f} s, {tokens / step_s:.0f} tokens/s, "
          f"{100 * share:.1f} % of the bf16 dense peak (6 x active parameters x tokens); "
          f"peak memory {peak / 1e9:.2f} GB; flash launches {got} (expected {want}: "
          f"{per_step} a step); card {_card_line()}")
    if not cfg.remat:
        raise AssertionError(f"{cfg.name}: expected remat on in the full config")
    if not (all(math.isfinite(x) for x in losses + auxes)
            and (not cfg.is_moe or all(a > 0 for a in auxes))):
        raise AssertionError(f"{cfg.name} training: losses {losses}, aux {auxes}")
    if got != want:
        raise AssertionError(f"{cfg.name} train: launched {got}, expected {want}")
    del out, model
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _olmoe_train_path(dev):
    """OLMoE-1B-7B at full width cut to ``OLMOE_TRAIN_LAYERS`` layers, bf16,
    remat, the launcher's Adam, batch 2 x 2048, 4 steps through
    ``launch.train.main(model=)`` (``_lm_train_path``), aux above 0."""
    from repro_torch import configs
    from repro_torch.models import transformer

    cfg = configs.get_config("olmoe-1b-7b", "full", num_layers=OLMOE_TRAIN_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    return _lm_train_path(OLMOE_TRAIN_ARGS, transformer.init_model(cfg, seed=0, device=dev),
                          f" ({cfg.num_layers} of 16 layers)")


def _family_paths():
    """Whisper-medium, Hymba-1.5B and xLSTM-125M at full width and depth,
    each served through ``launch.serve.main`` and trained through
    ``launch.train.main`` with random bf16 weights from seed 0."""
    runs = []
    for serve_args, train_args in ((WHISPER_SERVE_ARGS, WHISPER_TRAIN_ARGS),
                                   (HYMBA_SERVE_ARGS, HYMBA_TRAIN_ARGS),
                                   (XLSTM_SERVE_ARGS, XLSTM_TRAIN_ARGS)):
        runs.append(_serve_main_path(serve_args))
        runs.append(_lm_train_path(train_args))
    return runs


def _gemma_paths(card: str):
    """gemma3-12b (head dim 240), bf16 with random weights. Served at full
    width and depth through ``launch.serve.main`` (48 bf16 forward launches
    a prefill), its prefill beside the dry-run's one-card record
    (``_dryrun_held``: ``compute_s`` a bound of the measured seconds, no
    memory tolerance for a prefill). Trained through ``launch.train.main``
    at full width, remat, batch 2 x 2048: cut to ``GEMMA_PROBE_LAYERS`` for 2
    steps, then to ``GEMMA_TRAIN_LAYERS`` for 4 (the LSE forward twice and
    the bf16 backward once per layer a step). The two peaks give the bytes a
    layer adds; the cut must be the deepest multiple of 6 layers whose peak
    stays under 90 % of the card's memory."""
    from repro_torch import configs

    measured = {}
    runs = [_serve_main_path(GEMMA_SERVE_ARGS, measured=measured)]
    _dryrun_held(configs.get_config("gemma3-12b", "full"), "prefill", measured, "prefill", card)
    peaks = {}
    for layers, steps in ((GEMMA_PROBE_LAYERS, 2), (GEMMA_TRAIN_LAYERS, 4)):
        got = {}
        args = [*GEMMA_TRAIN_ARGS, "--layers", str(layers), "--steps", str(steps)]
        runs.append(_lm_train_path(args, what=f" ({layers} of 48 layers)", measured=got))
        peaks[layers] = got["peak"]
    per_layer = (peaks[GEMMA_TRAIN_LAYERS] - peaks[GEMMA_PROBE_LAYERS]) / (
        GEMMA_TRAIN_LAYERS - GEMMA_PROBE_LAYERS)
    total = torch.cuda.get_device_properties(0).total_memory
    deeper = peaks[GEMMA_TRAIN_LAYERS] + 6 * per_layer
    print(f"[smoke] gemma3-12b training depth: peak {peaks[GEMMA_PROBE_LAYERS] / 1e9:.3f} GB at "
          f"{GEMMA_PROBE_LAYERS} layers, {peaks[GEMMA_TRAIN_LAYERS] / 1e9:.3f} GB at "
          f"{GEMMA_TRAIN_LAYERS}: {per_layer / 1e9:.3f} GB a layer, so "
          f"{GEMMA_TRAIN_LAYERS + 6} layers would peak at {deeper / 1e9:.2f} GB; 90 % of the "
          f"card's {total / 1e9:.2f} GB is {0.9 * total / 1e9:.2f} GB")
    if not peaks[GEMMA_TRAIN_LAYERS] <= 0.9 * total < deeper:
        raise AssertionError(f"gemma3-12b training: {GEMMA_TRAIN_LAYERS} layers is not the "
                             f"deepest multiple of 6 under 90 % of the card's memory")
    return runs


def _f32_train_path(dev):
    """Qwen3-4B at full width and depth training in float32 with remat:
    Adam as the launcher's (clip 1.0, cosine schedule, lr 3e-4), batch 2 x
    2048 tokens (seed 0), 4 steps through ``train/step.py``, with the launch
    counters set to 0 just before the first step and read just after the
    last: each step 72 f32 forward launches (twice per layer with remat) and
    36 f32 backward launches, none on the bf16 routes. Prints each step's
    seconds, tokens/s, peak memory and loss; the losses must be finite. Then
    one more step under ``torch.profiler`` (``launch/profile.py``'s report):
    device time by kind for its loss and gradients and for its update."""
    from repro_torch import configs
    from repro_torch.data.lm_data import token_batches
    from repro_torch.launch import train
    from repro_torch.train import step as tstep

    flags = train._parser().parse_args(F32_TRAIN_ARGS)
    cfg = dataclasses.replace(configs.get_config(flags.arch, flags.variant), dtype="float32")
    opt = train.optimizer(flags)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = tstep.init_state(cfg, opt, seed=0, device=dev)
    step_fn = tstep.make_train_step(cfg, opt)
    data = token_batches(cfg, batch=flags.batch, seq_len=flags.seq)
    n_params = sum(p.numel() for p in state.params.parameters())
    tokens = flags.batch * flags.seq
    torch.cuda.synchronize()
    _reset_launches()
    losses, secs = [], []
    for i in range(flags.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        print(f"[smoke] f32 train step {i}: {secs[-1]:.3f} s, {tokens / secs[-1]:.0f} tokens/s, "
              f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, loss "
              f"{losses[-1]:.4f}")
    counts = _launches()
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.median(secs[1:]))
    share = 6.0 * n_params * tokens / step_s / F32_FLOPS
    per_step = {"flash_attention_f32": cfg.num_layers * (2 if cfg.remat else 1),
                "flash_attention_bwd": cfg.num_layers, "flash_attention_bwd_f32": cfg.num_layers,
                "flash_attention_bwd_tc": 0, "flash_attention_tc": 0,
                "flash_attention_tc_lse": 0}
    want = {name: n * flags.steps for name, n in per_step.items()}
    got = {name: counts[name] for name in want}
    print(f"[smoke] path train {cfg.name} float32 (train/step.py, Adam as "
          f"{' '.join(F32_TRAIN_ARGS)}): {cfg.num_layers} layers, {n_params / 1e9:.3f} B "
          f"parameters, remat={cfg.remat}; losses {[round(x, 4) for x in losses]}; step "
          f"seconds {[round(x, 3) for x in secs]}; median of steps 1-{flags.steps - 1} "
          f"{step_s:.3f} s, {tokens / step_s:.0f} tokens/s, "
          f"{100 * share:.1f} % of the f32 CUDA-core peak (6 N tokens); peak memory "
          f"{peak / 1e9:.2f} GB; launches {got} (expected {want}: {per_step} a step)")
    if not cfg.remat:
        raise AssertionError(f"{cfg.name}: expected remat on in the full config")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite f32 training loss: {losses}")
    if got != want:
        raise AssertionError(f"f32 train: launched {got}, expected {want}")

    # One more step after the counted ones, under torch.profiler: its loss and
    # gradients and its optimizer update apart, device time by kind of kernel.
    from repro_torch.launch import profile as lprofile
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
    with lprofile._profile() as prof:
        t0 = time.perf_counter()
        _, _, grads = tstep.loss_and_grads(state.params, cfg, batch)
        torch.cuda.synchronize()
        grads_s = time.perf_counter() - t0
    lprofile._report(prof, "f32 train step: loss and gradients", grads_s, 8, kinds=True)
    with lprofile._profile() as prof:
        t0 = time.perf_counter()
        opt.update_(grads, state.opt_state, tstep.leaves(state.params))
        torch.cuda.synchronize()
        update_s = time.perf_counter() - t0
    lprofile._report(prof, "f32 train step: optimizer update", update_s, 3, kinds=True)
    del state, step_fn, grads
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# -- phase 5: the examples -----------------------------------------------------

# train_lm_gossip at the reference's sizes (xLSTM-125M full, 4 pods, batch 8 x
# 128 tokens, gossip every 4 steps), cut from its 100 steps to these.
GOSSIP_EXAMPLE_STEPS = 8


def _example(name: str):
    """``examples_torch/<name>.py`` as the module ``examples_torch.<name>``."""
    import importlib

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module(f"examples_torch.{name}")


def _history_ok(what: str, hist: dict) -> None:
    """Every loss finite, every accuracy and F1 in [0, 1]."""
    if not (all(math.isfinite(x) for x in hist["loss"])
            and all(0.0 <= x <= 1.0 for key in ("acc", "f1") for x in hist[key])):
        raise AssertionError(f"{what}: loss {hist['loss']}, acc {hist['acc']}, f1 {hist['f1']}")


def _example_start() -> float:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    return time.perf_counter()


def _example_end(t0: float) -> tuple:
    torch.cuda.synchronize()
    return time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def _quickstart_example() -> dict:
    """``examples_torch/quickstart.py`` on the card at its own sizes (Cora
    stand-in at scale 0.15, 6 clients, FedGL, 4 steps then ``fit`` for 6
    rounds): losses finite, accuracies in [0, 1], both FGL kernels
    launched, and every round bit for bit a plain ``fit(rounds=10)`` from
    the same initial state."""
    qs = _example("quickstart")
    t0 = _example_start()
    out = qs.main(["--device", "cuda"])
    wall, peak = _example_end(t0)
    counts = _launches()
    got = {key: out["step"][key] + out["fit"][key] for key in ("round", "loss", "acc", "f1")}
    _history_ok("quickstart", got)
    _, plain = out["trainer"].fit(out["batch"], rounds=len(got["round"]))
    same = all(got[key] == plain[key] for key in got)
    print(f"[smoke] example quickstart --device cuda: {wall:.1f} s wall, peak memory "
          f"{peak / 1e9:.3f} GB; launches sage_aggregate {counts['sage_aggregate']}, sim_topk "
          f"{counts['sim_topk']}; rounds 0-3 by step and 4-9 by fit(state=) bit for bit a "
          f"plain fit(rounds=10): {same}")
    if not (counts["sage_aggregate"] > 0 and counts["sim_topk"] > 0):
        raise AssertionError(f"quickstart did not launch the FGL kernels: {counts}")
    if not same:
        raise AssertionError(f"quickstart: step + fit(state=) {got} differ from a plain fit "
                             f"{plain}")
    return counts


def _multiserver_example() -> list:
    """``examples_torch/spreadfgl_multiserver.py`` on the card at its own
    sizes (Citeseer stand-in at scale 0.15, six methods, 12 rounds each),
    each method's ``fit`` with the launch counters set to 0 just before it
    and read just after: losses finite, accuracies in [0, 1],
    ``sage_aggregate`` launched by every method and ``sim_topk`` by those
    with the imputation round (FedGL and both SpreadFGL rows)."""
    from repro_torch.core.fedgl import FGLTrainer

    ms = _example("spreadfgl_multiserver")
    fit, per_fit = FGLTrainer.fit, []

    def counted(self, *args, **kwargs):
        _reset_launches()
        result = fit(self, *args, **kwargs)
        per_fit.append(_launches())
        return result

    t0 = _example_start()
    FGLTrainer.fit = counted
    try:
        out = ms.main(["--device", "cuda"])
    finally:
        FGLTrainer.fit = fit
    wall, peak = _example_end(t0)
    print(f"[smoke] example spreadfgl_multiserver --device cuda: {wall:.1f} s wall, peak "
          f"memory {peak / 1e9:.3f} GB")
    for (name, hist), counts in zip(out["methods"].items(), per_fit, strict=True):
        _history_ok(f"spreadfgl_multiserver {name}", hist)
        imputes = name == "FedGL" or name.startswith("SpreadFGL")
        print(f"[smoke]   {name}: {len(hist['round'])} rounds in {sum(hist['seconds']):.2f} s; "
              f"launches sage_aggregate {counts['sage_aggregate']}, sim_topk "
              f"{counts['sim_topk']}")
        if counts["sage_aggregate"] == 0 or imputes != (counts["sim_topk"] > 0):
            raise AssertionError(f"spreadfgl_multiserver {name}: launches {counts}")
    return per_fit


def _serve_example() -> list:
    """``examples_torch/serve_lm.py`` on the card for each of the ten arch
    ids at its own sizes (smoke config, 4 requests of 16 prompt tokens, 24
    greedy steps; hymba-1.5b at head dim 20 through the padded kernel), its
    launch counters set to 0 just before and read just after: one f32 flash
    launch per attention layer (the smoke configs are f32), and the greedy
    tokens equal to a CPU run's (the script draws its weights on the CPU
    from seed 0, so both devices serve the same model)."""
    from repro_torch import configs

    sl = _example("serve_lm")
    runs = []
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch, "smoke")
        t0 = _example_start()
        out = sl.main(["--arch", arch, "--device", "cuda"])
        wall, peak = _example_end(t0)
        counts = _launches()
        cpu = sl.run(arch, device="cpu")
        same = np.array_equal(out["tokens"], cpu["tokens"])
        flash = {name: counts[name] for name in ("flash_attention_f32", "flash_attention_tc",
                                                 "flash_attention_tc_lse")}
        print(f"[smoke] example serve_lm --arch {arch} --device cuda: head dim {cfg.head_dim}, "
              f"{wall:.2f} s wall, peak memory {peak / 1e9:.3f} GB; flash launches {flash}; "
              f"24 greedy tokens of 4 requests identical to the CPU's: {same}")
        want = {"flash_attention_f32": _attn_layers(cfg), "flash_attention_tc": 0,
                "flash_attention_tc_lse": 0}
        if flash != want:
            raise AssertionError(f"serve_lm {arch}: flash launches {flash}, expected {want}")
        if not same:
            raise AssertionError(f"serve_lm {arch}: the card's greedy tokens "
                                 f"{out['tokens'].tolist()} differ from the CPU's "
                                 f"{cpu['tokens'].tolist()}")
        runs.append(counts)
        del out, cpu
    return runs


def _check_gossip_example(ranks: list, steps: int, gossip_every: int, eps: float) -> float:
    """The pods' reports of ``examples_torch/train_lm_gossip.py``: every
    pod's losses finite; in mode allreduce an exchange after each of the
    ``steps`` steps, after which every pod's parameters have the same
    fingerprint; in mode spread an exchange on each gossip step, which
    changed each pod's parameters (fingerprint after != before). Every
    exchange keeps the pods' mean: for each leaf the pods' summed sums after
    within (1e-5 + ``eps``, the parameters' dtype's) of their summed sums of
    |p| before their summed sums before. Returns the largest such shift, as
    a share of the summed |p|."""
    want = {"allreduce": list(range(steps)),
            "spread": [i for i in range(steps) if (i + 1) % gossip_every == 0]}
    worst = 0.0
    for r, rank in enumerate(ranks):
        losses = rank["allreduce"] + rank["spread"]
        if not (len(losses) == 2 * steps and all(math.isfinite(x) for x in losses)):
            raise AssertionError(f"train_lm_gossip pod {r}: losses {losses}")
    for mode, steps_at in want.items():
        per_pod = [rank["exchanges"][mode] for rank in ranks]
        for r, seen in enumerate(per_pod):
            if [e["step"] for e in seen] != steps_at:
                raise AssertionError(f"train_lm_gossip {mode} pod {r}: exchanges at steps "
                                     f"{[e['step'] for e in seen]}, expected {steps_at}")
        for i, each in zip(steps_at, zip(*per_pod)):
            after = [e["print_after"] for e in each]
            if mode == "allreduce" and len(set(after)) != 1:
                raise AssertionError(f"train_lm_gossip allreduce step {i}: the pods' parameters "
                                     f"differ after the exchange (fingerprints {after})")
            if mode == "spread" and any(e["print_after"] == e["print_before"] for e in each):
                raise AssertionError(f"train_lm_gossip spread step {i}: an exchange left a "
                                     f"pod's parameters as they were")
            before, moved, scale = (np.sum([e[key] for e in each], axis=0)
                                    for key in ("sum_before", "sum_after", "abs_before"))
            shift = float(np.max(np.abs(moved - before) / np.maximum(scale, 1e-30)))
            worst = max(worst, shift)
            if not shift <= 1e-5 + eps:
                raise AssertionError(f"train_lm_gossip {mode} step {i}: the exchange moved the "
                                     f"pods' mean by {shift:.3g} of the summed |p|")
    return worst


def _gossip_example() -> list:
    """``examples_torch/train_lm_gossip.py`` on the card: xLSTM-125M at full
    width, 4 pods sharing the card over gloo, batch 8 x 128 tokens, gossip
    every 4 steps, both modes, cut to ``GOSSIP_EXAMPLE_STEPS`` steps each;
    the pods' reports held by ``_check_gossip_example``. No kernel of the
    port is on its path (the xLSTM has no attention): no launches."""
    from repro_torch import configs

    tl = _example("train_lm_gossip")
    steps, every = GOSSIP_EXAMPLE_STEPS, 4
    eps = torch.finfo(getattr(torch, configs.get_config("xlstm-125m", "full").dtype)).eps
    t0 = time.perf_counter()
    out = tl.run(steps=steps, batch=8, seq=128, gossip_every=every, variant="full", pods=4,
                 device="cuda", timeout=300)
    wall = time.perf_counter() - t0
    worst = _check_gossip_example(out["ranks"], steps, every, eps)
    print(f"[smoke] example train_lm_gossip (xlstm-125m full, 4 pods on one card over gloo, "
          f"8 x 128 tokens, gossip every {every}, {steps} steps a mode): {wall:.1f} s wall "
          f"(pod start included); losses allreduce {[round(x, 4) for x in out['allreduce']]}, "
          f"spread {[round(x, 4) for x in out['spread']]}; pods' fingerprints identical after "
          f"every allreduce step, changed by every spread exchange; the pods' mean kept within "
          f"{worst:.3g} of the summed |p| (limit {1e-5 + eps:.3g}); peak memory a pod "
          f"{[round(r['peak_bytes'] / 1e9, 3) for r in out['ranks']]} GB")
    return []


def _examples_phase() -> list:
    """The four examples of ``examples_torch/`` on the card, each through its
    ``main`` (``train_lm_gossip`` through ``run``, its steps cut)."""
    t0 = time.perf_counter()
    runs = [_quickstart_example()]
    runs += _multiserver_example()
    runs += _serve_example()
    runs += _gossip_example()
    print(f"[smoke] the examples: {time.perf_counter() - t0:.1f} s wall")
    return runs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = _card_line()
    print(f"[smoke] card: {card}")
    print(f"[smoke] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build.load()
    print(f"[smoke] kernels built with nvcc for sm_90a in {time.perf_counter() - t0:.1f} s "
          f"-> {build.library_path().relative_to(ROOT)}")
    ptxas = {}
    for log in sorted(build.library_path().parent.glob("*.ptxas.txt")):
        for line in _ptxas_report(log.read_text()):
            print(f"[smoke] ptxas {log.name.split('.')[0]}: {line}")
            ptxas[line.split(":", 1)[0]] = line.split(":", 1)[1].strip()
    _check_flash_sass(ptxas)

    gen = torch.Generator(device=dev).manual_seed(0)
    sage, sim = _check_sage(dev, gen), _check_sim(dev, gen)
    sim["ring"] = _check_sim_ring(dev, gen)
    flash_tc, flash_f32 = _check_flash(dev, gen)
    flash_tc["cases"] = (_check_flash_cases(dev, gen, D128_CASES)
                         + _check_flash_cases(dev, gen, D64_CASES)
                         + _check_flash_cases(dev, gen, D240_CASES)
                         + _check_flash_cases(dev, gen, D20_CASES))
    block = _check_sim_block(dev, gen)
    flash_lse, flash_bwd, flash_bwd_f32 = _check_flash_bwd(dev, gen)
    fwd_cases, bwd_cases = _check_flash_train_cases(dev, gen, D64_TRAIN_CASES + D240_TRAIN_CASES
                                                    + D20_CASES)
    flash_lse["cases"] += fwd_cases
    flash_bwd["cases"] += bwd_cases
    fwd_cases, flash_bwd_f32["cases"] = _check_flash_f32_cases(
        dev, gen, D64_F32_CASES + D240_F32_CASES + D20_CASES)
    flash_f32["cases"] += fwd_cases
    _check_small_run(dev)
    _check_small_serve(dev)
    _check_bf16_serve(dev)
    _check_small_train(dev)
    _check_whole_step(dev)
    _check_whole_step(dev, "float32")

    # Each path's launches, counted from 0 just before it.
    spread_counts, spread_hist = _main_path(SPREAD_ARGS)
    runs = [spread_counts, _main_path(FEDGL_ARGS)[0]]
    torch.cuda.empty_cache()
    engine_runs, engine_hists = _engine_paths()
    runs += engine_runs
    edge_runs = _edge_paths(spread_hist, engine_hists["spreadfgl_gossip"])
    runs += edge_runs
    serve_measured, train_measured = {}, {}
    runs.append(_serve_main_path(SERVE_ARGS, measured=serve_measured))
    torch.cuda.empty_cache()
    runs.append(_f32_serve_path(dev))
    runs.append(_train_main_path(train_measured))
    _check_dryrun(serve_measured, train_measured, card)
    runs += _spread_train_path()
    runs.append(_f32_train_path(dev))
    runs += _moe_vlm_serve_paths(dev)
    runs.append(_olmoe_train_path(dev))
    runs += _family_paths()
    runs += _gemma_paths(card)
    runs += _examples_phase()
    for entry, counter in ((sage, "sage_aggregate"), (sim, "sim_topk"),
                           (flash_tc, "flash_attention_tc"),
                           (flash_f32, "flash_attention_f32"), (block, "sim_block"),
                           (flash_lse, "flash_attention_tc_lse"),
                           (flash_bwd, "flash_attention_bwd_tc"),
                           (flash_bwd_f32, "flash_attention_bwd_f32")):
        entry["launches"] = sum(run[counter] for run in runs)
    sim["ring"]["launches"] = sum(run["sim_topk"] for run in edge_runs)
    kernels = [sage, sim, flash_tc, flash_f32, block, flash_lse, flash_bwd, flash_bwd_f32]

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
