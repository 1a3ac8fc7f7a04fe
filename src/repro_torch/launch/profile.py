"""Where a run's device time goes: a launcher under torch.profiler.

  PYTHONPATH=src python -m repro_torch.launch.profile [--top 15] -- \\
      --dataset coauthor_cs --scale 1.0 --method SpreadFGL --clients 6 \\
      --servers 3 --rounds 3 -K 2
  PYTHONPATH=src python -m repro_torch.launch.profile --launcher serve -- \\
      --arch qwen3-4b --variant full --batch 8 --prompt-len 2048 --steps 64
  PYTHONPATH=src python -m repro_torch.launch.profile --launcher train -- \\
      --arch qwen3-4b --variant full --batch 2 --seq 2048 --steps 2

Runs a launcher with the arguments after ``--`` under ``torch.profiler``
(CPU and CUDA activity), then prints the device time of every CUDA kernel
summed by name, the largest first, each kernel's share of the device time,
and the device's busy share of the timed window: for ``fgl_train`` the
training rounds (device time, less the host-to-device upload of the batch,
over the summed round seconds); for ``serve`` the prefill and the decode
loop after one warm-up prefill, each profiled and reported on its own
(device time over its host seconds, which end in
``torch.cuda.synchronize()``); for ``train`` one step after a warm-up step,
its loss and gradients and its optimizer update profiled apart, each also
summed by kind of kernel (GEMMs, attention forward and backward, the rest).
Where the run passes through MoE layers, each report also gives the device
time of the kernels launched inside each of ``models.moe``'s ranges
(``moe.router``: gates and top-k; ``moe.dispatch``; ``moe.experts``: the
expert GEMMs and their activation; ``moe.combine``); likewise the mamba
scan (``ssm.scan``, ``ssm.step`` in decode), the xLSTM recurrences
(``xlstm.mlstm``, ``xlstm.slstm``), the plain cross-attention
(``attention.cross``: the vlm's and whisper's memory k/v and attention,
and whisper's encoder self-attention) and whisper's ``encoder``; and the
distributed edge layer's ``ring_topk.fold`` (one ``sim_topk`` call on a
visiting slab), ``ring_topk.rotate`` (a slab sent to the next rank) and
``gossip.exchange`` (parameters or boundary slices sent to neighbors), each
also with its host time, the time in collectives (run ``fgl_train
--edge-mesh --sim-shard`` under ``torchrun``: each rank reports its own);
and the FGL round's layers (``fgl.round``, ``fgl.local``, ``fgl.impute``
and its ``fgl.impute.*`` parts, ``fgl.aggregate``, ``fgl.evaluate``) and
kernels (``kernel.sage_aggregate``, ``kernel.sim_topk``). All of them are
the port's spans (``repro_torch.trace``). The busy share is the union of
the kernels' intervals, so kernels that overlap count once. The
profiler's own cost lengthens the windows, so a busy share is a lower
bound. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from typing import Iterable, Optional, Sequence, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import fgl_train, serve, train
from repro_torch.train import step as train_step

# Kinds of kernel by name: cuBLAS's and CUTLASS's products, the port's
# attention kernels (backward first: its names contain the forward's).
_KINDS = (("attention TF32 split (f32 pre-passes)", ("tf32_split",)),
          ("attention backward", ("flash_attention_bwd",)),
          ("attention forward", ("flash_attention",)),
          ("GEMMs", ("gemm", "xmma", "nvjet", "cutlass", "cublas")),
          ("copies and fills", ("memcpy", "memset")))


# Ranges of the port's spans (repro_torch.trace): their device time is that
# of the kernels launched inside them, never a kernel of its own. The
# encoder's range holds its self-attention's "attention.cross" ranges; the
# FGL round's "fgl." ranges nest as its layers, "kernel." ones in them.
_RANGES = ("moe.", "ssm.", "xlstm.", "attention.cross", "encoder", "ring_topk.", "gossip.",
           "fgl.", "kernel.")


def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of ``(start, end)`` intervals: the time in
    which at least one of them ran, overlapping kernels counted once."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _kind(name: str) -> str:
    low = name.lower()
    for kind, marks in _KINDS:
        if any(m in low for m in marks):
            return kind
    return "elementwise and reductions"


def _report(prof, label: str, window_s: float, top: int, *, skip_upload: bool = False,
            kinds: bool = False) -> None:
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and not e.key.startswith(_RANGES)]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total_us = sum(e.self_device_time_total for e in kernels)
    busy = busy_us((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not e.name.startswith(_RANGES)
                   and not (skip_upload and e.name.startswith("Memcpy HtoD")))
    print(f"[profile] {label}: device time {total_us / 1e3:.1f} ms in {len(kernels)} "
          f"kernels; window {window_s * 1e3:.1f} ms; device busy "
          f"{busy / 1e4 / window_s:.1f}% of the window")
    for e in kernels[:top]:
        print(f"[profile] {e.self_device_time_total / 1e3:10.2f} ms {e.count:6d}x "
              f"{100 * e.self_device_time_total / max(total_us, 1):5.1f}%  {e.key[:100]}")
    if kinds:
        by_kind = {}
        for e in kernels:
            by_kind[_kind(e.key)] = by_kind.get(_kind(e.key), 0) + e.self_device_time_total
        for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
            print(f"[profile] {label} by kind: {kind}: {us / 1e3:.2f} ms "
                  f"({100 * us / max(total_us, 1):.1f}%)")
    for e in sorted((e for e in events if e.device_type == DeviceType.CPU
                     and e.key.startswith(_RANGES)), key=lambda e: e.key):
        print(f"[profile] {label} range {e.key}: {e.device_time_total / 1e3:.2f} ms of device "
              f"time in {e.count} calls ({100 * e.device_time_total / max(total_us, 1):.1f}%), "
              f"{e.cpu_time_total / 1e3:.2f} ms of host time")


def _profile():
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    split = argv.index("--") if "--" in argv else len(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--launcher", choices=("fgl_train", "serve", "train"),
                    default="fgl_train")
    args = ap.parse_args(argv[:split])
    run_args = argv[split + 1:]
    if "--device" in run_args and run_args[run_args.index("--device") + 1] != "cuda":
        raise ValueError("profile measures the CUDA device; drop --device")
    if not torch.cuda.is_available():
        raise RuntimeError("profile needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[profile] {card}")

    if args.launcher == "fgl_train":
        with _profile() as prof:
            hist = fgl_train.main(run_args)
            torch.cuda.synchronize()
        # The batch's upload happens in init, before the first round.
        _report(prof, "training rounds", sum(hist["seconds"]), args.top, skip_upload=True)
        return

    if args.launcher == "train":
        _profile_train(run_args, args.top)
        return

    flags = serve._parser().parse_args(run_args)
    engine, prompts, memory, gen = serve.setup(flags)
    engine.prefill(prompts, memory)     # warm-up: cuBLAS handles, allocator growth
    torch.cuda.synchronize()
    with _profile() as prof:
        t0 = time.perf_counter()
        logits, cache = engine.prefill(prompts, memory)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    _report(prof, f"prefill {flags.batch}x{flags.prompt_len}", prefill_s, args.top, kinds=True)
    with _profile() as prof:
        t0 = time.perf_counter()
        engine.decode(cache, logits, steps=flags.steps, temperature=flags.temperature,
                      generator=gen)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    _report(prof, f"decode {flags.steps} steps", decode_s, args.top)


def _profile_train(run_args, top: int) -> None:
    """One warm-up step, then one step: its loss and gradients, and its
    optimizer update, each profiled and reported on its own."""
    flags = train._parser().parse_args(run_args)
    state, step, data = train.setup(flags)
    model = state.params
    batches = [{k: torch.from_numpy(v).cuda() for k, v in next(data).items()} for _ in range(2)]
    state, _ = step(state, batches[0])   # warm-up: cuBLAS handles, allocator growth
    torch.cuda.synchronize()
    with _profile() as prof:
        t0 = time.perf_counter()
        _, _, grads = train_step.loss_and_grads(model, model.cfg, batches[1], flags.microbatch)
        torch.cuda.synchronize()
        grads_s = time.perf_counter() - t0
    _report(prof, "loss and gradients", grads_s, top, kinds=True)
    opt = train.optimizer(flags)
    with _profile() as prof:
        t0 = time.perf_counter()
        opt.update_(grads, state.opt_state, train_step.leaves(model))
        torch.cuda.synchronize()
        update_s = time.perf_counter() - t0
    _report(prof, "optimizer update", update_s, top, kinds=True)
    print(f"[profile] step: {grads_s + update_s:.3f} s of host time "
          f"(loss and gradients {grads_s:.3f} s, update {update_s:.3f} s), peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


if __name__ == "__main__":
    main()
