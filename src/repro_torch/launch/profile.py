"""Where a run's device time goes: a launcher under torch.profiler.

  PYTHONPATH=src python -m repro_torch.launch.profile [--top 15] -- \\
      --dataset coauthor_cs --scale 1.0 --method SpreadFGL --clients 6 \\
      --servers 3 --rounds 3 -K 2
  PYTHONPATH=src python -m repro_torch.launch.profile --launcher serve -- \\
      --arch qwen3-4b --variant full --batch 8 --prompt-len 2048 --steps 64

Runs a launcher with the arguments after ``--`` under ``torch.profiler``
(CPU and CUDA activity), then prints the device time of every CUDA kernel
summed by name, the largest first, each kernel's share of the device time,
and the device's busy share of the timed window: for ``fgl_train`` the
training rounds (device time, less the host-to-device upload of the batch,
over the summed round seconds); for ``serve`` the prefill and the decode
loop after one warm-up prefill, each profiled and reported on its own
(device time over its host seconds, which end in
``torch.cuda.synchronize()``). The profiler's own
cost lengthens the windows, so a busy share is a lower bound. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from typing import Optional, Sequence

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import fgl_train, serve


def _report(prof, label: str, window_s: float, top: int, *, skip_upload: bool = False) -> None:
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total_us = sum(e.self_device_time_total for e in kernels)
    busy_us = sum(e.self_device_time_total for e in kernels
                  if not (skip_upload and e.key.startswith("Memcpy HtoD")))
    print(f"[profile] {label}: device time {total_us / 1e3:.1f} ms in {len(kernels)} "
          f"kernels; window {window_s * 1e3:.1f} ms; device busy "
          f"{busy_us / 1e4 / window_s:.1f}% of the window")
    for e in kernels[:top]:
        print(f"[profile] {e.self_device_time_total / 1e3:10.2f} ms {e.count:6d}x "
              f"{100 * e.self_device_time_total / max(total_us, 1):5.1f}%  {e.key[:100]}")


def _profile():
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    split = argv.index("--") if "--" in argv else len(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--launcher", choices=("fgl_train", "serve"), default="fgl_train")
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

    flags = serve._parser().parse_args(run_args)
    engine, prompts, gen = serve.setup(flags)
    engine.prefill(prompts)     # warm-up: cuBLAS handles, allocator growth
    torch.cuda.synchronize()
    with _profile() as prof:
        t0 = time.perf_counter()
        logits, cache = engine.prefill(prompts)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    _report(prof, f"prefill {flags.batch}x{flags.prompt_len}", prefill_s, args.top)
    with _profile() as prof:
        t0 = time.perf_counter()
        engine.decode(cache, logits, steps=flags.steps, temperature=flags.temperature,
                      generator=gen)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    _report(prof, f"decode {flags.steps} steps", decode_s, args.top)


if __name__ == "__main__":
    main()
