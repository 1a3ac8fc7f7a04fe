"""Where a training run's device time goes: ``fgl_train`` under torch.profiler.

  PYTHONPATH=src python -m repro_torch.launch.profile [--top 15] -- \\
      --dataset coauthor_cs --scale 1.0 --method SpreadFGL --clients 6 \\
      --servers 3 --rounds 3 -K 2

Runs ``repro_torch.launch.fgl_train.main`` with the arguments after ``--``
under ``torch.profiler`` (CPU and CUDA activity), then prints the device
time of every CUDA kernel summed by name, the largest first, each kernel's
share of the device time, and the device's busy share of the training
rounds (device time, less the host-to-device upload of the batch, over the
summed round seconds). The profiler's own cost lengthens the rounds, so
the busy share is a lower bound. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from typing import Optional, Sequence

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import fgl_train


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    split = argv.index("--") if "--" in argv else len(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv[:split])
    train_args = argv[split + 1:]
    if "--device" in train_args and train_args[train_args.index("--device") + 1] != "cuda":
        raise ValueError("profile measures the CUDA device; drop --device")
    if not torch.cuda.is_available():
        raise RuntimeError("profile needs a CUDA device")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        hist = fgl_train.main(train_args)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total_us = sum(e.self_device_time_total for e in kernels)
    # The batch's upload happens in init, before the first round.
    rounds_us = sum(e.self_device_time_total for e in kernels
                    if not e.key.startswith("Memcpy HtoD"))
    rounds_s = sum(hist["seconds"])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[profile] {card}: device time {total_us / 1e3:.1f} ms "
          f"in {len(kernels)} kernels; rounds {rounds_s * 1e3:.1f} ms; "
          f"device busy {rounds_us / 1e4 / rounds_s:.1f}% of the rounds")
    for e in kernels[:args.top]:
        print(f"[profile] {e.self_device_time_total / 1e3:10.2f} ms {e.count:6d}x "
              f"{100 * e.self_device_time_total / max(total_us, 1):5.1f}%  {e.key[:100]}")


if __name__ == "__main__":
    main()
