"""A driver that is not an FGL round, for the harness's tests: the port's LM
training step (``launch.train.setup``, which builds it with
``train.step.make_train_step``) on a configuration of
``repro_torch.configs``, one optimizer step a round. The tests copy it
into a throwaway benchmark tree as ``drivers/<name>.py``; no cell of
``BENCHMARK.json`` uses it.

Configuration keys: ``arch``, ``variant``. Traffic keys: ``batch``,
``seq``, ``first_steps``. Its one check, ``nonfinite_losses``, counts the
first steps' losses that are not finite.
"""
from __future__ import annotations

import math
import time
from typing import Dict, Optional

import torch

from portbench import peaks, trace as trace_lib

CHECKS = ("nonfinite_losses",)
TRAFFIC_KEYS = ("batch", "seq", "first_steps")


def run(cell, *, seed: int, seconds: float, trace: bool, device: str, start: float,
        readers: Dict, fault: Optional[str] = None) -> Dict:
    from repro_torch.data.lm_data import token_batches
    from repro_torch.launch import train
    cfg, traffic = cell.config, cell.traffic
    batch, seq = int(traffic["batch"]), int(traffic["seq"])
    args = train._parser().parse_args(["--arch", cfg["arch"], "--variant", cfg["variant"],
                                       "--device", device, "--batch", str(batch),
                                       "--seq", str(seq)])
    state, step, _ = train.setup(args)
    data = token_batches(state.params.cfg, batch=batch, seq_len=seq, seed=seed)

    def one(state):
        tokens = {k: torch.from_numpy(v).to(device) for k, v in next(data).items()}
        return step(state, tokens)

    losses = []
    for _ in range(int(traffic["first_steps"])):
        state, m = one(state)
        losses.append(float(m["loss"]))
    setup_s = time.perf_counter() - start
    times = []
    w0 = time.perf_counter()
    while not times or time.perf_counter() - w0 < seconds:
        r0 = time.perf_counter()
        state, _ = one(state)
        times.append(time.perf_counter() - r0)
    window_s = time.perf_counter() - w0
    n_params = sum(p.numel() for p in state.params.parameters())
    ctx = {"setup_s": setup_s, "window_s": window_s, "round_times": times, "peak_bytes": 0,
           "checks": {"nonfinite_losses": sum(not math.isfinite(x) for x in losses)},
           "attempted": len(times), "failed": 0,
           "device": {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0},
           "model_flops": 6 * n_params * batch * seq * len(times),
           "peak_flops": peaks.TF32_FLOPS}
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                state, _ = one(state)
            traced_s = time.perf_counter() - t0
        ctx.update(trace=trace_lib.read(prof, [], traced_s), trace_flags=[False] * 3)
    return ctx
