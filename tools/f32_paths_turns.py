#!/usr/bin/env python3
"""The f32 Qwen3-4B prefill and training step of this checkout against another's, in turns.

    python3 tools/f32_paths_turns.py --against OTHER_CHECKOUT [--rounds N] [--json PATH]

Runs each checkout's own ``chip_smoke.py`` phases ``_f32_serve_path`` (Qwen3-4B
at full width and depth in float32, batch 2 x 2048-token prompts: a prefill
and 8 decode steps through the f32 ``flash_attention`` route, then the same
with the plain version, the logits held within 1e-4 of max |logit|) and
``_f32_train_path`` (4 training steps in float32, batch 2 x 2048, remat,
Adam; the median of steps 1-3, then a profiled fifth step), the serving
phase twice (the first run warms the process up; the second's prefill is
kept), each checkout in
a process of its own that builds its kernels from its own sources, in turns
(this, other, other, this; ``--rounds`` repeats the four). Prints each run's
prefill seconds through the kernel, median step seconds and the device time
the profiled step's loss and gradients take and their attention forward and
backward kernels' share of it, the f32 pre-passes (``tf32_split_kernel``,
forward's and backward's) apart (``launch/profile.py``'s kinds), then
one JSON line of every number (also written to ``--json``). The numbers are
host seconds ending in ``torch.cuda.synchronize``, as ``chip_smoke.py``
prints them. Without a CUDA device it exits non-zero, and so does a run
whose phase fails.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# One process: a checkout's chip_smoke.py phases on the card.
RUN = """
import sys
sys.path.insert(0, {tree!r})
import torch
import chip_smoke
from repro_torch.kernels import build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.load()
dev = torch.device("cuda")
chip_smoke._f32_serve_path(dev)
chip_smoke._f32_serve_path(dev)
chip_smoke._f32_train_path(dev)
"""


def _run(tree: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", RUN.format(tree=str(tree))], cwd=tree,
                         capture_output=True, text=True, timeout=1200)
    log = out.stdout + out.stderr
    if out.returncode != 0:
        raise RuntimeError(f"{tree}: the f32 phases failed:\n{log[-6000:]}")
    # The second serve run's prefill: the first warms the process up.
    prefill = float(re.findall(r"prefill (\d+\.\d+) s through the f32 route", log)[-1])
    step = float(re.search(r"median of steps \S+ (\d+\.\d+) s", log).group(1))
    # The profiled step's loss and gradients: device time, and its attention
    # forward and backward kernels' (launch/profile.py's kinds).
    kinds = ("attention forward", "attention backward", r"attention TF32 split \(f32 pre-passes\)")
    flash = {kind.split(" (")[0].replace("\\", ""): float(m.group(1)) for kind in kinds
             for m in [re.search(rf"loss and gradients by kind: {kind}: (\d+\.\d+) ms", log)]
             if m}
    flash["device"] = float(re.search(r"loss and gradients: device time (\d+\.\d+) ms",
                                      log).group(1))
    return {"prefill_s": prefill, "step_s": step, "flash_ms": flash,
            "log_tail": [ln for ln in log.splitlines() if "[smoke]" in ln][-12:]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, required=True,
                    help="another checkout to run in turns with this one")
    ap.add_argument("--rounds", type=int, default=1, help="turns of (this, other, other, this)")
    ap.add_argument("--json", type=Path, help="also write the JSON line here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("f32_paths_turns: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import _card_line

    card = _card_line()
    print(f"[paths] card: {card}")
    trees = {"this": ROOT, "other": args.against.resolve()}
    runs = {"this": [], "other": []}
    for _ in range(args.rounds):
        for name in ("this", "other", "other", "this"):
            r = _run(trees[name])
            runs[name].append(r)
            print(f"[paths] {name}: f32 prefill {r['prefill_s']:.3f} s, training step (median "
                  f"of steps 1-3) {r['step_s']:.3f} s; the profiled step's loss and gradients "
                  f"{ {k: round(v, 3) for k, v in r['flash_ms'].items()} } ms", flush=True)
    record = {"card": card, "other": str(trees["other"]),
              "runs": {name: [{k: v for k, v in r.items() if k != "log_tail"} for r in rs]
                       for name, rs in runs.items()}}
    line = json.dumps(record)
    print(line)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
