"""Readings the correctness limits are set from, at a cell's own size.

  python3 portbench/calibrate.py --workload spreadfgl-coauthor_cs.k5 \\
      --seeds 1001-1012 --control-seeds 2001-2003 --fault-seeds 3001-3003 \\
      [--faults half_batch,no_exchange,altered_link] [--out FILE]

For each seed the port runs the cell's first rounds (set-up as a run makes
it, no window) and the reference follows them (``judge.py``): the lower
readings. The control is the reference in TF32 in the port's place; each
fault (``drivers/fgl.py``'s ``FAULTS``) is planted in the port: the upper
readings. Prints one JSON line per run, and writes them all to ``--out``.
The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _seeds(text: str) -> list:
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def readings(cell, kind: str, seed: int, device: str) -> dict:
    """One run's numbers: ``kind`` is ``sound``, ``control`` or a fault."""
    import torch
    from portbench import data
    from portbench.drivers import fgl
    cfg, traffic = cell.config, cell.traffic
    plan = data.host_plan(cfg, seed)
    t0 = time.perf_counter()
    if kind == "control":
        snaps = fgl.control_snapshots(cfg, traffic, plan, seed, device)
    else:
        trainer, state, snaps = fgl.first_rounds(cfg, traffic, plan, seed, device,
                                                 None if kind == "sound" else kind)
        del trainer, state
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    nums = fgl.reference_readings(cfg, traffic, plan, seed, device, snaps)
    return {"workload": cell.name, "kind": kind, "seed": seed, "readings": nums,
            "subject_s": t1 - t0, "reference_s": time.perf_counter() - t1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--faults", default="half_batch,no_exchange,altered_link")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench import harness
    rows = []
    for name in args.workload:
        cell = harness.load_cell(ROOT, name)
        runs = ([("sound", s) for s in _seeds(args.seeds)]
                + [("control", s) for s in _seeds(args.control_seeds)]
                + [(f, s) for f in filter(None, args.faults.split(","))
                   for s in _seeds(args.fault_seeds)])
        for kind, seed in runs:
            row = readings(cell, kind, seed, args.device)
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
