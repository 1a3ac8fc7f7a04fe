"""The benchmark of the PyTorch and CUDA port, one cell per run.

  python3 portbench/run.py --workload spreadfgl-coauthor_cs.k5 --seed 7 \\
      --seconds 30 --trace 0

Reads ``BENCHMARK.json`` at the root of the checkout, and for the cell
named by ``--workload`` its configuration (``portbench/configs/<config>.json``),
its traffic mix (``portbench/traffic/<traffic>.json``), its correctness
limits (``portbench/limits/<workload>.json``) and the driver the
configuration names (``portbench/drivers/<driver>.py``). The driver makes
the inputs from the seed, warms up, runs the measured window and, with
``--trace 1``, a profiled stretch after it, and hands back what it saw;
each metric of the cell is then read by its own reader
(``portbench/metrics/<metric>.py``). A later cell or metric adds files and
``BENCHMARK.json`` entries; this file does not change.

Prints each number compared with the reference beside its limit on
standard error, and, as the last line of standard output, one JSON object
with ``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and
``breakdown`` with ``--trace 1``), the compared numbers last. Exits with a
code other than 0, printing no result, without enough CUDA devices, or if
JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths; one
    host thread for the CPU side of the run, whose cores the card's host
    shares; no JAX behind a library."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    cache = ROOT / "build" / "portbench-cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(k for k in list(sys.modules) if k.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                         device="cuda", start=START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded modules of JAX or the JAX package: {bad}", file=sys.stderr)
        return 3
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
