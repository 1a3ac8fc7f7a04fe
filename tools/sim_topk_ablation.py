#!/usr/bin/env python3
"""Time the CUDA ``sim_topk`` at the FGL main paths' shapes, with its split of
the candidate axis swept and its mechanisms taken out one at a time.

    python3 tools/sim_topk_ablation.py [--against DIR ...]

Needs one CUDA card and ``nvcc``. Prints, for SpreadFGL on Coauthor-CS
(``[3,12246,15]``) and FedGL on Cora (``[1,5484,7]``), k = 4, with the main
path's client layout (client = slot // n_pad) and target mask:

- the time of one ``launch`` call (the wrapper, as the main path calls it)
  and of the two kernels alone, called through the C entry point on
  preallocated buffers, at the chunk count ``plan`` chooses and at others;
- the same at the planned chunks for builds of ``csrc/sim_topk.cu`` with one
  mechanism taken out by its ``SIM_TOPK_ABLATE`` switch, under
  ``build/ablation/``: ``no_insert`` (every score computed and compared,
  none admitted: scoring alone), ``no_shared_bound`` (each chunk's lists see
  no other chunk's), ``no_skip`` (no tile voted out), ``merge_only`` (the
  merge kernel alone, on whatever the workspace holds).

``--against DIR`` (repeatable) builds the ``csrc/sim_topk.cu`` of another
checkout unpacked at DIR (``git archive <commit> | tar -x -C DIR``) under
``build/ablation/against<i>/`` and times its kernels at the planned chunks
in turns with this tree's (this, other, other, this), after checking that
both give the same lists bit for bit. The square call's C entry,
``sim_topk_f32``, has the same signature in every tree since the split.

Each time is the mean of 20 back-to-back calls after one warm-up, by CUDA
events. The ``no_insert`` and ``merge_only`` builds give wrong results by
design and are only timed.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import _card_line, _time_ms  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import sim_topk as ksim  # noqa: E402

# Value of the source's SIM_TOPK_ABLATE switch for each ablation.
ABLATIONS = {"no_insert": 1, "no_shared_bound": 2, "no_skip": 3, "merge_only": 4}


def _ablated_libs(against=()):
    """One shared library per ablation, built from the kernel's source with
    its switch set, under build/ablation/<name>/, and one per other tree in
    ``against`` (build/ablation/against<i>/), all nvcc runs at once."""
    builds = {name: (build.CSRC / "sim_topk.cu", [f"-DSIM_TOPK_ABLATE={value}"])
              for name, value in ABLATIONS.items()}
    for i, tree in enumerate(against):
        src = Path(tree).resolve() / "src" / "repro_torch" / "kernels" / "csrc" / "sim_topk.cu"
        builds[f"against{i}"] = (src, [])
    procs = {}
    for name, (src, defines) in builds.items():
        out = ROOT / "build" / "ablation" / name
        out.mkdir(parents=True, exist_ok=True)
        procs[name] = (out / "lib.so", subprocess.Popen(
            [build._nvcc(), *build.ARCH, *build.FLAGS, *defines,
             "-shared", "-o", str(out / "lib.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on ablation {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn in ("sim_topk_plan", "sim_topk_f32"):
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = build.SIGNATURES[fn]
        libs[name] = lib
    return libs


def _inputs(gen, nb, n, n_pad, c, n_local):
    """chip_smoke.py's sim_topk inputs: class-probability rows, client =
    slot // n_pad, 95 % of each client's first n_local slots targets."""
    h = torch.softmax(3 * torch.randn((nb, n, c), generator=gen, device="cuda"), -1)
    slot = torch.arange(n, device="cuda")
    cid = (slot // n_pad).to(torch.int32)[None].expand(nb, n).contiguous()
    node = (torch.rand((nb, n), generator=gen, device="cuda") < 0.95).float()
    return h, cid, node * ((slot % n_pad) < n_local).float()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", action="append", default=[],
                    help="another checkout's root, timed in turns with this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sim_topk_ablation: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {_card_line()}")
    lib = build.load()
    libs = {"committed": lib, **_ablated_libs(args.against)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    k = 4
    for nb, n, n_pad, c, n_local in ((3, 12246, 6123, 15, 6111), (1, 5484, 914, 7, 902)):
        h, cid, mask = _inputs(gen, nb, n, n_pad, c, n_local)
        chunks, chunk_len, depth = ksim.plan(nb, n, c, k)
        most = max(32, chunks)
        part_v = torch.empty((nb, most, n, depth), dtype=torch.float32, device="cuda")
        part_i = torch.empty((nb, most, n, depth), dtype=torch.int32, device="cuda")
        bound = torch.empty((nb, n), dtype=torch.int32, device="cuda")
        vals = torch.empty((nb, n, k), dtype=torch.float32, device="cuda")
        idx = torch.empty((nb, n, k), dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def call(which, s, length):
            bound.fill_(-2**31)
            err = which.sim_topk_f32(h.data_ptr(), cid.data_ptr(), mask.data_ptr(),
                                     part_v.data_ptr(), part_i.data_ptr(), bound.data_ptr(),
                                     vals.data_ptr(), idx.data_ptr(), nb, n, c, k, s, length,
                                     0, stream)
            build.check(err, "sim_topk")

        shape = f"[{nb},{n},{c}] k={k}"
        rv, ri = ref.sim_topk(h, cid, mask, k)
        wrapper_ms = _time_ms(lambda: ksim.launch(h, cid, mask, k), 20)
        print(f"{shape}: plan chunks={chunks} chunk_len={chunk_len} depth={depth}; "
              f"launch() {wrapper_ms:.4f} ms")
        for s in sorted({chunks, 1, 2, 4, 6, 8, 12, 16, 24, 32}):
            length = -(-(-(-n // s)) // 128) * 128
            if -(-n // length) != s:
                continue
            call(lib, s, length)
            fin = torch.isfinite(rv)
            err = (vals[fin] - rv[fin]).abs().max().item()
            differ = int((idx != ri).sum())
            ms = _time_ms(lambda: call(lib, s, length), 20)  # noqa: B023
            print(f"{shape}: committed chunks={s} chunk_len={length} kernels {ms:.4f} ms "
                  f"(max |score - plain| {err:.3g}, indices differing {differ})")
        for name, which in libs.items():
            if name == "committed" or name.startswith("against"):
                continue
            ms = _time_ms(lambda: call(which, chunks, chunk_len), 20)  # noqa: B023
            print(f"{shape}: {name} chunks={chunks} kernels {ms:.4f} ms")
        for i, tree in enumerate(args.against):
            other = libs[f"against{i}"]
            call(lib, chunks, chunk_len)
            mine = (vals.clone(), idx.clone())
            call(other, chunks, chunk_len)
            same = torch.equal(vals, mine[0]) and torch.equal(idx, mine[1])
            turns = [_time_ms(lambda w=w: call(w, chunks, chunk_len), 20)
                     for w in (lib, other, other, lib)]
            print(f"{shape}: turns this {turns[0]:.4f}, {tree} {turns[1]:.4f}, "
                  f"{tree} {turns[2]:.4f}, this {turns[3]:.4f} ms (kernels); "
                  f"same lists bit for bit: {same}")
            if not same:
                raise AssertionError(f"{tree}'s sim_topk gives other lists")
    return 0


if __name__ == "__main__":
    sys.exit(main())
