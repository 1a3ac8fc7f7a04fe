#!/usr/bin/env python3
"""``sage_aggregate`` of this checkout against another's, in turns, on the FGL paths' inputs.

    python3 tools/sage_turns.py [--against OTHER_CHECKOUT ...] [--reps N] [--json PATH]

Builds this checkout's kernel library and, for each ``--against`` (for
example the parent commit unpacked under ``build/``: ``git archive HEAD |
tar -x -C build/parent``), that checkout's from its own sources by its own
``kernels/build.py``. Then, for both FGL main paths (SpreadFGL on
Coauthor-CS, ``[6,6123,6123]``; FedGL on Cora, ``[6,914,914]``), it takes
two adjacencies: the path's own ``a_norm`` (``fgl_train.build_data`` of
``chip_smoke.py``'s flags, normalised as ``gnn.apply_sage`` does) and
``chip_smoke.py``'s random one (density 2e-3, row-normalised); and for each,
both layers' widths (the features, 6805 or 1433, and the hidden 32), with
random H. At each input every build's output is held against the plain
version (within 1e-5 absolute plus 1e-5 relative) and bit for bit across two
calls, and the builds are timed through their C entry points on the same
inputs in turns (this, others, others in reverse, this). Each time is the
device time of one call, from a CUDA graph of ``--reps`` calls replayed
once. Beside it: the nonzero count, the bytes bound (A and H read once, the
output written once, at the HBM rate; ``2 nnz d`` operations at the f32
peak), and this build's three launches apart (index pass, gather, fix-up)
by ``torch.profiler`` over 5 calls. At Cora's layer 1 it also gives the
host's share: microseconds a call of each build's C entry takes to enqueue
(200 calls back to back), and of this checkout's wrapper
(``sage_aggregate.launch``, which also takes the output and the scratch
from the caching allocator). Prints one JSON line of every number (also
written to ``--json``). Without a CUDA device it exits non-zero; a
result that disagrees exits non-zero too.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import FEDGL_ARGS, SPREAD_ARGS, _bound, _card_line  # noqa: E402
from flash_bwd_turns import _by_kernel, _graph_ms  # noqa: E402

# (what, the launcher's flags, the layers' widths)
PATHS = (("SpreadFGL Coauthor-CS", SPREAD_ARGS, (6805, 32)),
         ("FedGL Cora", FEDGL_ARGS, (1433, 32)))
RANDOM_DENSITY = 2e-3        # chip_smoke.py's random adjacency
KERNELS = (("index", "sage_index_kernel"), ("gather", "sage_gather_kernel"),
           ("fix-up", "sage_fixup_kernel"))


def _library(tree: Path):
    """The kernel library that checkout ``tree`` builds from its own sources
    with its own build module."""
    spec = importlib.util.spec_from_file_location(
        f"build_of_{abs(hash(str(tree)))}", tree / "src" / "repro_torch" / "kernels" / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load()


def _caller(lib, adj, h, out):
    """One call of ``lib``'s entry on these tensors: a build with a scratch
    argument gets its own buffer, one from before it takes none."""
    m, n, d = h.shape
    scratch = []
    if hasattr(lib, "sage_aggregate_scratch_bytes"):
        scratch.append(torch.empty(lib.sage_aggregate_scratch_bytes(m, n, d),
                                   dtype=torch.uint8, device=h.device))

    def call():
        err = lib.sage_aggregate_f32(adj.data_ptr(), h.data_ptr(), out.data_ptr(),
                                     *(t.data_ptr() for t in scratch), m, n, d,
                                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"sage_aggregate launch failed with error {err}")
    return call


def _host_us(fn, calls: int = 200) -> float:
    """Host microseconds to enqueue one call of ``fn``, over ``calls`` back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    spent = time.perf_counter() - t0
    torch.cuda.synchronize()
    return spent / calls * 1e6


def _adjacencies(flags, gen):
    """The path's own a_norm and the random adjacency of its shape, on the card."""
    from repro_torch.core import gnn
    from repro_torch.launch import fgl_train

    batch, _, _ = fgl_train.build_data(fgl_train.parse(flags))
    adj = torch.as_tensor(batch.adj).cuda()
    mask = torch.as_tensor(batch.node_mask).cuda()
    own = gnn.normalize_adjacency(adj, mask)
    del adj, mask
    a = (torch.rand(own.shape, generator=gen, device="cuda") < RANDOM_DENSITY).float()
    return {"main path a_norm": own,
            "random A": a / torch.clamp_min(a.sum(-1, keepdim=True), 1.0)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, action="append", default=[],
                    help="another checkout whose sage_aggregate to time in turns with this "
                         "one's (may be repeated)")
    ap.add_argument("--reps", type=int, default=20, help="calls in each timed graph")
    ap.add_argument("--json", type=Path, help="also write the JSON line here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sage_turns: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import ref
    from repro_torch.kernels import sage_aggregate as ksage

    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card_line()
    print(f"[sage] card: {card}")
    libs = {"this": _library(ROOT)}
    for other in args.against:
        libs[f"other ({other})"] = _library(other.resolve())
    names = list(libs)
    gen = torch.Generator(device="cuda").manual_seed(0)
    results, ok, host = [], True, {}
    for what, flags, widths in PATHS:
        for kind, adj in _adjacencies(flags, gen).items():
            m, n, _ = adj.shape
            nnz = int((adj != 0).sum().item())
            row_max = int((adj != 0).sum(-1).max().item())
            for d in widths:
                h = torch.randn((m, n, d), generator=gen, device="cuda")
                want = ref.sage_aggregate(adj, h)
                outs = {name: torch.empty_like(h) for name in names}
                calls = {name: _caller(lib, adj, h, outs[name]) for name, lib in libs.items()}
                shape = f"[{m},{n},{n}]x[{m},{n},{d}]"
                row = {"path": what, "adjacency": kind, "shape": shape, "nnz": nnz,
                       "row_max": row_max, "max_abs_err": {}, "ms": {x: [] for x in names}}
                for name in names:
                    calls[name]()
                    torch.cuda.synchronize()
                    first = outs[name].clone()
                    calls[name]()
                    torch.cuda.synchronize()
                    err = (first - want).abs()
                    row["max_abs_err"][name] = err.max().item()
                    same = torch.equal(first, outs[name])
                    if not (bool((err <= 1e-5 + 1e-5 * want.abs()).all()) and same):
                        ok = False
                        print(f"[sage] {what} {kind} {shape}: {name} disagrees: max |err| "
                              f"{row['max_abs_err'][name]:.3g}, two calls bit for bit: {same}")
                    del first, err
                for name in (*names, *reversed(names)):
                    row["ms"][name].append(_graph_ms(calls[name], args.reps))
                row["by_kernel"] = _by_kernel(calls["this"], KERNELS)
                row["bound_ms"], row["bound_by"] = _bound(
                    2.0 * nnz * d, 4.0 * (m * n * n + 2 * m * n * d))
                this = min(row["ms"]["this"])
                times = "; ".join(f"{x} {' '.join(f'{t:.4f}' for t in ts)}"
                                  for x, ts in row["ms"].items())
                ratios = "".join(f", this / {x} {this / min(ts):.4f}"
                                 for x, ts in row["ms"].items() if x != "this")
                parts = ", ".join(f"{label} {ms:.4f}" for label, ms in row["by_kernel"].items())
                print(f"[sage] {what}, {kind} ({nnz} nonzeros, at most {row_max} a row) {shape}: "
                      f"{times} ms{ratios}; this by kernel: {parts} ms; bound "
                      f"{row['bound_ms']:.4f} ms ({row['bound_by']}; this at "
                      f"{this / row['bound_ms']:.2f}x)")
                if what == "FedGL Cora" and kind == "main path a_norm" and d == widths[0]:
                    for name in (*names, *reversed(names)):
                        host.setdefault(name, []).append(_host_us(calls[name]))
                    host["this, through the wrapper"] = [
                        _host_us(lambda: ksage.launch(adj, h))]  # noqa: B023
                    print(f"[sage] host us a call at {shape}: " + "; ".join(
                        f"{x} {' '.join(f'{t:.1f}' for t in ts)}" for x, ts in host.items()))
                results.append(row)
                del h, want, outs, calls
                torch.cuda.empty_cache()
            del adj
        torch.cuda.empty_cache()
    record = {"card": card, "reps": args.reps, "inputs": results, "host_us": host}
    line = json.dumps(record)
    print(line)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
