#!/usr/bin/env python3
"""The bf16 ``flash_attention`` backward of this checkout against another's, in turns, by kernel.

    python3 tools/flash_bwd_turns.py [--against OTHER_CHECKOUT ...] [--variants]
                                     [--reps N] [--json PATH]

Builds this checkout's kernel library and, for each ``--against`` (for
example the parent commit unpacked under ``build/``: ``git archive HEAD |
tar -x -C build/parent``), that checkout's from its own sources by its own
``kernels/build.py`` into its own ``build/`` directory. Then, at every
training shape of the bf16 backward on the main paths (Qwen3-4B,
OLMoE-1B-7B, Hymba-1.5B's windowed layers, Whisper-medium's decoder at 8 x
448, Gemma3-12B's local and global layers), it holds every build's
gradients against the plain version (each within 2e-2 of its max |grad|,
two runs bit for bit) and times the builds through their C entry points on
the same inputs in turns (this, others, others in reverse, this). Each time
is the device time of one call (its three launches), from a CUDA graph of
``--reps`` calls replayed once; beside it SDPA's backward through autograd
(events over back-to-back calls; with a window, a boolean mask and k, v
repeated to the q heads) and the bounds of the five products the gradient
needs and of the seven this layout computes, at the bf16 peak. Each build's
three kernels (the D pass, dK/dV, dQ) are also timed apart with
``torch.profiler`` over 5 calls, with each kernel's rate over the products
it computes (dK/dV four, dQ three) against the bf16 peak, and the D pass's
over the bytes it moves against the HBM rate. With ``--variants`` it also
builds ``csrc/flash_attention_bwd_tc.cu`` with each design choice of
``VARIANTS`` undone or changed by text substitution (under
``build/flash_bwd_variants/``, each with its ``-Xptxas -v`` registers and
spills and the highest register its SASS touches printed) and times those
builds in the same turns. Prints one JSON line of every number (also
written to ``--json``). Without a CUDA device it exits non-zero; a result
that disagrees exits non-zero too.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (BF16_FLOPS, HBM_BYTES_PER_S, _bound, _card_line,  # noqa: E402
                        _causal_pairs, _kernel_name, _ptxas_report, _time_ms)

# (what, b, hq, hkv, s, d, window)
SHAPES = (("Qwen3-4B training", 2, 32, 8, 2048, 80, None),
          ("OLMoE-1B-7B training", 2, 16, 16, 2048, 128, None),
          ("Hymba-1.5B training, windowed layers", 2, 25, 5, 2048, 64, 1024),
          ("Whisper-medium decoder training", 8, 16, 16, 448, 64, None),
          ("Gemma3-12B training, local layers", 2, 16, 8, 2048, 240, 1024),
          ("Gemma3-12B training, global layers", 2, 16, 8, 2048, 240, None))
# The three launches, by a part of their kernel names (the parent's D = 240
# dK/dV kernel has a name of its own), and the products each computes.
KERNELS = (("D pass", "delta_tc_kernel"), ("dK/dV", "dkdv"), ("dQ", "dq_tc_kernel"))
PRODUCTS = {"dK/dV": 4, "dQ": 3}

_NEXT = "x = gridDim.x + (int)__shfl_sync(FULL, taken, 0);"
_KV_GRID = "kv_blocks < sms ? kv_blocks : sms"
_Q_GRID = "q_blocks < sms ? q_blocks : sms"


def _tiling(kind: str, d: int, fields: str) -> str:
    return f"template <> struct {kind}<{d}> {{ static constexpr int {fields}; }};"


# Each design choice of the kernels, undone or changed: blocks handed out in a
# fixed round-robin instead of from the work counter; one block a CTA (the
# hardware's own order, no persistent CTAs); 128-row q tiles in the dK/dV
# kernel at D <= 64; 128-key tiles in the dQ kernel at D = 64 and 80; two
# stages instead of three at D = 80 and 128.
VARIANTS = {
    "round_robin": {_NEXT: "x += gridDim.x;"},
    "one_block_a_cta": {_KV_GRID: "kv_blocks", _Q_GRID: "q_blocks"},
    "q_tile_128": {_tiling("DkdvTiling", d, "KEYS = 128, BQ = 64, STAGES = 4"):
                   _tiling("DkdvTiling", d, "KEYS = 128, BQ = 128, STAGES = 4") for d in (32, 64)},
    "dq_keys_128": {_tiling("DqTiling", 64, "BKV = 64, STAGES = 4"):
                    _tiling("DqTiling", 64, "BKV = 128, STAGES = 3"),
                    _tiling("DqTiling", 80, "BKV = 64, STAGES = 3"):
                    _tiling("DqTiling", 80, "BKV = 128, STAGES = 2")},
    "stages_2": {**{_tiling("DkdvTiling", d, "KEYS = 128, BQ = 64, STAGES = 3"):
                    _tiling("DkdvTiling", d, "KEYS = 128, BQ = 64, STAGES = 2") for d in (80, 128)},
                 **{_tiling("DqTiling", d, "BKV = 64, STAGES = 3"):
                    _tiling("DqTiling", d, "BKV = 64, STAGES = 2") for d in (80, 128)}},
}


def _registers(lib: Path) -> dict:
    """The highest register each wgmma backward kernel instance of a built
    library touches in its SASS: past 167, the consumers use registers that
    ``setmaxnreg`` moved to them beyond the launch bound's 168."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name = re.search(r"flash_attention_bwd_(dkdv|dq)_tc_kernel<\d+>",
                         _kernel_name(body.split("\n", 1)[0]))
        if name:
            out[name.group()] = max(int(r) for r in re.findall(r"\bR(\d+)\b", body))
    return out


def _variants():
    """``flash_attention_bwd_tc_bf16`` of one build of flash_attention_bwd_tc.cu
    per variant, under build/flash_bwd_variants/<name>/, all nvcc runs at once."""
    from repro_torch.kernels import build

    source = (build.CSRC / "flash_attention_bwd_tc.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs.items():
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in flash_attention_bwd_tc.cu")
            text = text.replace(old, new)
        out = ROOT / "build" / "flash_bwd_variants" / name
        out.mkdir(parents=True, exist_ok=True)
        (out / "flash_attention_bwd_tc.cu").write_text(text)
        shutil.copy(build.CSRC / "hopper.cuh", out / "hopper.cuh")
        procs[name] = (out / "lib.so", subprocess.Popen(
            [build._nvcc(), *build.ARCH, *build.FLAGS, "-Xptxas", "-v", "-shared", "-o",
             str(out / "lib.so"), str(out / "flash_attention_bwd_tc.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        for line in _ptxas_report(log):
            if "_tc_kernel<" in line and "delta" not in line:
                print(f"[turns] variant {name} ptxas {line}")
        print(f"[turns] variant {name} highest register: {_registers(so)}")
        fn = ctypes.CDLL(str(so)).flash_attention_bwd_tc_bf16
        fn.argtypes, fn.restype = build.SIGNATURES["flash_attention_bwd_tc_bf16"]
        fns[f"variant {name}"] = fn
    return fns


def _entry(tree: Path):
    """``flash_attention_bwd_tc_bf16`` of the kernel library that checkout
    ``tree`` builds from its own sources with its own build module."""
    spec = importlib.util.spec_from_file_location(
        f"build_of_{abs(hash(str(tree)))}", tree / "src" / "repro_torch" / "kernels" / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load().flash_attention_bwd_tc_bf16


def _graph_ms(fn, reps: int) -> float:
    """Device ms of one call of ``fn``: a CUDA graph of ``reps`` calls,
    replayed once between two events."""
    fn()
    torch.cuda.synchronize()
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(reps):
                fn()
    torch.cuda.synchronize()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _by_kernel(call) -> dict:
    """Device ms of each of a call's three launches, by torch.profiler over 5
    calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    return {label: sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and mark in e.key) / 5e3
            for label, mark in KERNELS}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, action="append", default=[],
                    help="another checkout whose bf16 backward to time in turns with this one's "
                         "(may be repeated)")
    ap.add_argument("--variants", action="store_true",
                    help="also time builds with each of VARIANTS' design choices undone")
    ap.add_argument("--reps", type=int, default=20, help="calls in each timed graph")
    ap.add_argument("--json", type=Path, help="also write the JSON line here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_turns: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref

    card = _card_line()
    print(f"[turns] card: {card}")
    entries = {"this": _entry(ROOT)}
    print(f"[turns] this highest register: {_registers(build.library_path())}")
    for other in args.against:
        entries[f"other ({other})"] = _entry(other.resolve())
    if args.variants:
        shutil.rmtree(ROOT / "build" / "flash_bwd_variants", ignore_errors=True)
        entries.update(_variants())
    names = list(entries)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results, ok = [], True
    for what, b, hq, hkv, s, d, window in SHAPES:
        q, do = (torch.randn((b, hq, s, d), generator=gen, device=dev).bfloat16()
                 for _ in range(2))
        k, v = (torch.randn((b, hkv, s, d), generator=gen, device=dev).bfloat16()
                for _ in range(2))
        o, lse = kflash.launch(q, k, v, window=window, with_lse=True)
        plain = ref.flash_attention_bwd(q, k, v, o, do, lse, window=window)
        limits = [2e-2 * p.float().abs().max().item() for p in plain]
        delta = torch.empty_like(lse)
        outs = [torch.empty_like(t) for t in (q, k, v)]

        def call(fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs), b, hq, hkv,
                     s, s, d, window or 0, d ** -0.5, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"flash_attention_bwd_tc_bf16 launch failed with error {err}")

        shape = f"q[{b},{hq},{s},{d}] kv[{b},{hkv},{s},{d}] bf16 causal" + (
            f" window {window}" if window else "")
        row = {"what": what, "shape": shape, "max_abs_err": {}, "ms": {n: [] for n in names},
               "by_kernel": {}}
        for name in names:
            call(entries[name])
            torch.cuda.synchronize()
            first = [t.clone() for t in outs]
            call(entries[name])
            torch.cuda.synchronize()
            errs = [(g.float() - p.float()).abs().max().item() for g, p in zip(first, plain)]
            same = all(torch.equal(a, c) for a, c in zip(first, outs))
            row["max_abs_err"][name] = errs
            if not (all(e <= lim for e, lim in zip(errs, limits)) and same):
                ok = False
                print(f"[turns] {what}: {name} disagrees with the plain version: dq, dk, dv "
                      f"{errs} (limits {limits}), two runs bit for bit: {same}")
        del plain, first
        for name in (*names, *reversed(names)):
            row["ms"][name].append(_graph_ms(lambda: call(entries[name]), args.reps))  # noqa: B023
        pairs = b * hq * _causal_pairs(s, s, window)
        io = 2 * (4 * b * hq * s * d + 4 * b * hkv * s * d) + 4 * b * hq * s
        row["bound_ms"], row["bound_by"] = _bound(10.0 * d * pairs, io, peak=BF16_FLOPS)
        row["bound_7_products_ms"] = _bound(14.0 * d * pairs, io, peak=BF16_FLOPS)[0]
        for name in names:
            split = _by_kernel(lambda: call(entries[name]))  # noqa: B023
            rates = {label: 2.0 * n * d * pairs / (split[label] * 1e-3) / BF16_FLOPS
                     for label, n in PRODUCTS.items()}
            d_bytes = 2 * 2 * b * hq * s * d + 4 * b * hq * s
            rates["D pass"] = d_bytes / (split["D pass"] * 1e-3) / HBM_BYTES_PER_S
            row["by_kernel"][name] = {"ms": split, "share_of_peak": rates}
        qg = q.detach().requires_grad_(True)
        if window:      # SDPA's masked kernel takes no GQA: k, v repeated beforehand
            pos = torch.arange(s, device=dev)
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
            kg, vg = (t.repeat_interleave(hq // hkv, dim=1).requires_grad_(True) for t in (k, v))
            sdpa = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
        else:
            kg, vg = k.detach().requires_grad_(True), v.detach().requires_grad_(True)
            sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
        row["sdpa_ms"] = _time_ms(lambda: torch.autograd.grad(  # noqa: B023
            sdpa, (qg, kg, vg), do, retain_graph=True), 10)
        this = min(row["ms"]["this"])
        line = "; ".join(f"{name} {' '.join(f'{t:.4f}' for t in ts)}"
                         for name, ts in row["ms"].items())
        ratios = "".join(f", this / {name} {this / min(ts):.3f}"
                         for name, ts in row["ms"].items() if name != "this")
        print(f"[turns] {what} {shape}: {line} ms{ratios}; SDPA backward {row['sdpa_ms']:.4f} ms; "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, five products; this at "
              f"{row['bound_ms'] / this:.2f} of it), seven products "
              f"{row['bound_7_products_ms']:.4f} ms")
        for name, parts in row["by_kernel"].items():
            print(f"[turns]   {name} by kernel: " + ", ".join(
                f"{label} {parts['ms'][label]:.4f} ms ({100 * parts['share_of_peak'][label]:.1f} "
                f"% of {'the HBM rate' if label == 'D pass' else 'the bf16 peak'})"
                for label, _ in KERNELS))
        results.append(row)
        del q, k, v, o, do, lse, delta, outs, qg, kg, vg, sdpa
        torch.cuda.empty_cache()
    record = {"card": card, "reps": args.reps, "shapes": results}
    line = json.dumps(record)
    print(line)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
