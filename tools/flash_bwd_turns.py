#!/usr/bin/env python3
"""The ``flash_attention`` backward of this checkout against another's, in turns, by kernel.

    python3 tools/flash_bwd_turns.py [--dtype bfloat16|float32] [--against OTHER_CHECKOUT ...]
                                     [--variants] [--reps N] [--json PATH]

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

``--dtype float32`` does the same for the f32 route
(``csrc/flash_attention_bwd.cu``, 3-pass TF32): the same shapes in float32,
each build's gradients within 1e-5 of their max |grad| of the formula in
float64 (or within the plain f32 version's own error, where that is larger)
and bit for bit across two runs, SDPA's f32 backward beside them, the bounds
of three TF32 passes of the five and the seven products at the TF32 peak,
each build's launches apart (the pre-pass that splits the operands, where a
build has one, the D pass, dK/dV, dQ) with dK/dV's and dQ's rates over their
three-pass products against the TF32 peak, and with ``--variants`` the
builds of ``F32_VARIANTS`` (``csrc/flash_attention_bwd.cu`` with a design
choice changed, under ``build/flash_bwd_variants/``).
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

from chip_smoke import (BF16_FLOPS, HBM_BYTES_PER_S, TF32_FLOPS, _bound,  # noqa: E402
                        _card_line, _causal_pairs, _kernel_name, _ptxas_report, _time_ms)

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
# The f32 route's launches: the pre-pass (none in builds before it;
# flash_attention_bwd_split_kernel until it moved to tf32.cuh as
# tf32_split_kernel), the D pass, dK/dV (the parent's D = 240 instance has a
# name of its own) and dQ.
F32_KERNELS = (("pre-pass", "split_kernel"), ("D pass", "bwd_delta_kernel"),
               ("dK/dV", "dkdv"), ("dQ", "bwd_dq"))

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



def _f32_tiling(d: int, fields: str) -> str:
    return (f"template <> struct F32Tiling<{d}> {{\n  static constexpr int {fields};\n}};")


_F32 = {80: "BT = 32, STAGES = 3, DCH = 80, HOLD = 1"}


def _f32_change(d: int, **fields) -> dict:
    """A substitution of F32Tiling<d>'s fields."""
    new = _F32[d]
    for name, value in fields.items():
        new = re.sub(rf"{name} = \d+", f"{name} = {value}", new)
    return {_f32_tiling(d, _F32[d]): _f32_tiling(d, new)}


# Design choices of the f32 kernels, changed: one consumer warpgroup a CTA
# instead of two taking the tiles in turn; the resident operand split at use
# at D = 80 (its fragments held in registers in the kernel); four stages and
# one inbox buffer a consumer at D = 80 (three and two in the kernel); two
# stages at D = 80; 16-row tiles at D = 80; the resident operand split two
# k-steps at a time where it is split at use, D = 128 and 240 (four in the
# kernel).
F32_VARIANTS = {
    "one_consumer": {"constexpr int CONSUMERS = 2;": "constexpr int CONSUMERS = 1;"},
    "split_at_use_at_80": _f32_change(80, HOLD=0),
    "stages_4_pbuf_1_at_80": {**_f32_change(80, STAGES=4),
                              "constexpr int PBUF = 2;": "constexpr int PBUF = 1;"},
    "stages_2_at_80": _f32_change(80, STAGES=2),
    "bt_16_at_80": _f32_change(80, BT=16, STAGES=4),
    "kch_2": {"constexpr int KCH = 4;": "constexpr int KCH = 2;"},
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
        name = re.search(r"flash_attention_bwd_(dkdv|dq)_(tc|f32)_kernel<\d+>",
                         _kernel_name(body.split("\n", 1)[0]))
        if name:
            out[name.group()] = max(int(r) for r in re.findall(r"\bR(\d+)\b", body))
    return out


def _variants(f32: bool):
    """The backward entry (and the library) of one build of the route's
    source per variant, under build/flash_bwd_variants/<name>/, all nvcc
    runs at once."""
    from repro_torch.kernels import build

    src = "flash_attention_bwd.cu" if f32 else "flash_attention_bwd_tc.cu"
    entry = "flash_attention_bwd_f32" if f32 else "flash_attention_bwd_tc_bf16"
    source = (build.CSRC / src).read_text()
    procs = {}
    for name, subs in (F32_VARIANTS if f32 else VARIANTS).items():
        text = source
        for old, new in subs.items():
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in {src}")
            text = text.replace(old, new)
        out = ROOT / "build" / "flash_bwd_variants" / name
        out.mkdir(parents=True, exist_ok=True)
        (out / src).write_text(text)
        for header in build.CSRC.glob("*.cuh"):
            shutil.copy(header, out / header.name)
        procs[name] = (out / "lib.so", subprocess.Popen(
            [build._nvcc(), *build.ARCH, *build.FLAGS, "-Xptxas", "-v", "-shared", "-o",
             str(out / "lib.so"), str(out / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        for line in _ptxas_report(log):
            if re.search(r"_(tc|f32)_kernel<", line) and "delta" not in line:
                print(f"[turns] variant {name} ptxas {line}")
        print(f"[turns] variant {name} highest register: {_registers(so)}")
        lib = ctypes.CDLL(str(so))
        _bind(lib)
        fns[f"variant {name}"] = (lib, getattr(lib, entry))
    return fns


def _bind(lib) -> None:
    """The argument and result types of the backward's C entries in ``lib``."""
    from repro_torch.kernels import build

    for name in ("flash_attention_bwd_tc_bf16", "flash_attention_bwd_f32",
                 "flash_attention_bwd_f32_scratch"):
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = build.SIGNATURES[name]


def _entry(tree: Path, f32: bool):
    """The library that checkout ``tree`` builds from its own sources with
    its own build module, and its backward entry of the route."""
    spec = importlib.util.spec_from_file_location(
        f"build_of_{abs(hash(str(tree)))}", tree / "src" / "repro_torch" / "kernels" / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = mod.load()
    _bind(lib)
    return lib, getattr(lib, "flash_attention_bwd_f32" if f32 else "flash_attention_bwd_tc_bf16")


def _scratch_floats(lib, f32: bool, b: int, hq: int, hkv: int, s: int, d: int) -> int:
    """Floats of the scratch `delta` that a build's entry takes: D alone, or
    for an f32 build with a pre-pass its split planes too."""
    if f32 and hasattr(lib, "flash_attention_bwd_f32_scratch"):
        return lib.flash_attention_bwd_f32_scratch(b, hq, hkv, s, s, d)
    return b * hq * s


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


def _by_kernel(call, kernels) -> dict:
    """Device ms of each of a call's launches, by torch.profiler over 5
    calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    return {label: sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and mark in e.key) / 5e3
            for label, mark in kernels}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="the route to time: bf16 (flash_attention_bwd_tc.cu) or f32 "
                         "(flash_attention_bwd.cu)")
    ap.add_argument("--against", type=Path, action="append", default=[],
                    help="another checkout whose backward to time in turns with this one's "
                         "(may be repeated)")
    ap.add_argument("--variants", action="store_true",
                    help="also time builds with each of the route's design choices changed")
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

    f32 = args.dtype == "float32"
    dtype = torch.float32 if f32 else torch.bfloat16
    kernels = F32_KERNELS if f32 else KERNELS
    passes, peak, peak_name = (3, TF32_FLOPS, "the TF32 peak") if f32 else (
        1, BF16_FLOPS, "the bf16 peak")
    card = _card_line()
    print(f"[turns] card: {card}; {args.dtype}")
    entries = {"this": _entry(ROOT, f32)}
    print(f"[turns] this highest register: {_registers(build.library_path())}")
    for other in args.against:
        entries[f"other ({other})"] = _entry(other.resolve(), f32)
    if args.variants:
        shutil.rmtree(ROOT / "build" / "flash_bwd_variants", ignore_errors=True)
        entries.update(_variants(f32))
    names = list(entries)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results, ok = [], True
    for what, b, hq, hkv, s, d, window in SHAPES:
        q, do = (torch.randn((b, hq, s, d), generator=gen, device=dev).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn((b, hkv, s, d), generator=gen, device=dev).to(dtype)
                for _ in range(2))
        o, lse = kflash.launch(q, k, v, window=window, with_lse=True)
        plain = ref.flash_attention_bwd(q, k, v, o, do, lse, window=window)
        if f32:
            # Within 1e-5 of max |grad| of the formula in float64, or within
            # the plain f32 version's own error where that is larger.
            exact = ref.flash_attention_bwd(*(t.double() for t in (q, k, v, o, do, lse)),
                                            window=window)
            limits = [max(1e-5 * p.abs().max().item(), (p.double() - e).abs().max().item())
                      for p, e in zip(plain, exact)]
            want = exact
        else:
            limits = [2e-2 * p.float().abs().max().item() for p in plain]
            want = plain
        scratch = {name: torch.empty(_scratch_floats(lib, f32, b, hq, hkv, s, d),
                                     dtype=torch.float32, device=dev)
                   for name, (lib, _) in entries.items()}
        outs = [torch.empty_like(t) for t in (q, k, v)]

        def call(name):
            err = entries[name][1](
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                lse.data_ptr(), scratch[name].data_ptr(), *(t.data_ptr() for t in outs), b, hq,
                hkv, s, s, d, window or 0, d ** -0.5, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: flash_attention backward ({args.dtype}) launch "
                                   f"failed with error {err}")

        shape = f"q[{b},{hq},{s},{d}] kv[{b},{hkv},{s},{d}] {args.dtype} causal" + (
            f" window {window}" if window else "")
        row = {"what": what, "shape": shape, "max_abs_err": {}, "ms": {n: [] for n in names},
               "by_kernel": {}}
        for name in names:
            call(name)
            torch.cuda.synchronize()
            first = [t.clone() for t in outs]
            call(name)
            torch.cuda.synchronize()
            errs = [(g.double() - w.double()).abs().max().item() for g, w in zip(first, want)]
            same = all(torch.equal(a, c) for a, c in zip(first, outs))
            row["max_abs_err"][name] = errs
            if not (all(e <= lim for e, lim in zip(errs, limits)) and same):
                ok = False
                print(f"[turns] {what}: {name} disagrees: dq, dk, dv {errs} (limits {limits}), "
                      f"two runs bit for bit: {same}")
        del plain, want, first
        if f32:
            del exact
        torch.cuda.empty_cache()
        for name in (*names, *reversed(names)):
            row["ms"][name].append(_graph_ms(lambda: call(name), args.reps))  # noqa: B023
        pairs = b * hq * _causal_pairs(s, s, window)
        size = q.element_size()
        io = size * (4 * b * hq * s * d + 4 * b * hkv * s * d) + 4 * b * hq * s
        row["bound_ms"], row["bound_by"] = _bound(passes * 10.0 * d * pairs, io, peak=peak)
        row["bound_7_products_ms"] = _bound(passes * 14.0 * d * pairs, io, peak=peak)[0]
        for name in names:
            split = _by_kernel(lambda: call(name), kernels)  # noqa: B023
            rates = {label: 2.0 * passes * n * d * pairs / (split[label] * 1e-3) / peak
                     if split[label] else 0.0 for label, n in PRODUCTS.items()}
            d_bytes = 2 * size * b * hq * s * d + 4 * b * hq * s
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
                f"{label} {parts['ms'][label]:.4f} ms" + (
                    f" ({100 * parts['share_of_peak'][label]:.1f} % of "
                    f"{'the HBM rate' if label == 'D pass' else peak_name})"
                    if label in parts["share_of_peak"] else "")
                for label, _ in kernels))
        results.append(row)
        del q, k, v, o, do, lse, scratch, outs, qg, kg, vg, sdpa
        torch.cuda.empty_cache()
    record = {"card": card, "dtype": args.dtype, "reps": args.reps, "shapes": results}
    line = json.dumps(record)
    print(line)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
