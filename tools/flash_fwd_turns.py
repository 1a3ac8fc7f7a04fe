#!/usr/bin/env python3
"""The ``flash_attention`` forward of this checkout against another's, in turns.

    python3 tools/flash_fwd_turns.py [--dtype bfloat16|float32] [--against OTHER_CHECKOUT ...]
                                     [--variants] [--reps N] [--json PATH]

Builds this checkout's kernel library and, for each ``--against`` (for
example the parent commit unpacked under ``build/``: ``git archive HEAD~1 |
tar -x -C build/parent``), that checkout's from its own sources by its own
``kernels/build.py`` into its own ``build/`` directory. Then, at every
main-path shape of the bf16 forward (the serving kernel at the prefills of
Qwen3-4B, OLMoE-1B-7B, Llama-3.2-Vision-11B, Mixtral-8x7B, Hymba-1.5B's
windowed and global layers, Whisper-medium's decoder and Gemma3-12B's global
and local layers; the training kernel, which keeps the row log-sum-exp, at
the training shapes of Qwen3-4B, OLMoE-1B-7B, Hymba-1.5B, Whisper-medium and
Gemma3-12B's local and global layers), it holds every build's output against
the plain version (run per batch row and kv head, within 2e-2; the
log-sum-exp within 1e-5) and times the builds through their C entry points
on the same inputs in turns (this, others, others in reverse, this). Each
time is the device time of one call, from a CUDA graph of ``--reps`` calls
replayed once, so host gaps between launches do not count; beside it SDPA's
(no window) and the bound of the causal work at the bf16 peak. Last, the
host cost of one call of each build's entry at Whisper's shape (the tensor
maps the wgmma kernel encodes for every call), timed over 200 calls without
a graph. With ``--variants`` it also builds ``csrc/flash_attention_tc.cu``
with each design choice of ``VARIANTS`` undone by text substitution (under
``build/flash_fwd_variants/``, each with its ``-Xptxas -v`` registers and
spills and the highest register its SASS touches printed) and times those
builds in the same turns. Prints one JSON
line of every number (also written to ``--json``).
Without a CUDA device it exits non-zero; a result that disagrees exits
non-zero too.

``--dtype float32`` does the same for the f32 route
(``csrc/flash_attention.cu``, 3-pass TF32 ``wgmma``, its pre-pass
included) at ``F32_SHAPES``: the main paths' q ``[2,32,2048,80]`` kv 8
heads with and without the log-sum-exp (the f32 Qwen3-4B prefill and
training step), the kernel phase's timing shape ``[8,32,2048,80]``, and
Gemma3-12B's ``[2,16,2048,240]`` kv 8 global and window 1024. Each build is
held to the plain version within 1e-5 (the log-sum-exp within 1e-5) and bit
for bit across two calls; beside the times SDPA in f32 (TF32 off; no
window) and the bound of three TF32 passes of the causal work at the TF32
peak; each build's pre-pass and kernel apart (``torch.profiler`` over 5
calls); the host part at Whisper's shape in f32; ``--variants`` builds
``F32_VARIANTS`` from ``csrc/flash_attention.cu``. A tree whose entry takes
no scratch (before the pre-pass) is called without one.
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

from chip_smoke import (BF16_FLOPS, TF32_FLOPS, _bound, _card_line,  # noqa: E402
                        _causal_pairs, _plain_by_head)
from flash_bwd_turns import _by_kernel  # noqa: E402

# (what, b, hq, hkv, s, d, window, keeps the log-sum-exp)
SHAPES = (("Qwen3-4B prefill", 8, 32, 8, 2048, 80, None, False),
          ("OLMoE-1B-7B prefill", 8, 16, 16, 2048, 128, None, False),
          ("Llama-3.2-Vision-11B prefill", 8, 32, 8, 2048, 128, None, False),
          ("Mixtral-8x7B prefill", 2, 32, 8, 8192, 128, 4096, False),
          ("Hymba-1.5B prefill, windowed layers", 8, 25, 5, 2048, 64, 1024, False),
          ("Hymba-1.5B prefill, global layers", 8, 25, 5, 2048, 64, None, False),
          ("Whisper-medium decoder prefill", 8, 16, 16, 224, 64, None, False),
          ("Gemma3-12B prefill, global layers", 8, 16, 8, 2048, 240, None, False),
          ("Gemma3-12B prefill, local layers", 8, 16, 8, 2048, 240, 1024, False),
          ("Qwen3-4B training", 2, 32, 8, 2048, 80, None, True),
          ("OLMoE-1B-7B training", 2, 16, 16, 2048, 128, None, True),
          ("Hymba-1.5B training", 2, 25, 5, 2048, 64, 1024, True),
          ("Whisper-medium decoder training", 8, 16, 16, 448, 64, None, True),
          ("Gemma3-12B training, local layers", 2, 16, 8, 2048, 240, 1024, True),
          ("Gemma3-12B training, global layers", 2, 16, 8, 2048, 240, None, True))

# The f32 route's shapes: the main paths' (Qwen3-4B's f32 prefill without
# the log-sum-exp, its training forward with it), the kernel phase's timing
# shape, Gemma3-12B's training shapes.
F32_SHAPES = (("Qwen3-4B f32 prefill", 2, 32, 8, 2048, 80, None, False),
              ("Qwen3-4B f32 training", 2, 32, 8, 2048, 80, None, True),
              ("Qwen3-4B timing shape", 8, 32, 8, 2048, 80, None, False),
              ("Gemma3-12B f32 training, global layers", 2, 16, 8, 2048, 240, None, True),
              ("Gemma3-12B f32 training, local layers", 2, 16, 8, 2048, 240, 1024, True))


_GRID = "const dim3 grid(blocks < sms ? blocks : sms);"
_GROUP = "constexpr size_t L2_KV_BYTES = 16u << 20;"
_D64 = "template <> struct Tiling<64> { static constexpr int BKV = 64, STAGES = 4; };"
_WARP = "if (threadIdx.x < 32) {"
_BCAST = "x = gridDim.x + (int)__shfl_sync(FULL, taken, 0);"
# Each design choice of the kernel, undone: the blocks handed out in a fixed
# round-robin instead of from the work counter; one block a CTA (the
# hardware's own order, no persistent CTAs); no groups of heads for L2 (all
# heads side by side, each query block longest first); 128-key tiles at
# D = 64; the producer's loop on one thread instead of a warp.
VARIANTS = {
    "round_robin": {_BCAST: "x += gridDim.x;"},
    "one_block_a_cta": {_GRID: "const dim3 grid(blocks);"},
    "no_head_groups": {_GROUP: "constexpr size_t L2_KV_BYTES = size_t(1) << 40;"},
    "d64_keys_128": {_D64: "template <> struct Tiling<64> "
                           "{ static constexpr int BKV = 128, STAGES = 3; };"},
    "one_thread_producer": {_WARP: "if (threadIdx.x == 0) {",
                            _BCAST: "x = gridDim.x + (int)taken;"},
}


def _f32_tiling(d: int, fields: str) -> str:
    return f"template <> struct Tiling<{d}> {{ static constexpr int {fields}; }};"


_T80 = "BKV = 64, STAGES = 2, DCH = 80, HOLD = 1, SPLIT = 0"
# Design choices of the f32 kernel, undone or changed: round-robin blocks;
# one block a CTA; P V into two fresh accumulators of 40 columns at D = 80
# (one of all 80 in the kernel); 32-key tiles in four stages at D = 80; Q
# split two k-steps at a time where it is split at use (D = 128 and 240;
# four in the kernel).
F32_VARIANTS = {
    "round_robin": {_BCAST: "x += gridDim.x;"},
    "one_block_a_cta": {_GRID: "const dim3 grid(blocks);"},
    "dch_40_at_80": {_f32_tiling(80, _T80): _f32_tiling(80, _T80.replace("DCH = 80", "DCH = 40"))},
    "keys_32_at_80": {_f32_tiling(80, _T80): _f32_tiling(
        80, _T80.replace("BKV = 64, STAGES = 2", "BKV = 32, STAGES = 4"))},
    "kch_2": {"constexpr int KCH = 4;": "constexpr int KCH = 2;"},
}


def _variants(f32: bool):
    """The forward entry of one build per variant (of flash_attention_tc.cu,
    or with ``f32`` of flash_attention.cu), under
    build/flash_fwd_variants/<name>/, all nvcc runs at once."""
    import ctypes
    import shutil
    import subprocess

    from chip_smoke import _ptxas_report
    from repro_torch.kernels import build

    cu, entry = _SOURCE[f32]
    source = (build.CSRC / cu).read_text()
    procs = {}
    for name, subs in (F32_VARIANTS if f32 else VARIANTS).items():
        text = source
        for old, new in subs.items():
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in {cu}")
            text = text.replace(old, new)
        out = ROOT / "build" / "flash_fwd_variants" / name
        out.mkdir(parents=True, exist_ok=True)
        (out / cu).write_text(text)
        for header in build.CSRC.glob("*.cuh"):
            shutil.copy(header, out / header.name)
        procs[name] = (out / "lib.so", subprocess.Popen(
            [build._nvcc(), *build.ARCH, *build.FLAGS, "-Xptxas", "-v", "-shared", "-o",
             str(out / "lib.so"), str(out / cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        for line in _ptxas_report(log):
            print(f"[turns] variant {name} ptxas {line}")
        print(f"[turns] variant {name} highest register: {_registers(so, f32)}")
        lib = ctypes.CDLL(str(so))
        fns[f"variant {name}"] = _bind(lib, entry)
    return fns


# Per route: the source, its entry, and the kernel whose registers to read.
_SOURCE = {False: ("flash_attention_tc.cu", "flash_attention_tc_bf16"),
           True: ("flash_attention.cu", "flash_attention_f32")}
_KERNEL = {False: "flash_attention_tc_kernel<", True: "flash_attention_f32_kernel<"}


def _bind(lib, entry: str):
    """``entry`` of a loaded library, with its argument types: this tree's
    signature, or for an f32 entry without a scratch argument (a tree from
    before the pre-pass) one pointer fewer."""
    from repro_torch.kernels import build

    fn = getattr(lib, entry)
    argtypes, restype = build.SIGNATURES[entry]
    if entry == "flash_attention_f32":
        if hasattr(lib, "flash_attention_f32_scratch"):
            scratch = lib.flash_attention_f32_scratch
            scratch.argtypes, scratch.restype = build.SIGNATURES["flash_attention_f32_scratch"]
            fn.scratch = scratch
        else:
            argtypes = argtypes[:5] + argtypes[6:]
    fn.argtypes, fn.restype = argtypes, restype
    return fn


def _registers(lib: Path, f32: bool = False) -> dict:
    """The highest register each kernel instance of the route (with ``f32``,
    ``flash_attention_f32_kernel<D>``, else ``flash_attention_tc_kernel<D>``)
    of a built library touches in its SASS: past 167, the consumers use
    registers that ``setmaxnreg`` moved to them beyond the launch bound's
    168."""
    import re
    import shutil
    import subprocess

    from chip_smoke import _kernel_name

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name = _kernel_name(body.split("\n", 1)[0])
        if name.startswith(_KERNEL[f32]):
            out[name] = max(int(r) for r in re.findall(r"\bR(\d+)\b", body))
    return out


def _entry(tree: Path, f32: bool = False):
    """The forward entry of the route (``flash_attention_tc_bf16`` or
    ``flash_attention_f32``) of the kernel library that checkout ``tree``
    builds from its own sources with its own build module."""
    spec = importlib.util.spec_from_file_location(
        f"build_of_{abs(hash(str(tree)))}", tree / "src" / "repro_torch" / "kernels" / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return _bind(mod.load(), _SOURCE[f32][1])


_scratch = {}   # (entry, shape) -> the f32 pre-pass's scratch of that entry


def _call(fn, q, k, v, out, lse, window):
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    extra = ()
    if hasattr(fn, "scratch"):
        key = (id(fn), b, hq, hkv, sq, skv, d)
        if key not in _scratch:
            _scratch[key] = torch.empty(fn.scratch(b, hkv, skv, d), dtype=torch.float32,
                                        device=q.device)
        extra = (_scratch[key].data_ptr(),)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), *extra, b, hq, hkv, sq, skv, d,
             window or 0, d ** -0.5, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention forward launch failed with error {err}")


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="the route to time: bf16 (flash_attention_tc.cu) or f32 "
                         "(flash_attention.cu)")
    ap.add_argument("--against", type=Path, action="append", default=[],
                    help="another checkout whose forward to time in turns with this one's "
                         "(may be repeated)")
    ap.add_argument("--variants", action="store_true",
                    help="also time builds with each of VARIANTS' design choices undone")
    ap.add_argument("--reps", type=int, default=20, help="calls in each timed graph")
    ap.add_argument("--json", type=Path, help="also write the JSON line here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_fwd_turns: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = args.dtype == "float32"
    dtype, tag = (torch.float32, "f32") if f32 else (torch.bfloat16, "bf16")
    # f32: within 1e-5 of the plain version, bit for bit across two calls;
    # bf16: within 2e-2 (P is rounded to bf16 before P V).
    limit = 1e-5 if f32 else 2e-2
    card = _card_line()
    print(f"[turns] card: {card}; {args.dtype}")
    entries = {"this": _entry(ROOT, f32)}
    for other in args.against:
        entries[f"other ({other})"] = _entry(other.resolve(), f32)
    if args.variants:
        from repro_torch.kernels import build
        print(f"[turns] this highest register: {_registers(build.library_path(), f32)}")
        entries.update(_variants(f32))
    names = list(entries)
    gen = torch.Generator(device="cuda").manual_seed(0)
    results, ok = [], True
    for what, b, hq, hkv, s, d, window, with_lse in F32_SHAPES if f32 else SHAPES:
        q = torch.randn((b, hq, s, d), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        out = torch.empty_like(q)
        lse = torch.empty((b, hq, s), dtype=torch.float32, device="cuda") if with_lse else None
        plain = _plain_by_head(ref.flash_attention, q, k, v, causal=True, window=window).float()
        plain_lse = (_plain_by_head(ref.flash_attention_lse, q, k, window=window)
                     if with_lse else None)
        row = {"what": what, "shape": f"q[{b},{hq},{s},{d}] kv[{b},{hkv},{s},{d}] {tag} causal"
               + (f" window {window}" if window else ""), "lse": with_lse, "max_abs_err": {},
               "ms": {name: [] for name in names}}
        for name in names:
            out.zero_()
            _call(entries[name], q, k, v, out, lse, window)
            torch.cuda.synchronize()
            first = out.clone()
            err = (out.float() - plain).abs().max().item()
            lse_err = (lse - plain_lse).abs().max().item() if with_lse else 0.0
            row["max_abs_err"][name] = [err, lse_err] if with_lse else err
            same = True
            if f32:
                _call(entries[name], q, k, v, out, lse, window)
                torch.cuda.synchronize()
                same = torch.equal(first, out)
            del first
            if not (err <= limit and lse_err <= 1e-5 and same):
                ok = False
                print(f"[turns] {what}: {name} disagrees with the plain version: output "
                      f"{err}, log-sum-exp {lse_err}, two calls bit for bit {same}")
        del plain, plain_lse
        for name in (*names, *reversed(names)):
            row["ms"][name].append(_graph_ms(
                lambda: _call(entries[name], q, k, v, out, lse, window), args.reps))  # noqa: B023
        flops = 4.0 * d * b * hq * _causal_pairs(s, s, window)
        nbytes = (q.element_size() * (2 * b * hq * s * d + 2 * b * hkv * s * d)
                  + (4 * b * hq * s if with_lse else 0))
        # f32: three TF32 passes of the products at the TF32 peak.
        row["bound_ms"], row["bound_by"] = (_bound(3 * flops, nbytes, peak=TF32_FLOPS) if f32
                                            else _bound(flops, nbytes, peak=BF16_FLOPS))
        if f32:   # each build's launches apart: the pre-pass (where it has one), the kernel
            parts = (("pre-pass", "tf32_split_kernel"), ("kernel", "flash_attention"))
            row["by_kernel"] = {name: _by_kernel(
                lambda: _call(entries[name], q, k, v, out, lse, window), parts)  # noqa: B023
                for name in names}
        row["sdpa_ms"] = None if window else _graph_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
            args.reps)
        this = min(row["ms"]["this"])
        line = "; ".join(f"{name} {' '.join(f'{t:.4f}' for t in ts)}"
                         for name, ts in row["ms"].items())
        ratios = "".join(f", this / {name} {this / min(ts):.3f}"
                         for name, ts in row["ms"].items() if name != "this")
        sdpa = "" if row["sdpa_ms"] is None else f", SDPA {row['sdpa_ms']:.4f} ms"
        split = "" if not f32 else "; by launch " + "; ".join(
            f"{name} " + " ".join(f"{label} {ms:.4f}" for label, ms in parts.items())
            for name, parts in row["by_kernel"].items())
        print(f"[turns] {what} {row['shape']}{' (keeping the log-sum-exp)' if with_lse else ''}: "
              f"{line} ms{ratios}{sdpa}; bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
              f"this at {row['bound_ms'] / this:.2f} of it){split}; max_abs_err "
              f"{row['max_abs_err']}")
        results.append(row)
        del q, k, v, out, lse
        torch.cuda.empty_cache()

    # The host's share: one call of each entry at Whisper's prompt, enqueued
    # 200 times without a graph (the wgmma kernels encode their tensor maps
    # for every call).
    q = torch.randn((8, 16, 224, 64), generator=gen, device="cuda").to(dtype)
    k, v, out = torch.randn_like(q), torch.randn_like(q), torch.empty_like(q)
    host = {}
    for name in (*names, *reversed(names)):
        _call(entries[name], q, k, v, out, None, None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            _call(entries[name], q, k, v, out, None, None)
        host.setdefault(name, []).append((time.perf_counter() - t0) / 200 * 1e6)
        torch.cuda.synchronize()
    print(f"[turns] host us a call at q[8,16,224,64] {tag}: "
          + "; ".join(f"{name} {' '.join(f'{t:.1f}' for t in ts)}" for name, ts in host.items()))
    record = {"card": card, "dtype": args.dtype, "reps": args.reps, "shapes": results,
              "host_us": host}
    line = json.dumps(record)
    print(line)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
