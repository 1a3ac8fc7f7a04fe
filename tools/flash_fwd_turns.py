#!/usr/bin/env python3
"""The bf16 ``flash_attention`` forward of this checkout against another's, in turns.

    python3 tools/flash_fwd_turns.py [--against OTHER_CHECKOUT ...] [--variants]
                                     [--reps N] [--json PATH]

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

from chip_smoke import (BF16_FLOPS, _bound, _card_line, _causal_pairs,  # noqa: E402
                        _plain_by_head)

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


def _variants():
    """``flash_attention_tc_bf16`` of one build of flash_attention_tc.cu per
    variant, under build/flash_fwd_variants/<name>/, all nvcc runs at once."""
    import ctypes
    import shutil
    import subprocess

    from chip_smoke import _ptxas_report
    from repro_torch.kernels import build

    source = (build.CSRC / "flash_attention_tc.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs.items():
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in flash_attention_tc.cu")
            text = text.replace(old, new)
        out = ROOT / "build" / "flash_fwd_variants" / name
        out.mkdir(parents=True, exist_ok=True)
        (out / "flash_attention_tc.cu").write_text(text)
        shutil.copy(build.CSRC / "hopper.cuh", out / "hopper.cuh")
        procs[name] = (out / "lib.so", subprocess.Popen(
            [build._nvcc(), *build.ARCH, *build.FLAGS, "-Xptxas", "-v", "-shared", "-o",
             str(out / "lib.so"), str(out / "flash_attention_tc.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        for line in _ptxas_report(log):
            print(f"[turns] variant {name} ptxas {line}")
        print(f"[turns] variant {name} highest register: {_registers(so)}")
        fn = ctypes.CDLL(str(so)).flash_attention_tc_bf16
        fn.argtypes, fn.restype = build.SIGNATURES["flash_attention_tc_bf16"]
        fns[f"variant {name}"] = fn
    return fns


def _registers(lib: Path) -> dict:
    """The highest register each ``flash_attention_tc_kernel<D>`` instance of a
    built library touches in its SASS: past 167, the consumers use registers
    that ``setmaxnreg`` moved to them beyond the launch bound's 168."""
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
        if name.startswith("flash_attention_tc_kernel<"):
            out[name] = max(int(r) for r in re.findall(r"\bR(\d+)\b", body))
    return out


def _entry(tree: Path):
    """``flash_attention_tc_bf16`` of the kernel library that checkout
    ``tree`` builds from its own sources with its own build module."""
    spec = importlib.util.spec_from_file_location(
        f"build_of_{abs(hash(str(tree)))}", tree / "src" / "repro_torch" / "kernels" / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load().flash_attention_tc_bf16


def _call(fn, q, k, v, out, lse, window):
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), b, hq, hkv, sq, skv, d, window or 0,
             d ** -0.5, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_tc_bf16 launch failed with error {err}")


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
    ap.add_argument("--against", type=Path, action="append", default=[],
                    help="another checkout whose bf16 forward to time in turns with this one's "
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

    card = _card_line()
    print(f"[turns] card: {card}")
    entries = {"this": _entry(ROOT)}
    for other in args.against:
        entries[f"other ({other})"] = _entry(other.resolve())
    if args.variants:
        from repro_torch.kernels import build
        print(f"[turns] this highest register: {_registers(build.library_path())}")
        entries.update(_variants())
    names = list(entries)
    gen = torch.Generator(device="cuda").manual_seed(0)
    results, ok = [], True
    for what, b, hq, hkv, s, d, window, with_lse in SHAPES:
        q = torch.randn((b, hq, s, d), generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        out = torch.empty_like(q)
        lse = torch.empty((b, hq, s), dtype=torch.float32, device="cuda") if with_lse else None
        plain = _plain_by_head(ref.flash_attention, q, k, v, causal=True, window=window).float()
        plain_lse = (_plain_by_head(ref.flash_attention_lse, q, k, window=window)
                     if with_lse else None)
        row = {"what": what, "shape": f"q[{b},{hq},{s},{d}] kv[{b},{hkv},{s},{d}] bf16 causal"
               + (f" window {window}" if window else ""), "lse": with_lse, "max_abs_err": {},
               "ms": {name: [] for name in names}}
        for name in names:
            out.zero_()
            _call(entries[name], q, k, v, out, lse, window)
            torch.cuda.synchronize()
            err = (out.float() - plain).abs().max().item()
            lse_err = (lse - plain_lse).abs().max().item() if with_lse else 0.0
            row["max_abs_err"][name] = [err, lse_err] if with_lse else err
            if not (err <= 2e-2 and lse_err <= 1e-5):
                ok = False
                print(f"[turns] {what}: {name} disagrees with the plain version: output "
                      f"{err}, log-sum-exp {lse_err}")
        del plain, plain_lse
        for name in (*names, *reversed(names)):
            row["ms"][name].append(_graph_ms(
                lambda: _call(entries[name], q, k, v, out, lse, window), args.reps))  # noqa: B023
        flops = 4.0 * d * b * hq * _causal_pairs(s, s, window)
        nbytes = 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d) + (4 * b * hq * s if with_lse else 0)
        row["bound_ms"], row["bound_by"] = _bound(flops, nbytes, peak=BF16_FLOPS)
        row["sdpa_ms"] = None if window else _graph_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
            args.reps)
        this = min(row["ms"]["this"])
        line = "; ".join(f"{name} {' '.join(f'{t:.4f}' for t in ts)}"
                         for name, ts in row["ms"].items())
        ratios = "".join(f", this / {name} {this / min(ts):.3f}"
                         for name, ts in row["ms"].items() if name != "this")
        sdpa = "" if row["sdpa_ms"] is None else f", SDPA {row['sdpa_ms']:.4f} ms"
        print(f"[turns] {what} {row['shape']}{' (keeping the log-sum-exp)' if with_lse else ''}: "
              f"{line} ms{ratios}{sdpa}; bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
              f"this at {row['bound_ms'] / this:.2f} of it); max_abs_err {row['max_abs_err']}")
        results.append(row)
        del q, k, v, out, lse
        torch.cuda.empty_cache()

    # The host's share: one call of each entry at Whisper's prompt, enqueued
    # 200 times without a graph (the wgmma kernel encodes four tensor maps).
    q = torch.randn((8, 16, 224, 64), generator=gen, device="cuda").to(torch.bfloat16)
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
    print(f"[turns] host us a call at q[8,16,224,64]: "
          + "; ".join(f"{name} {' '.join(f'{t:.1f}' for t in ts)}" for name, ts in host.items()))
    record = {"card": card, "reps": args.reps, "shapes": results, "host_us": host}
    line = json.dumps(record)
    print(line)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
