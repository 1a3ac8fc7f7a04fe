#!/usr/bin/env python3
"""The TF32 rate ``mma.sync`` reaches on this GPU, against the rate of the
kernel built on it: ``flash_attention``'s f32 forward.

    python3 tools/mma_tf32_ceiling.py [--against OTHER_CHECKOUT ...] [--ablate]

Builds a loop of independent ``mma.sync.m16n8k8`` TF32 products on operands
held in registers, with nothing to load, into ``build/mma_tf32_ceiling/``, and
prints the rate it reaches at 1, 2 and 4 blocks of 8 warps per SM: the ceiling
of any kernel built on that instruction. Then it times the f32
``flash_attention`` at the serving shape, q ``[8,32,2048,80]`` and kv
``[8,8,2048,80]``, causal, and prints its rate in TF32 products (three per
multiply-add of the causal work) as a share of the ceiling and of the dense
TF32 peak. (The f32 backward runs on TF32 wgmma, whose rate mma.sync does
not bound: ``tools/flash_bwd_turns.py --dtype float32`` times it;
``sage_aggregate`` runs no product on the tensor cores:
``tools/sage_turns.py`` times it.)

With ``--against`` (which may be given more than once) it also builds the
kernels from another checkout's sources, by that checkout's own
``kernels/build.py`` (for example the parent commit unpacked under
``build/``), and times both through their C entry points on the same inputs,
in turns (this, other, other, this), at each shape.
With ``--ablate`` it also builds
``csrc/flash_attention.cu`` with each value of its ``FLASH_F32_ABLATE``
switch under ``build/ablation/`` and times those builds in turns with this
one: ``split_per_warp``, each warp splits the fragments it reads;
``no_split_pass``, the K and V tiles are not split (wrong results, timing
only); ``one_pass``, one TF32 product (hi x hi) where the kernel takes three;
``one_accumulator``, the three passes of S, and P V over all the key tiles,
summed into one accumulator each. Every build's output is held against the
plain version and against attention in float64, beside the plain version's
own error. Without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "build" / "mma_tf32_ceiling"

from chip_smoke import TF32_FLOPS, _card_line, _time_ms  # noqa: E402

BENCH = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// 16 independent m16n8k8 TF32 products per iteration on operands in registers.
__global__ void __launch_bounds__(256) mma_tf32_loop(float* out, int iters) {
  float acc[16][4] = {};
  uint32_t a[4], b[2];
  for (int q = 0; q < 4; ++q) a[q] = (threadIdx.x * 7919u + q * 104729u) & 0x3f7fe000u;
  b[0] = a[1]; b[1] = a[2];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                   : "+f"(acc[i][0]), "+f"(acc[i][1]), "+f"(acc[i][2]), "+f"(acc[i][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.0f;
  for (int i = 0; i < 16; ++i) s += acc[i][0] + acc[i][1] + acc[i][2] + acc[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_bench(float* out, int blocks, int iters) {
  mma_tf32_loop<<<blocks, 256>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def _build_bench():
    from repro_torch.kernels import build
    OUT.mkdir(parents=True, exist_ok=True)
    src, so = OUT / "mma_bench.cu", OUT / "mma_bench.so"
    src.write_text(BENCH)
    subprocess.run([build._nvcc(), *build.ARCH, *build.FLAGS, "-shared", str(src), "-o", str(so)],
                   check=True)
    fn = ctypes.CDLL(str(so)).mma_bench
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


# The f32 flash_attention at the serving shape: (b, hq, hkv, s, d, timed calls).
FLASH_SHAPE = (8, 32, 8, 2048, 80, 10)
# Value of flash_attention.cu's FLASH_F32_ABLATE switch for each ablation.
ABLATIONS = {"split_per_warp": 1, "no_split_pass": 2, "one_pass": 3, "one_accumulator": 4}


def _library(tree: Path):
    """The kernel library that checkout ``tree`` builds from its own sources
    with its own build module."""
    spec = importlib.util.spec_from_file_location(
        f"build_of_{abs(hash(str(tree)))}", tree / "src" / "repro_torch" / "kernels" / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load()


def _ablated_flash():
    """``flash_attention_f32`` of one build of flash_attention.cu per
    ablation, under build/ablation/flash_<name>/, all nvcc runs at once."""
    from repro_torch.kernels import build
    procs = {}
    for name, value in ABLATIONS.items():
        out = ROOT / "build" / "ablation" / f"flash_{name}"
        out.mkdir(parents=True, exist_ok=True)
        procs[name] = (out / "lib.so", subprocess.Popen(
            [build._nvcc(), *build.ARCH, *build.FLAGS, f"-DFLASH_F32_ABLATE={value}",
             "-Xptxas", "-v", "-shared", "-o", str(out / "lib.so"),
             str(build.CSRC / "flash_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on ablation {name}:\n{log}")
        regs = [line.split(":", 1)[1].strip() for line in log.splitlines()
                if "Used" in line and "registers" in line]
        print(f"[ceiling] ablation {name} ptxas: {regs}")
        fn = ctypes.CDLL(str(so)).flash_attention_f32
        fn.argtypes, fn.restype = build.SIGNATURES["flash_attention_f32"]
        fns[name] = fn
    return fns


def _in_turns(entries, call, reps):
    """Each entry's time, in turns: the entries in order, then reversed."""
    times = {name: [] for name in entries}
    for name in (*entries, *reversed(entries)):
        times[name].append(_time_ms(lambda: call(entries[name]), reps))  # noqa: B023
    return "; ".join(f"{name} {' '.join(f'{t:.4f}' for t in ts)} ms"
                     for name, ts in times.items())


def _attention_f64(q, k, v):
    """Causal attention in float64, one batch entry at a time."""
    rep = q.shape[1] // k.shape[1]
    s = q.shape[2]
    seen = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    out = []
    for b in range(q.shape[0]):
        kb, vb = (x[b].double().repeat_interleave(rep, 0) for x in (k, v))
        logits = (q[b].double() @ kb.transpose(-1, -2)) / q.shape[-1] ** 0.5
        out.append(torch.softmax(logits.masked_fill(~seen, -torch.inf), -1) @ vb)
        del logits
    return torch.stack(out)


def _flash(trees, ablate, ceiling):
    """The f32 flash_attention at the serving shape, alone, in turns with
    other trees' and with the ablated builds."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref

    b, hq, hkv, s, d, reps = FLASH_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((b, hq, s, d), generator=gen, device="cuda")
    k, v = (torch.randn((b, hkv, s, d), generator=gen, device="cuda") for _ in range(2))
    shape = f"q[{b},{hq},{s},{d}] kv[{b},{hkv},{s},{d}] f32 causal"
    plain = ref.flash_attention(q, k, v)
    exact = _attention_f64(q, k, v)
    print(f"[ceiling] flash_attention {shape}: plain version max |plain - float64| "
          f"{(plain.double() - exact).abs().max().item():.3g}")
    out = kflash.launch(q, k, v)
    err = (out - plain).abs().max().item()
    err64 = (out.double() - exact).abs().max().item()
    ms = _time_ms(lambda: kflash.launch(q, k, v), reps)
    tf32 = 3 * 4.0 * b * hq * d * (s * (s + 1) / 2)
    print(f"[ceiling] flash_attention {shape}: {ms:.4f} ms (max |out - plain| {err:.3g}, "
          f"max |out - float64| {err64:.3g}), "
          f"{tf32 / ms / 1e9:.1f} TFLOP/s of TF32 products, {100 * tf32 / ms / 1e9 / ceiling:.1f} "
          f"% of the ceiling, {100 * tf32 / ms / 1e9 / (TF32_FLOPS / 1e12):.1f} % of the dense "
          f"TF32 peak; three passes at the ceiling: {tf32 / ceiling / 1e9:.4f} ms, at the "
          f"peak: {tf32 / TF32_FLOPS * 1e3:.4f} ms")
    entries = {name: lib.flash_attention_f32 for name, lib in trees.items()}
    if ablate:
        entries.update(_ablated_flash())
    if len(entries) > 1:
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream

        def call(fn):
            # A tree from before the entry gained its `lse` argument takes one fewer.
            lse = (None,) if len(fn.argtypes) == 14 else ()
            e = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *lse, b, hq, hkv,
                   s, s, d, 0, 1.0 / d ** 0.5, stream)
            if e:
                raise RuntimeError(f"flash_attention_f32 launch failed with error {e}")
        for name, fn in entries.items():
            call(fn)
            print(f"[ceiling] flash_attention {shape} {name}: max |out - plain| "
                  f"{(out - plain).abs().max().item():.3g}, max |out - float64| "
                  f"{(out.double() - exact).abs().max().item():.3g}")
        print(f"[ceiling] flash_attention {shape} in turns: {_in_turns(entries, call, reps)}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, action="append", default=[],
                    help="another checkout whose kernels to time in turns with this one's "
                         "(may be repeated)")
    ap.add_argument("--ablate", action="store_true",
                    help="also time flash_attention.cu's FLASH_F32_ABLATE builds")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mma_tf32_ceiling: no CUDA device", file=sys.stderr)
        return 1
    print(f"[ceiling] card: {_card_line()}")
    bench = _build_bench()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    scratch = torch.empty(4 * sms * 256, device="cuda")
    iters = 4096
    ceiling = 0.0
    for per_sm in (1, 2, 4):
        def run(blocks=per_sm * sms):
            if bench(scratch.data_ptr(), blocks, iters):
                raise RuntimeError("mma_bench launch failed")
        ms = _time_ms(run, 3)
        rate = per_sm * sms * 8 * 16 * iters * 2 * 16 * 8 * 8 / ms / 1e9
        ceiling = max(ceiling, rate)
        print(f"[ceiling] mma.sync m16n8k8 TF32, {per_sm} x 8 warps per SM: {rate:.1f} TFLOP/s")

    trees = {"this": _library(ROOT)}
    for other in args.against:
        trees[f"other ({other.resolve()})"] = _library(other.resolve())
    _flash(trees, args.ablate, ceiling)
    return 0


if __name__ == "__main__":
    sys.exit(main())
