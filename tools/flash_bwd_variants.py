#!/usr/bin/env python3
"""The bf16 ``flash_attention`` backward (``csrc/flash_attention_bwd_tc.cu``)
against the rate ``mma.sync`` reaches, split by kernel, and timed against
variants of its tiling.

    python3 tools/flash_bwd_variants.py

First it builds a loop of independent ``mma.sync.m16n8k16`` bf16 products on
operands held in registers, with nothing to load, into
``build/flash_bwd_variants/ceiling/``, and prints the rate it reaches at 2, 3
and 4 blocks of 4 warps per SM: the ceiling of any kernel built on that
instruction. Then, at the Qwen3-4B training shape, q ``[2,32,2048,80]`` and
kv ``[2,8,2048,80]`` bf16, causal, it builds copies of the source with one
or more of its tile constants changed, each by ``nvcc`` into
``build/flash_bwd_variants/<name>/`` (``-Xptxas -v``: each instance's
registers and spills at D = 80 are printed), and calls each through its C
entry point with ``ctypes`` on the same inputs:

- ``as built``: the source unchanged (4 warps a block; 64 q rows a dK/dV
  tile and 32 keys a dQ tile; registers capped for two dK/dV blocks an SM
  and three dQ blocks);
- ``dq_blocks_2``: the dQ kernel capped for two blocks an SM;
- ``dkdv_blocks_3``: the dK/dV kernel capped for three;
- ``warps_8``: 8 warps a block (128 keys or rows), one block an SM;
- ``bq_32``: 32 q rows a dK/dV tile;
- ``bkv_64``: 64 keys a dQ tile.

Each variant's gradients are held against the plain version (within 2e-2 of
each gradient's max |value|, the CUDA tests' limit); it is timed with CUDA
events over 20 launches in turns (every variant, then every variant in reverse
order), and its three kernels (the D pass, dK/dV, dQ) apart with
``torch.profiler`` over 5 launches, each kernel's rate over the products it
computes (dK/dV four, dQ three) as a share of the ceiling. Without a CUDA
device it exits non-zero.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "build" / "flash_bwd_variants"

from chip_smoke import BF16_FLOPS, _card_line, _ptxas_report, _time_ms  # noqa: E402

_WARPS = "constexpr int WARPS = 4;"
_BQ = "static constexpr int BQ = D <= 80 ? 64 : 32;"
_BKV = "static constexpr int BKV = 32;"
_KV_BLOCKS = "static constexpr int DKDV_BLOCKS = 2;"
_Q_BLOCKS = "static constexpr int DQ_BLOCKS = D <= 80 ? 3 : 2;"
VARIANTS = {
    "as built": {},
    "dq_blocks_2": {_Q_BLOCKS: "static constexpr int DQ_BLOCKS = 2;"},
    "dkdv_blocks_3": {_KV_BLOCKS: "static constexpr int DKDV_BLOCKS = 3;"},
    "warps_8": {_WARPS: "constexpr int WARPS = 8;",
                _KV_BLOCKS: "static constexpr int DKDV_BLOCKS = 1;",
                _Q_BLOCKS: "static constexpr int DQ_BLOCKS = 1;"},
    "bq_32": {_BQ: "static constexpr int BQ = 32;"},
    "bkv_64": {_BKV: "static constexpr int BKV = D <= 80 ? 64 : 32;"},
}
KERNELS = (("D pass", "delta_tc_kernel"), ("dK/dV", "dkdv_tc_kernel"), ("dQ", "dq_tc_kernel"))
PRODUCTS = {"dK/dV": 4, "dQ": 3}     # causal products each kernel computes

CEILING = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// 16 independent m16n8k16 bf16 products per iteration on operands in registers.
__global__ void __launch_bounds__(128) mma_bf16_loop(float* out, int iters) {
  float acc[16][4] = {};
  uint32_t a[4], b[2];
  for (int q = 0; q < 4; ++q) a[q] = (threadIdx.x * 7919u + q * 104729u) & 0x3f3f3f3fu;
  b[0] = a[1]; b[1] = a[2];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                   : "+f"(acc[i][0]), "+f"(acc[i][1]), "+f"(acc[i][2]), "+f"(acc[i][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.0f;
  for (int i = 0; i < 16; ++i) s += acc[i][0] + acc[i][1] + acc[i][2] + acc[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_bench(float* out, int blocks, int iters) {
  mma_bf16_loop<<<blocks, 128>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def _ceiling() -> float:
    """The best bf16 rate of independent mma.sync products, in FLOP/s."""
    from repro_torch.kernels import build

    d = OUT / "ceiling"
    d.mkdir(parents=True)
    (d / "ceiling.cu").write_text(CEILING)
    subprocess.run([build._nvcc(), *build.ARCH, "-O3", "-Xcompiler", "-fPIC", "-shared",
                    "-o", str(d / "lib.so"), str(d / "ceiling.cu")], check=True)
    fn = ctypes.CDLL(str(d / "lib.so")).mma_bench
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int], ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    best, iters = 0.0, 4096
    for per_sm in (2, 3, 4):
        blocks = sms * per_sm
        out = torch.empty(blocks * 128, device="cuda")
        ms = _time_ms(lambda: fn(out.data_ptr(), blocks, iters), 5)
        rate = blocks * 4 * iters * 16 * 4096 / (ms * 1e-3)
        best = max(best, rate)
        print(f"[variants] mma.sync bf16 ceiling, {per_sm} blocks of 4 warps per SM: "
              f"{rate / 1e12:.1f} TFLOP/s ({100 * rate / BF16_FLOPS:.1f} % of the dense peak)")
    return best


def _build_all():
    """Each variant's source and shared library; the ptxas log beside it."""
    from repro_torch.kernels import build

    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    source = (csrc / "flash_attention_bwd_tc.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits.items():
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        d = OUT / name.replace(" ", "_")
        d.mkdir(parents=True)
        (d / "flash_attention_bwd_tc.cu").write_text(text)
        for h in csrc.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        procs[name] = (d, subprocess.Popen(
            [build._nvcc(), *build.ARCH, *build.FLAGS, "-Xptxas", "-v", "-shared",
             "-o", str(d / "lib.so"), str(d / "flash_attention_bwd_tc.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    argtypes, restype = build.SIGNATURES["flash_attention_bwd_tc_bf16"]
    for name, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        for line in _ptxas_report(log):
            if "<80>" in line:
                print(f"[variants] {name}: ptxas {line}")
        fn = ctypes.CDLL(str(d / "lib.so")).flash_attention_bwd_tc_bf16
        fn.argtypes, fn.restype = argtypes, restype
        libs[name] = fn
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref

    card = _card_line()
    print(f"[variants] card: {card}")
    shutil.rmtree(OUT, ignore_errors=True)
    ceiling = _ceiling()
    libs = _build_all()
    dev = torch.device("cuda")
    b, hq, hkv, s, d = 2, 32, 8, 2048, 80
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((b, hq, s, d), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((b, hkv, s, d), generator=gen, device=dev).bfloat16() for _ in range(2))
    do = torch.randn((b, hq, s, d), generator=gen, device=dev).bfloat16()
    o, lse = kflash.launch(q, k, v, with_lse=True)
    plain = ref.flash_attention_bwd(q, k, v, o, do, lse)
    delta = torch.empty_like(lse)
    outs = tuple(torch.empty_like(t) for t in (q, k, v))
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs), b, hq, hkv,
                 s, s, d, 0, d ** -0.5, stream)
        if err:
            raise RuntimeError(f"launch failed with CUDA error {err}")

    pairs = b * hq * s * (s + 1) / 2
    flops = 10.0 * d * pairs                          # five causal products
    times = {name: [] for name in libs}
    for name in list(libs) + list(reversed(libs)):
        times[name].append(_time_ms(lambda: call(libs[name]), 20))
    for name, fn in libs.items():
        call(fn)
        torch.cuda.synchronize()
        errs = [(g.float() - p.float()).abs().max().item() / p.float().abs().max().item()
                for g, p in zip(outs, plain)]
        if max(errs) > 2e-2:
            raise AssertionError(f"variant {name} disagrees with the plain version: {errs}")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call(fn)
            torch.cuda.synchronize()
        split = {label: sum(e.self_device_time_total for e in prof.key_averages()
                            if e.device_type == DeviceType.CUDA and mark in e.key) / 5e3
                 for label, mark in KERNELS}
        ms = sum(times[name]) / len(times[name])
        shares = {label: 2.0 * n * d * pairs / (split[label] * 1e-3) / ceiling
                  for label, n in PRODUCTS.items()}
        print(f"[variants] {name}: ms {' '.join(f'{t:.4f}' for t in times[name])} (mean "
              f"{ms:.4f}, {flops / ms / 1e9:.1f} TFLOP/s of five products, "
              f"{100 * flops / (ms * 1e-3) / BF16_FLOPS:.1f} % of the bf16 peak); by kernel "
              + ", ".join(f"{label} {t:.4f}" for label, t in split.items())
              + " ms (" + ", ".join(f"{label} {100 * x:.1f} %" for label, x in shares.items())
              + f" of the mma.sync ceiling); max err {max(errs):.4f} of max |grad|")
    print(f"[variants] q [{b},{hq},{s},{d}] kv [{b},{hkv},{s},{d}] bf16 causal on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
