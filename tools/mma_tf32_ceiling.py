#!/usr/bin/env python3
"""The TF32 rate ``mma.sync`` reaches on this GPU, with nothing to load.

    python3 tools/mma_tf32_ceiling.py

Builds a loop of independent ``mma.sync.m16n8k8`` TF32 products on operands
held in registers into ``build/mma_tf32_ceiling/``, and prints the rate it
reaches at 1, 2 and 4 blocks of 8 warps per SM: the ceiling of any kernel
built on that instruction, against the 495 TFLOP/s dense TF32 peak that
only ``wgmma`` reaches. No kernel of the port runs ``mma.sync`` any more:
the f32 ``flash_attention`` forward and backward run TF32 ``wgmma``
(``tools/flash_fwd_turns.py --dtype float32`` and
``tools/flash_bwd_turns.py --dtype float32`` time them); ``sage_aggregate``
runs no product on the tensor cores (``tools/sage_turns.py``). Without a
CUDA device it exits non-zero.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args()
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

    print(f"[ceiling] mma.sync TF32 ceiling {ceiling:.1f} TFLOP/s, "
          f"{100 * ceiling / (TF32_FLOPS / 1e12):.1f} % of the dense TF32 peak")
    return 0


if __name__ == "__main__":
    sys.exit(main())
