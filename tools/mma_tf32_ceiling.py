#!/usr/bin/env python3
"""The TF32 rate ``mma.sync`` reaches on this GPU, against ``sage_aggregate``'s.

    python3 tools/mma_tf32_ceiling.py

Builds a loop of independent ``mma.sync.m16n8k8`` TF32 products on operands
held in registers, with nothing to load, into ``build/mma_tf32_ceiling/``, and
prints the rate it reaches at 1, 2 and 4 blocks of 8 warps per SM: the ceiling
of any kernel built on that instruction. Then it times the CUDA
``sage_aggregate`` of this checkout at the SpreadFGL Coauthor-CS layers
(``[6,6123,6123] x [6,6123,6805]`` and ``x [6,6123,32]``) and prints its rate
in TF32 products (three per multiply-add) as a share of that ceiling. Without
a CUDA device it exits non-zero.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "build" / "mma_tf32_ceiling"

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
    if not torch.cuda.is_available():
        print("mma_tf32_ceiling: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import _card_line, _time_ms
    from repro_torch.kernels import sage_aggregate as ksage

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

    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, n, d, reps in ((6, 6123, 6805, 3), (6, 6123, 32, 10)):
        a = (torch.rand((m, n, n), generator=gen, device="cuda") < 2e-3).float()
        adj = a / torch.clamp_min(a.sum(-1, keepdim=True), 1.0)
        h = torch.randn((m, n, d), generator=gen, device="cuda")
        ms = _time_ms(lambda: ksage.launch(adj, h), reps)  # noqa: B023
        tf32 = 3 * 2.0 * m * n * n * d / ms / 1e9
        print(f"[ceiling] sage_aggregate [{m},{n},{n}]x[{m},{n},{d}]: {ms:.3f} ms, "
              f"{tf32:.1f} TFLOP/s of TF32 products, {100 * tf32 / ceiling:.1f} % of the "
              f"ceiling; three passes at the ceiling: {3 * 2.0 * m * n * n * d / ceiling / 1e9:.3f} ms")
        del a, adj, h
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
