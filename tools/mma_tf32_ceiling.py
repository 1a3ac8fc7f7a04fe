#!/usr/bin/env python3
"""The TF32 rate ``mma.sync`` reaches on this GPU, against ``sage_aggregate``'s.

    python3 tools/mma_tf32_ceiling.py [--against OTHER_CHECKOUT]

Builds a loop of independent ``mma.sync.m16n8k8`` TF32 products on operands
held in registers, with nothing to load, into ``build/mma_tf32_ceiling/``, and
prints the rate it reaches at 1, 2 and 4 blocks of 8 warps per SM: the ceiling
of any kernel built on that instruction. Then it times the CUDA
``sage_aggregate`` of this checkout at the layers of both FGL main paths
(SpreadFGL on Coauthor-CS, ``[6,6123,6123] x [6,6123,6805]`` and
``x [6,6123,32]``; FedGL on Cora, ``[6,914,914] x [6,914,1433]`` and
``x [6,914,32]``) and prints its rate in TF32 products (three per
multiply-add) as a share of that ceiling.

With ``--against`` it also builds ``sage_aggregate`` from another checkout's
sources, by that checkout's own ``kernels/build.py`` (for example the parent
commit unpacked under ``build/``), and times both through their C entry points
on the same inputs, in turns (this, other, other, this), at each shape.
Without a CUDA device it exits non-zero.
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


# (M, n, d, timed calls) of each layer: SpreadFGL Coauthor-CS, FedGL Cora.
SHAPES = ((6, 6123, 6805, 3), (6, 6123, 32, 10), (6, 914, 1433, 20), (6, 914, 32, 50))


def _sage_entry(tree: Path):
    """``sage_aggregate_f32`` of the library that checkout ``tree`` builds
    from its own sources with its own build module."""
    spec = importlib.util.spec_from_file_location(
        f"build_of_{abs(hash(str(tree)))}", tree / "src" / "repro_torch" / "kernels" / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load().sage_aggregate_f32


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout whose sage_aggregate to time in turns with this one's")
    args = ap.parse_args()
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

    entries = None
    if args.against is not None:
        other = args.against.resolve()
        entries = {"this": _sage_entry(ROOT), f"other ({other})": _sage_entry(other)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, n, d, reps in SHAPES:
        a = (torch.rand((m, n, n), generator=gen, device="cuda") < 2e-3).float()
        adj = a / torch.clamp_min(a.sum(-1, keepdim=True), 1.0)
        h = torch.randn((m, n, d), generator=gen, device="cuda")
        shape = f"[{m},{n},{n}]x[{m},{n},{d}]"
        ms = _time_ms(lambda: ksage.launch(adj, h), reps)  # noqa: B023
        tf32 = 3 * 2.0 * m * n * n * d / ms / 1e9
        print(f"[ceiling] sage_aggregate {shape}: {ms:.4f} ms, "
              f"{tf32:.1f} TFLOP/s of TF32 products, {100 * tf32 / ceiling:.1f} % of the "
              f"ceiling; three passes at the ceiling: {3 * 2.0 * m * n * n * d / ceiling / 1e9:.4f} ms")
        if entries is not None:
            out = torch.empty_like(h)
            stream = torch.cuda.current_stream().cuda_stream
            times = {name: [] for name in entries}
            for name in (*entries, *reversed(entries)):
                def call(fn=entries[name]):
                    err = fn(adj.data_ptr(), h.data_ptr(), out.data_ptr(), m, n, d, stream)
                    if err:
                        raise RuntimeError(f"sage_aggregate launch failed with error {err}")
                times[name].append(_time_ms(call, reps))
            print(f"[ceiling] sage_aggregate {shape} in turns: " + "; ".join(
                f"{name} {' '.join(f'{t:.4f}' for t in ts)} ms" for name, ts in times.items()))
            del out
        del a, adj, h
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
