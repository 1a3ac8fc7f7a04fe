"""Build the CUDA kernels of ``csrc/`` at first use and load them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc -c`` for ``sm_90a``, all
started together, and the objects are linked into one shared library with a
plain C interface. The library goes to ``build/kernels/<hash>/`` at the root
of the checkout, keyed by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads at once. There is no fallback: a
missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of each kernel entry point: (argtypes, restype).
SIGNATURES = {
    "sage_aggregate_f32": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
    "sage_aggregate_scratch_bytes": ([_I, _I, _I], ctypes.c_longlong),
    "sim_topk_plan": ([_I, _I, _I, _I, _P], _I),
    "sim_topk_f32": ([_P] * 8 + [_I] * 7 + [_P], _I),
    "sim_topk_plan_rows": ([_I] * 5 + [_P], _I),
    "sim_topk_rows_f32": ([_P] * 12 + [_I] * 8 + [_P], _I),
    "sim_block_fwd": ([_P, _P, _P, _I, _I, _I, _I, _P], _I),
    "flash_attention_f32": ([_P] * 6 + [_I] * 7 + [_F, _P], _I),
    "flash_attention_f32_scratch": ([_I] * 4, ctypes.c_longlong),
    "flash_attention_tc_bf16": ([_P] * 5 + [_I] * 7 + [_F, _P], _I),
    "flash_attention_bwd_f32": ([_P] * 10 + [_I] * 7 + [_F, _P], _I),
    "flash_attention_bwd_f32_scratch": ([_I] * 6, ctypes.c_longlong),
    "flash_attention_bwd_tc_bf16": ([_P] * 10 + [_I] * 7 + [_F, _P], _I),
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the port's CUDA "
                       "kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    cu, cuh = _sources()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> None:
    nvcc = _nvcc()
    cu, _ = _sources()
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=out.parent))
    try:
        objs = [tmp / (p.stem + ".o") for p in cu]
        procs = [subprocess.Popen([nvcc, *ARCH, *FLAGS, "-Xptxas", "-v", "-c",
                                   str(src), "-o", str(obj)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for src, obj in zip(cu, objs)]
        logs = [p.communicate()[0] for p in procs]
        for src, proc, log in zip(cu, procs, logs):
            (out.parent / (src.stem + ".ptxas.txt")).write_text(log)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        so = tmp / out.name
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(so),
                               *map(str, objs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(so, out)   # atomic: a concurrent loader sees all or nothing
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library_path() -> Path:
    return BUILD_ROOT / _digest() / "libreprotorch_kernels.so"


def load() -> ctypes.CDLL:
    """The kernel library, built on first call in this checkout."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.is_file():
        path.parent.mkdir(parents=True, exist_ok=True)
        _compile(path)
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
