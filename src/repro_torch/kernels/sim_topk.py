"""CUDA ``sim_topk`` and ``sim_block``: the similarity kernels of imputation.

``launch`` replaces the TPU kernel ``sim_topk`` / ``_sim_topk_kernel`` (and
its merge ``topk_merge``) of ``src/repro/kernels/sim_topk.py``, wrapper in
``src/repro/kernels/ops.py``. The kernel (``csrc/sim_topk.cu``) scores every
row of ``h[b]`` against every candidate of the same server ``b``, keeps the
cross-client candidates whose target mask is set, and returns the k best,
ties to the smallest index, for all N servers in one call. It splits the
candidate axis into chunks (``plan``), keeps a partial top-k per row and
chunk in a workspace that ``launch`` allocates (with a per-row bound that
the chunks share, below which no score is kept), and folds the chunks' lists
in a second kernel by ``topk_merge``'s rule, so the result does not depend on
the split. Its plain version is ``ref.sim_topk``.

``launch_block`` replaces the TPU kernel ``sim_block`` / ``_sim_kernel`` of
the same module: the unfused gram slab ``rows @ hᵀ`` (``csrc/sim_block.cu``),
which no training path calls; its plain version is ``ref.sim_block``.

Each source note says what bounds its kernel on the H100 and what its design
does about that.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

launches = 0         # kernel launches made by `launch`, read by chip_smoke.py
block_launches = 0   # kernel launches made by `launch_block`

MAX_K = 16     # register top-k depth the kernel is instantiated for
MAX_C = 16     # feature width of the staged candidate tile
_BLOCK_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # sim_block's type codes


def plan(nb: int, n: int, c: int, k: int) -> Tuple[int, int, int]:
    """How the kernel splits the candidate axis of ``h [nb, n, c]`` for a top-k
    on this device: (chunks, candidates per chunk, depth of each partial
    list); candidate j lies in chunk ``j // chunk_len``. Chosen from the
    shape, the SM count and the kernel's occupancy."""
    out = (ctypes.c_int * 3)()
    build.check(build.load().sim_topk_plan(nb, n, c, k, ctypes.addressof(out)), "sim_topk plan")
    return out[0], out[1], out[2]


def launch(h: torch.Tensor, client_ids: torch.Tensor, target_mask: torch.Tensor,
           k: int, col_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the CUDA kernel on ``h [N, n, c]``, ``client_ids [N, n]`` (or
    ``[n]``), ``target_mask [N, n]``. Returns (vals [N, n, k] float32,
    idx [N, n, k] int32)."""
    global launches
    if h.device.type != "cuda":
        raise ValueError(f"sim_topk kernel needs a CUDA tensor, got {h.device}")
    if h.dtype != torch.float32:
        raise TypeError(f"sim_topk kernel takes float32 h, got {h.dtype}")
    if h.ndim != 3:
        raise ValueError(f"expected h [N, n, c], got {tuple(h.shape)}")
    nb, n, c = h.shape
    if not 1 <= k <= min(n, MAX_K):
        raise ValueError(f"sim_topk kernel needs 1 <= k <= min(n, {MAX_K}), "
                         f"got k={k}, n={n}")
    if not 1 <= c <= MAX_C:
        raise ValueError(f"sim_topk kernel needs 1 <= c <= {MAX_C}, got c={c}")
    if nb > 65535:
        raise ValueError(f"batch {nb} exceeds the grid's y limit")
    cid = client_ids.to(device=h.device, dtype=torch.int32).expand(nb, n).contiguous()
    mask = target_mask.to(device=h.device, dtype=torch.float32).expand(nb, n).contiguous()
    h = h.contiguous()
    vals = torch.empty((nb, n, k), dtype=torch.float32, device=h.device)
    idx = torch.empty((nb, n, k), dtype=torch.int32, device=h.device)
    chunks, chunk_len, depth = plan(nb, n, c, k)
    part_v = torch.empty((nb, chunks, n, depth), dtype=torch.float32, device=h.device)
    part_i = torch.empty((nb, chunks, n, depth), dtype=torch.int32, device=h.device)
    bound = torch.full((nb, n), -2**31, dtype=torch.int32, device=h.device)
    err = build.load().sim_topk_f32(
        h.data_ptr(), cid.data_ptr(), mask.data_ptr(), part_v.data_ptr(), part_i.data_ptr(),
        bound.data_ptr(), vals.data_ptr(), idx.data_ptr(), nb, n, c, k, chunks, chunk_len,
        int(col_offset),
        torch.cuda.current_stream(h.device).cuda_stream)
    build.check(err, "sim_topk")
    launches += 1
    return vals, idx


def launch_block(rows: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Run the CUDA kernel on ``rows [b, c]`` and ``h [n, c]``, both float32 or
    both bfloat16. Returns ``rows @ hᵀ`` [b, n] in their type, summed in f32."""
    global block_launches
    if rows.device.type != "cuda" or h.device != rows.device:
        raise ValueError(f"sim_block kernel needs both tensors on one CUDA device, "
                         f"got {rows.device} and {h.device}")
    if rows.dtype not in _BLOCK_DTYPES or h.dtype != rows.dtype:
        raise TypeError(f"sim_block kernel takes float32 or bfloat16 for both inputs, "
                        f"got {rows.dtype}, {h.dtype}")
    if rows.ndim != 2 or h.ndim != 2 or rows.shape[1] != h.shape[1]:
        raise ValueError(f"expected rows [b, c] and h [n, c], got {tuple(rows.shape)} "
                         f"and {tuple(h.shape)}")
    b, c = rows.shape
    n = h.shape[0]
    if -(-b // 128) > 65535:
        raise ValueError(f"b={b} exceeds the grid's y limit of {65535 * 128} rows")
    rows, h = rows.contiguous(), h.contiguous()
    out = torch.empty((b, n), dtype=rows.dtype, device=rows.device)
    if out.numel() == 0:
        return out
    lib = build.load()
    err = lib.sim_block_fwd(rows.data_ptr(), h.data_ptr(), out.data_ptr(),
                            _BLOCK_DTYPES[rows.dtype], b, n, c,
                            torch.cuda.current_stream(rows.device).cuda_stream)
    build.check(err, "sim_block")
    block_launches += 1
    return out
