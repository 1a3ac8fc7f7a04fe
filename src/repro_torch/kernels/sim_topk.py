"""CUDA ``sim_topk`` and ``sim_block``: the similarity kernels of imputation.

``launch_rows`` replaces the TPU kernel ``sim_topk`` / ``_sim_topk_kernel``
(and its merge ``topk_merge``) of ``src/repro/kernels/sim_topk.py``, wrapper
in ``src/repro/kernels/ops.py``, with its interface: query rows apart from a
candidate slab, each with its own client ids, the slab's target mask and a
``col_offset``, batched over the server axis, and a running list to fold
into (the ring top-k's fold, ``core/ring_topk.py``). ``launch`` is its square
call, the rows being the candidates. The kernel (``csrc/sim_topk.cu``)
scores every query row of server ``b`` against every candidate of ``b``,
keeps the cross-client candidates whose target mask is set, and returns the
k best, ties to the smallest global index, for all N servers in one call. It splits the
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
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

launches = 0         # kernel launches made by `launch_rows` (and `launch`), read by chip_smoke.py
block_launches = 0   # kernel launches made by `launch_block`

MAX_K = 16     # register top-k depth the kernel is instantiated for
MAX_C = 16     # feature width of the staged candidate tile
_BLOCK_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # sim_block's type codes


def plan(nb: int, n: int, c: int, k: int, nq: Optional[int] = None) -> Tuple[int, int, int]:
    """How the kernel splits the candidate axis of ``h [nb, n, c]`` for a top-k
    of ``nq`` query rows (``n``, the square call, when None) on this device:
    (chunks, candidates per chunk, depth of each partial list); candidate j
    lies in chunk ``j // chunk_len``. Chosen from the shape, the SM count and
    the kernel's occupancy."""
    out = (ctypes.c_int * 3)()
    lib = build.load()
    err = (lib.sim_topk_plan(nb, n, c, k, ctypes.addressof(out)) if nq is None else
           lib.sim_topk_plan_rows(nb, nq, n, c, k, ctypes.addressof(out)))
    build.check(err, "sim_topk plan")
    return out[0], out[1], out[2]


def _server_axis(t: torch.Tensor, nb: int, n: int, dtype, dev) -> torch.Tensor:
    """``t`` ([n] or [nb, n]) as a contiguous [nb, n] tensor of ``dtype``."""
    return t.to(device=dev, dtype=dtype).expand(nb, n).contiguous()


def _check(h: torch.Tensor, what: str) -> None:
    if h.device.type != "cuda":
        raise ValueError(f"sim_topk kernel needs CUDA tensors, got {what} on {h.device}")
    if h.dtype != torch.float32:
        raise TypeError(f"sim_topk kernel takes float32 {what}, got {h.dtype}")
    if h.ndim != 3:
        raise ValueError(f"expected {what} [N, n, c], got {tuple(h.shape)}")
    if not 1 <= h.shape[2] <= MAX_C:
        raise ValueError(f"sim_topk kernel needs 1 <= c <= {MAX_C}, got c={h.shape[2]}")
    if h.shape[0] > 65535:
        raise ValueError(f"batch {h.shape[0]} exceeds the grid's y limit")


def launch(h: torch.Tensor, client_ids: torch.Tensor, target_mask: torch.Tensor,
           k: int, col_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The square call: every row of ``h [N, n, c]`` against ``h`` itself,
    ``client_ids [N, n]`` (or ``[n]``), ``target_mask [N, n]``, k <= n.
    Returns (vals [N, n, k] float32, idx [N, n, k] int32)."""
    global launches
    _check(h, "h")
    nb, n, c = h.shape
    if not 1 <= k <= min(n, MAX_K):
        raise ValueError(f"sim_topk kernel needs 1 <= k <= min(n, {MAX_K}), "
                         f"got k={k}, n={n}")
    cid = _server_axis(client_ids, nb, n, torch.int32, h.device)
    mask = _server_axis(target_mask, nb, n, torch.float32, h.device)
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
        int(col_offset), torch.cuda.current_stream(h.device).cuda_stream)
    build.check(err, "sim_topk")
    launches += 1
    return vals, idx


def launch_rows(rows: torch.Tensor, row_cid: torch.Tensor, cand: torch.Tensor,
                cand_cid: torch.Tensor, cand_mask: torch.Tensor, k: int,
                col_offset: int = 0,
                run: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the CUDA kernel on query rows ``rows [N, q, c]`` of clients
    ``row_cid [N, q]`` (or ``[q]``) against the candidates ``cand [N, m, c]``,
    ``cand_cid`` and ``cand_mask`` ``[N, m]`` (or ``[m]``): the TPU kernel's
    interface, batched over the server axis. Candidate j comes out as index
    ``col_offset + j``. ``run``, a running list (vals [N, q, k] float32, idx
    [N, q, k] int32, global indices) from an earlier call, is folded in by
    the merge kernel; ties go to the smallest global index, so a fold over
    slabs gives the one call's result whatever their order. k may exceed m.
    Returns (vals [N, q, k] float32, idx [N, q, k] int32)."""
    global launches
    _check(rows, "rows")
    _check(cand, "candidates")
    if cand.device != rows.device or rows.shape[0] != cand.shape[0] \
            or rows.shape[2] != cand.shape[2]:
        raise ValueError(f"expected rows [N, q, c] and candidates [N, m, c] on one device, "
                         f"got {tuple(rows.shape)} on {rows.device} and "
                         f"{tuple(cand.shape)} on {cand.device}")
    nb, nq, c = rows.shape
    n = cand.shape[1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"sim_topk kernel needs 1 <= k <= {MAX_K}, got k={k}")
    if nq == 0 or n == 0:
        raise ValueError(f"sim_topk kernel needs query rows and candidates, got q={nq}, "
                         f"m={n}")
    dev = rows.device
    vals = torch.empty((nb, nq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nb, nq, k), dtype=torch.int32, device=dev)
    qcid = _server_axis(row_cid, nb, nq, torch.int32, dev)
    cid = _server_axis(cand_cid, nb, n, torch.int32, dev)
    mask = _server_axis(cand_mask, nb, n, torch.float32, dev)
    rows, cand = rows.contiguous(), cand.contiguous()
    run_ptrs = (None, None)
    if run is not None:
        run_v = run[0].to(device=dev, dtype=torch.float32).contiguous()
        run_i = run[1].to(device=dev, dtype=torch.int32).contiguous()
        if run_v.shape != (nb, nq, k) or run_i.shape != (nb, nq, k):
            raise ValueError(f"running list must be [{nb}, {nq}, {k}], got "
                             f"{tuple(run_v.shape)} and {tuple(run_i.shape)}")
        run_ptrs = (run_v.data_ptr(), run_i.data_ptr())
    chunks, chunk_len, depth = plan(nb, n, c, k, nq=nq)
    part_v = torch.empty((nb, chunks, nq, depth), dtype=torch.float32, device=dev)
    part_i = torch.empty((nb, chunks, nq, depth), dtype=torch.int32, device=dev)
    bound = torch.full((nb, nq), -2**31, dtype=torch.int32, device=dev)
    err = build.load().sim_topk_rows_f32(
        rows.data_ptr(), qcid.data_ptr(), cand.data_ptr(), cid.data_ptr(), mask.data_ptr(),
        run_ptrs[0], run_ptrs[1], part_v.data_ptr(), part_i.data_ptr(), bound.data_ptr(),
        vals.data_ptr(), idx.data_ptr(), nb, nq, n, c, k, chunks, chunk_len, int(col_offset),
        torch.cuda.current_stream(dev).cuda_stream)
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
