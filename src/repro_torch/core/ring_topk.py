"""Candidate-sharded ring top-k for the imputation similarity topology.

Counterpart of ``repro.core.ring_topk``. The adaptive generator's
A̅ = H Hᵀ + cross-subgraph top-k (Sec. III-C) keeps every candidate of an
edge server on one device. Here the CANDIDATE axis is spread over a mesh
(``launch.mesh``, one process per device) instead:

- Each of the ``size`` ranks owns an ``[n/size, c]`` slab of the candidate
  features with its client ids and target mask, and an ``[q/size, c]`` shard
  of the query rows (the candidates themselves, in the engine's use).
- Slabs rotate around the ring: ``size`` folds and ``size - 1`` sends to the
  next rank (``mesh.shift``, one ``batch_isend_irecv`` a step), each moving
  one slab of ``ring_rotation_bytes``: never an all-gather of the candidates.
- Each fold is one call of the ``sim_topk`` kernel (its plain version on the
  CPU) on the query shard against the visiting slab, at ``col_offset =
  owner · n/size``, with the running list folded in by the kernel's merge.
  Ties go to the smallest global index, so the fold does not depend on the
  order in which the slabs arrive.
- After ``size`` folds every rank's list is the exact global top-k of its
  query rows; one all-gather of the ``[N, q/size, k]`` lists reassembles the
  result on every rank.

On the card the folds give the one-call kernel's answer bit for bit.

Each fold runs inside the span ``ring_topk.fold`` and each rotation
inside ``ring_topk.rotate`` (``repro_torch.trace``; ``launch/profile.py``
reports both).
The byte and FLOP accounting of the scaling benchmark is at the bottom.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import trace
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib


def _pad_axis(x: torch.Tensor, axis: int, multiple: int, value) -> torch.Tensor:
    size = x.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return x
    shape = list(x.shape)
    shape[axis] = target - size
    return torch.cat([x, x.new_full(shape, value)], dim=axis)


def fold_slab(run: Optional[Tuple[torch.Tensor, torch.Tensor]], rows: torch.Tensor,
              row_cid: torch.Tensor, cand: torch.Tensor, cand_cid: torch.Tensor,
              cand_mask: torch.Tensor, k: int, offset: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold one candidate slab into the running top-k of the query rows.

    rows: [N, q, c]; cand: [N, m, c]; the scores are masked to
    cross-subgraph valid targets, the slab's columns shifted by ``offset``
    to global candidate indices, and merged with ``run`` (None: an empty
    list) by the kernel's merge."""
    with trace.span("ring_topk.fold"):
        return ops.sim_topk(cand, cand_cid, cand_mask, k, col_offset=offset, rows=rows,
                            row_cid=row_cid, run=run)


def _ring_fold(rows, row_cid, cand, cand_cid, cand_mask, *, k: int, mesh):
    """This rank's ring schedule: ``size`` folds, ``size - 1`` rotations.

    Each argument is this rank's shard. After ``step`` rotations the rank
    holds the slab that started on rank ``(me - step) % size``, whose global
    offset the fold uses.
    """
    size, me = mesh.size, mesh.rank
    shard_n = cand.shape[-2]
    run = None
    for step in range(size):
        owner = (me - step) % size
        run = fold_slab(run, rows, row_cid, cand, cand_cid, cand_mask, k, owner * shard_n)
        if step != size - 1:
            with trace.span("ring_topk.rotate"):
                cand, cand_cid, cand_mask = mesh_lib.shift(mesh, [cand, cand_cid, cand_mask])
    return run


def ring_similarity_topk(h: torch.Tensor, client_ids: torch.Tensor,
                         target_mask: torch.Tensor, k: int, *, mesh,
                         queries: Optional[torch.Tensor] = None,
                         query_cid: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact global masked top-k with the candidate axis sharded on ``mesh``.

    h: ``[n, c]`` or batched ``[B, n, c]`` candidate features, whole on
    every rank (each batch element, one edge server, keeps its own
    candidates); client_ids ``[.., n]``; target_mask ``[.., n]``.
    ``queries`` (default: h, every node queries) may be any ``[.., q, c]``
    rows with their ``query_cid``. Both axes are padded to multiples of the
    mesh size: padded candidates get mask 0 and are never selected, padded
    query rows are sliced off. Each rank folds its query shard over every
    slab, and one all-gather of the lists gives every rank the whole result.

    Returns RAW (vals [.., q, k] f32 with -inf on missing candidates, idx
    [.., q, k] int32 with -1 where never filled); the caller
    (``imputation.similarity_topk``) applies the (0.0, -1) convention.
    """
    if queries is None:
        queries, query_cid = h, client_ids
    batched = h.ndim == 3
    if not batched:
        h, queries = h[None], queries[None]
        client_ids, target_mask, query_cid = (client_ids[None], target_mask[None],
                                              query_cid[None])
    nb, q = queries.shape[0], queries.shape[1]
    size, me = mesh.size, mesh.rank
    cid = client_ids.to(torch.int32).expand(nb, h.shape[1])
    tmask = target_mask.to(torch.float32).expand(nb, h.shape[1])
    qcid = query_cid.to(torch.int32).expand(nb, q)
    if size > 1:
        h = _pad_axis(h, 1, size, 0.0)
        cid = _pad_axis(cid, 1, size, -1)
        tmask = _pad_axis(tmask, 1, size, 0.0)
        queries = _pad_axis(queries, 1, size, 0.0)
        qcid = _pad_axis(qcid, 1, size, -1)
    shard_q, shard_n = queries.shape[1] // size, h.shape[1] // size
    mine_q = slice(me * shard_q, (me + 1) * shard_q)
    mine_n = slice(me * shard_n, (me + 1) * shard_n)
    vals, idx = _ring_fold(queries[:, mine_q], qcid[:, mine_q], h[:, mine_n],
                           cid[:, mine_n], tmask[:, mine_n], k=k, mesh=mesh)
    if size > 1:
        vals, idx = (mesh_lib.all_gather(mesh, t, dim=1) for t in (vals, idx))
    vals, idx = vals[:, :q], idx[:, :q]
    if not batched:
        vals, idx = vals[0], idx[0]
    return vals, idx


# ---------------------------------------------------------------------------
# Traffic / FLOP accounting (the scaling benchmark; conventions as gossip.py).
# ---------------------------------------------------------------------------

def sim_topk_flops(q: int, n: int, c: int) -> float:
    """FLOPs of the masked top-k sweep: the q×n gram at 2·c each (the
    merge's compares are left out, noise next to the gram)."""
    return 2.0 * q * n * c


def ring_rotation_bytes(n: int, c: int, size: int, *, itemsize: int = 4) -> float:
    """Bytes ONE rank sends per rotation step: its current candidate slab,
    the [n/size, c] features plus the [n/size] client ids (int32) and
    target mask (float32)."""
    if size <= 1:
        return 0.0
    shard = (n + size - 1) // size
    return float(shard * (c * itemsize + 4 + 4))


def ring_total_bytes(n: int, c: int, size: int, *, itemsize: int = 4) -> float:
    """Per-rank bytes of one full sweep: size-1 rotations. The same volume
    as a ring all-gather of the candidates, at one slab's residency."""
    return (size - 1) * ring_rotation_bytes(n, c, size, itemsize=itemsize)


def allgather_bytes(n: int, c: int, size: int, *, itemsize: int = 4) -> float:
    """Per-rank bytes of the rejected alternative: all-gather the
    candidates, then run the one-device kernel on the whole [n, c]."""
    if size <= 1:
        return 0.0
    return (size - 1) / size * float(n * (c * itemsize + 4 + 4))
