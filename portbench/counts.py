"""The work of one FGL round, counted from shapes and the graph's nonzeros.

These counts are the benchmark's yardstick: they say what the round needs,
whatever kernel or library does it, so they count the same however a later
change implements the round. Products count 2 FLOPs per multiply-add, on
real (unpadded) rows, and the neighbour aggregation counts A's nonzeros,
not its dense shape. Recomputed work is not counted: layer 1's neighbour
mean depends on the batch alone and counts once a round, and the
imputation's embedding pass counts as the forward it repeats, without it.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class Shapes:
    """What a round's work depends on."""

    rows: int              # real nodes over all clients
    nnz: int               # nonzeros of the clients' adjacency (both directions)
    dims: Sequence[int]    # classifier widths [d, hidden, ..., c]
    local_rounds: int      # T_l
    ae_hidden: int
    assessor_hidden: Sequence[int]
    ae_iters: int
    assessor_iters: int
    ae_outer_iters: int
    cross_pairs: int       # (row, candidate) pairs of different clients on one server


def _layers(dims):
    return list(zip(dims[:-1], dims[1:]))


def classifier_forward(s: Shapes) -> int:
    """One forward without layer 1's neighbour mean: the self and
    neighbour products of every layer, and the later layers' means."""
    flops = 0
    for li, (a, b) in enumerate(_layers(s.dims)):
        flops += 2 * 2 * s.rows * a * b
        if li > 0:
            flops += 2 * s.nnz * a
    return flops


def classifier_backward(s: Shapes) -> int:
    """Weight gradients of every layer; input gradients (through both
    products and the neighbour mean) of every layer but the first."""
    flops = 0
    for li, (a, b) in enumerate(_layers(s.dims)):
        flops += 2 * 2 * s.rows * a * b
        if li > 0:
            flops += 2 * 2 * s.rows * a * b + 2 * s.nnz * a
    return flops


def layer1_mean(s: Shapes) -> int:
    return 2 * s.nnz * s.dims[0]


def generator(s: Shapes) -> int:
    """The servers' autoencoder and assessor training, X̅ = f(S), on every
    real row: T_ae x outer AE steps against the frozen assessor, one
    reconstruction, T_as x outer assessor steps on real and imputed rows."""
    c, d, h = s.dims[-1], s.dims[0], s.ae_hidden
    enc = 2 * (c * h + h * d)
    dec = 2 * (d * h + h * c)
    ae_fwd = enc + dec
    ae_bwd = ae_fwd + (2 * h * d + dec)        # weight grads; input grads past layer 1
    adims = [c] + list(s.assessor_hidden) + [1]
    as_fwd = sum(2 * a * b for a, b in _layers(adims))
    as_wgrad = as_fwd
    as_igrad = as_fwd                           # back to the assessor's input
    as_igrad_inner = as_fwd - 2 * adims[0] * adims[1]
    ae_step = ae_fwd + as_fwd + as_igrad + ae_bwd
    as_step = 2 * as_fwd + 2 * as_wgrad + 2 * as_igrad_inner
    per_row = (s.ae_outer_iters * (s.ae_iters * ae_step + s.assessor_iters * as_step)
               + ae_fwd + enc)
    return s.rows * per_row


def gram(s: Shapes) -> int:
    """The similarity scores of every cross-client pair on a server."""
    return 2 * s.dims[-1] * s.cross_pairs


def round_flops(s: Shapes, impute: bool) -> int:
    """Model FLOPs of one global round: T_l training steps, the evaluation
    forward, layer 1's mean once, and on imputation rounds the embedding
    forward, the generator and the gram."""
    flops = (s.local_rounds * (classifier_forward(s) + classifier_backward(s))
             + classifier_forward(s) + layer1_mean(s))
    if impute:
        flops += classifier_forward(s) + generator(s) + gram(s)
    return flops


def sage_bytes(nnz: int, referenced_rows: int, d: int, out_rows: int) -> int:
    """Least bytes of one ``sage_aggregate``: A's nonzeros (f32 value and
    int32 column), the rows of H they reference, and the whole output."""
    return 8 * nnz + 4 * referenced_rows * d + 4 * out_rows * d


def sim_topk_ops(cross_pairs: int, c: int) -> int:
    return 2 * c * cross_pairs


def sim_topk_bytes(valid_rows: int, c: int, out_rows: int, k: int) -> int:
    """H's valid rows read once, the (score, index) lists written once."""
    return 4 * valid_rows * c + 8 * out_rows * k
