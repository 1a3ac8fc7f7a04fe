"""GraphSAGE node classifier on dense padded adjacency (Sec. II-A, Eq. 3).

Counterpart of the GraphSAGE half of ``repro.core.gnn``; GCN and GAT are
still to port. Parameters are the reference's nesting,
``{"layers": [{"w_self", "w_nbr", "b"}, ...]}``, as tensors that may carry a
leading ``[M]`` client axis: where the reference vmaps one client's
``apply_sage`` over M, the port runs it once on the stacked batch.

The neighbor aggregation ``A_norm @ h`` is the per-client compute hot spot;
``aggregate`` routes it through ``kernels.ops.sage_aggregate``, which launches
the CUDA kernel for CUDA tensors and runs the plain version on the CPU.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from repro_torch.kernels import ops

PyTree = Dict


def glorot(generator: torch.Generator, shape, lead=()) -> torch.Tensor:
    """Glorot-uniform weights of ``shape`` (fans from its first two dims),
    one independent draw for each index of the ``lead`` axes."""
    fan_in, fan_out = shape[0], shape[1]
    lim = (6.0 / (fan_in + fan_out)) ** 0.5
    u = torch.rand(tuple(lead) + tuple(shape), generator=generator,
                   device=generator.device, dtype=torch.float32)
    return u * (2 * lim) - lim


def normalize_adjacency(adj: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Row-normalized masked adjacency (GCN mean aggregator), no self loop."""
    mask2d = node_mask[..., :, None] * node_mask[..., None, :]
    a = adj * mask2d
    deg = torch.sum(a, dim=-1, keepdim=True)
    return a / torch.clamp_min(deg, 1.0)


def aggregate(a_norm: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Neighbor mean aggregation AGG(h_v) = A_norm @ h (the sage kernel)."""
    return ops.sage_aggregate(a_norm, h)


def init_sage(generator: torch.Generator, dims: Sequence[int], lead=()) -> PyTree:
    """dims = [d_in, hidden, ..., c]; each layer has self + neighbor weights."""
    params: List[Dict] = []
    for i in range(len(dims) - 1):
        params.append({
            "w_self": glorot(generator, (dims[i], dims[i + 1]), lead),
            "w_nbr": glorot(generator, (dims[i], dims[i + 1]), lead),
            "b": torch.zeros(tuple(lead) + (dims[i + 1],), dtype=torch.float32,
                             device=generator.device),
        })
    return {"layers": params}


def apply_sage(params: PyTree, x, adj, node_mask):
    """Per-node logits [.., n, c]. Masked: padded rows output zeros."""
    a_norm = normalize_adjacency(adj, node_mask)
    h = x * node_mask[..., None]
    n_layers = len(params["layers"])
    for li, layer in enumerate(params["layers"]):
        agg = aggregate(a_norm, h)
        # [h || agg] W  ==  h W_self + agg W_nbr
        h = h @ layer["w_self"] + agg @ layer["w_nbr"] + layer["b"][..., None, :]
        if li < n_layers - 1:
            h = torch.relu(h)
        h = h * node_mask[..., None]
    return h
