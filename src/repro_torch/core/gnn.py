"""GNN node classifiers on dense padded adjacency (Sec. II-A, Eq. 1-3).

Counterpart of ``repro.core.gnn``: GraphSAGE with the GCN aggregator (the
paper's classifier), GCN and single-head GAT, chosen by
``FGLConfig.gnn_kind`` through :data:`KINDS`. Parameters are the
reference's nesting (``{"layers": [{"w_self", "w_nbr", "b"}, ...]}`` for
SAGE, ``{"w", "b"}`` for GCN, ``{"w", "a_src", "a_dst", "b"}`` for GAT), as
tensors that may carry a leading ``[M]`` client axis: where the reference
vmaps one client's forward over M, the port runs it once on the stacked
batch.

The neighbor aggregation ``A_norm @ h`` is the per-client compute hot spot;
``aggregate`` routes it through ``kernels.ops.sage_aggregate``, which launches
the CUDA kernel for CUDA tensors and runs the plain version on the CPU. SAGE
and GCN aggregate through it; GAT's attention is plain PyTorch, as the
reference's is plain ``jnp``.
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


# ---------------------------------------------------------------------------
# GCN, Eq. (1)
# ---------------------------------------------------------------------------

def init_gcn(generator: torch.Generator, dims: Sequence[int], lead=()) -> PyTree:
    return {"layers": [{
        "w": glorot(generator, (dims[i], dims[i + 1]), lead),
        "b": torch.zeros(tuple(lead) + (dims[i + 1],), dtype=torch.float32,
                         device=generator.device),
    } for i in range(len(dims) - 1)]}


def apply_gcn(params: PyTree, x, adj, node_mask):
    """Per-node logits [.., n, c]: self loops, then row normalization."""
    eye = torch.eye(adj.shape[-1], dtype=adj.dtype, device=adj.device)
    a_norm = normalize_adjacency(adj + eye, node_mask)
    h = x * node_mask[..., None]
    n_layers = len(params["layers"])
    for li, layer in enumerate(params["layers"]):
        h = aggregate(a_norm, h) @ layer["w"] + layer["b"][..., None, :]
        if li < n_layers - 1:
            h = torch.relu(h)
        h = h * node_mask[..., None]
    return h


# ---------------------------------------------------------------------------
# GAT, Eq. (2) (one attention head per layer)
# ---------------------------------------------------------------------------

def init_gat(generator: torch.Generator, dims: Sequence[int], lead=()) -> PyTree:
    params: List[Dict] = []
    for i in range(len(dims) - 1):
        params.append({
            "w": glorot(generator, (dims[i], dims[i + 1]), lead),
            "a_src": glorot(generator, (dims[i + 1], 1), lead),
            "a_dst": glorot(generator, (dims[i + 1], 1), lead),
            "b": torch.zeros(tuple(lead) + (dims[i + 1],), dtype=torch.float32,
                             device=generator.device),
        })
    return {"layers": params}


def apply_gat(params: PyTree, x, adj, node_mask):
    """Per-node logits [.., n, c]: masked softmax attention over self loops
    and neighbors (non-edges filled with -1e9, then zeroed), ELU between
    layers."""
    mask2d = node_mask[..., :, None] * node_mask[..., None, :]
    eye = torch.eye(adj.shape[-1], dtype=adj.dtype, device=adj.device)
    no_edge = ((adj + eye) * mask2d) <= 0
    h = x * node_mask[..., None]
    n_layers = len(params["layers"])
    for li, layer in enumerate(params["layers"]):
        z = h @ layer["w"]
        e = z @ layer["a_src"] + torch.transpose(z @ layer["a_dst"], -1, -2)
        e = torch.nn.functional.leaky_relu(e, 0.2)
        att = torch.softmax(e.masked_fill(no_edge, -1e9), dim=-1)
        att = att.masked_fill(no_edge, 0.0)
        h = att @ z + layer["b"][..., None, :]
        if li < n_layers - 1:
            h = torch.nn.functional.elu(h)
        h = h * node_mask[..., None]
    return h


KINDS = {
    "sage": (init_sage, apply_sage),
    "gcn": (init_gcn, apply_gcn),
    "gat": (init_gat, apply_gat),
}


def init_classifier(generator: torch.Generator, kind: str, dims: Sequence[int],
                    lead=()) -> PyTree:
    return KINDS[kind][0](generator, dims, lead)


def apply_classifier(params: PyTree, kind: str, x, adj, node_mask):
    return KINDS[kind][1](params, x, adj, node_mask)
