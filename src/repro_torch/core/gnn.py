"""GNN node classifiers on dense padded adjacency (Sec. II-A, Eq. 1-3).

Counterpart of ``repro.core.gnn``: GraphSAGE with the GCN aggregator (the
paper's classifier), GCN and single-head GAT, chosen by
``FGLConfig.gnn_kind`` through :data:`KINDS`. Parameters are the
reference's nesting (``{"layers": [{"w_self", "w_nbr", "b"}, ...]}`` for
SAGE, ``{"w", "b"}`` for GCN, ``{"w", "a_src", "a_dst", "b"}`` for GAT), as
tensors that may carry a leading ``[M]`` client axis: where the reference
vmaps one client's forward over M, the port runs it once on the stacked
batch.

Each kind has a prepare step and an apply step. :func:`prepare` builds a
:class:`Graph` from what no weight touches: for SAGE and GCN the
row-normalised adjacency, the masked features and layer 1's neighbour mean;
for GAT the raw inputs. :func:`forward` runs the layers on it.
:func:`apply_classifier` is the two in turn; a trainer prepares once per
batch and reuses the graph in every forward until the batch is replaced.

The neighbor aggregation ``A_norm @ h`` is the per-client compute hot spot;
``aggregate`` routes it through ``kernels.ops.sage_aggregate``, which launches
the CUDA kernel for CUDA tensors and runs the plain version on the CPU. SAGE
and GCN aggregate through it; GAT's attention is plain PyTorch, as the
reference's is plain ``jnp``.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

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


class Graph(NamedTuple):
    """A batch's classifier inputs that no weight touches (:func:`prepare`).

    SAGE and GCN fill ``a_norm`` (GCN's with self loops), ``h0`` (the
    masked features) and ``agg1`` (layer 1's neighbour mean ``a_norm @
    h0``); GAT fills ``x`` and ``adj``."""

    node_mask: torch.Tensor
    a_norm: Optional[torch.Tensor] = None
    h0: Optional[torch.Tensor] = None
    agg1: Optional[torch.Tensor] = None
    x: Optional[torch.Tensor] = None
    adj: Optional[torch.Tensor] = None


def _mean_graph(a_norm: torch.Tensor, x, node_mask) -> Graph:
    h0 = x * node_mask[..., None]
    return Graph(node_mask, a_norm=a_norm, h0=h0, agg1=aggregate(a_norm, h0))


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


def prepare_sage(x, adj, node_mask) -> Graph:
    return _mean_graph(normalize_adjacency(adj, node_mask), x, node_mask)


def apply_sage(params: PyTree, g: Graph):
    """Per-node logits [.., n, c]. Masked: padded rows output zeros."""
    h = g.h0
    n_layers = len(params["layers"])
    for li, layer in enumerate(params["layers"]):
        agg = g.agg1 if li == 0 else aggregate(g.a_norm, h)
        # [h || agg] W  ==  h W_self + agg W_nbr
        h = h @ layer["w_self"] + agg @ layer["w_nbr"] + layer["b"][..., None, :]
        if li < n_layers - 1:
            h = torch.relu(h)
        h = h * g.node_mask[..., None]
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


def prepare_gcn(x, adj, node_mask) -> Graph:
    """Self loops, then row normalization."""
    eye = torch.eye(adj.shape[-1], dtype=adj.dtype, device=adj.device)
    return _mean_graph(normalize_adjacency(adj + eye, node_mask), x, node_mask)


def apply_gcn(params: PyTree, g: Graph):
    """Per-node logits [.., n, c]."""
    h = g.h0
    n_layers = len(params["layers"])
    for li, layer in enumerate(params["layers"]):
        agg = g.agg1 if li == 0 else aggregate(g.a_norm, h)
        h = agg @ layer["w"] + layer["b"][..., None, :]
        if li < n_layers - 1:
            h = torch.relu(h)
        h = h * g.node_mask[..., None]
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


def prepare_gat(x, adj, node_mask) -> Graph:
    return Graph(node_mask, x=x, adj=adj)


def apply_gat(params: PyTree, g: Graph):
    """Per-node logits [.., n, c]: masked softmax attention over self loops
    and neighbors (non-edges filled with -1e9, then zeroed), ELU between
    layers."""
    x, adj, node_mask = g.x, g.adj, g.node_mask
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
    "sage": (init_sage, prepare_sage, apply_sage),
    "gcn": (init_gcn, prepare_gcn, apply_gcn),
    "gat": (init_gat, prepare_gat, apply_gat),
}


def init_classifier(generator: torch.Generator, kind: str, dims: Sequence[int],
                    lead=()) -> PyTree:
    return KINDS[kind][0](generator, dims, lead)


def prepare(kind: str, x, adj, node_mask) -> Graph:
    """The batch's :class:`Graph` for classifiers of ``kind``."""
    return KINDS[kind][1](x, adj, node_mask)


def forward(params: PyTree, kind: str, g: Graph):
    """Per-node logits [.., n, c] on a prepared graph."""
    return KINDS[kind][2](params, g)


def apply_classifier(params: PyTree, kind: str, x, adj, node_mask):
    return forward(params, kind, prepare(kind, x, adj, node_mask))
