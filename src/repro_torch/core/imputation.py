"""Adaptive graph imputation generator (Sec. III-C).

Counterpart of ``repro.core.imputation``. Every function takes tensors that
may carry a leading ``[N]`` server axis, so the whole imputation round runs
once over all N servers where the reference vmaps one server's round.

1. Fuse client embeddings into the globally-shared information H^j (Eq. 9).
2. Keep, per node, the top-k most similar *cross-subgraph* nodes of
   A̅ = H Hᵀ as imputed links: the fused masked ``sim_topk`` kernel, one
   launch for all N servers, or the ring over a mesh (``ring_topk``).
3. An autoencoder maps noise S through f ({c,16,d}) to imputed features
   X̅ = f(S) and back through h ({d,16,c}) (Eq. 10), trained adversarially
   against the assessor (``assessor.py``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.gnn import glorot
from repro_torch.kernels import ops

PyTree = Dict


def fuse_embeddings(client_h: torch.Tensor, node_mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[.., M, n_pad, c] client embeddings -> flat H^j [.., M*n_pad, c] (Eq. 9).

    Returns (h_global, flat_mask); padded slots keep mask 0.
    """
    *lead, m, n_pad, c = client_h.shape
    return (client_h.reshape(*lead, m * n_pad, c),
            node_mask.reshape(*lead, m * n_pad))


def client_of_flat(num_clients: int, n_pad: int, device=None) -> torch.Tensor:
    """[M*n_pad] owning-client id of each flattened global slot."""
    return torch.repeat_interleave(
        torch.arange(num_clients, dtype=torch.int32, device=device), n_pad)


def similarity_topk(h: torch.Tensor, flat_mask: torch.Tensor, client_ids: torch.Tensor,
                    k: int, *, target_mask: Optional[torch.Tensor] = None, mesh=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k most-similar cross-subgraph nodes per node, batched over [N].

    ``flat_mask`` marks valid *source* rows; ``target_mask`` (defaults to
    ``flat_mask``) marks slots allowed as link targets. With ``mesh`` (a
    ``launch.mesh.Mesh``) the candidate axis is sharded over its ranks and
    slabs rotate around the ring (``core/ring_topk.py``); otherwise one
    ``sim_topk`` call covers every server. Returns (scores [.., n, k], idx
    [.., n, k] int32); rows with mask 0 and unfilled candidate slots get
    idx -1 / score 0, as in the reference.
    """
    if target_mask is None:
        target_mask = flat_mask
    if mesh is not None:
        from repro_torch.core.ring_topk import ring_similarity_topk
        scores, idx = ring_similarity_topk(h, client_ids, target_mask, k, mesh=mesh)
    else:
        scores, idx = ops.sim_topk(h, client_ids, target_mask, k)
    valid = (flat_mask[..., None] > 0) & torch.isfinite(scores)
    idx = torch.where(valid, idx.to(torch.int32), torch.full_like(idx, -1))
    scores = torch.where(valid, scores, torch.zeros_like(scores))
    return scores, idx


def local_slot_mask(num_clients: int, n_pad: int, n_local: int, device=None) -> torch.Tensor:
    """[num_clients*n_pad] mask of *real local* slots (aug slots excluded)."""
    local = (torch.arange(n_pad, device=device) < n_local).to(torch.float32)
    return local.repeat(num_clients)


# ---------------------------------------------------------------------------
# Eq. (10): autoencoder S -> X̅ = f(S) -> H̄ = h(X̅).
# ---------------------------------------------------------------------------

def init_autoencoder(generator: torch.Generator, c: int, d: int, hidden: int = 16,
                     lead=()) -> PyTree:
    """One autoencoder, or one per index of ``lead`` (the [N] server axis)."""
    def zeros(w):
        return torch.zeros(tuple(lead) + (w,), dtype=torch.float32,
                           device=generator.device)
    return {
        "enc": [
            {"w": glorot(generator, (c, hidden), lead), "b": zeros(hidden)},
            {"w": glorot(generator, (hidden, d), lead), "b": zeros(d)},
        ],
        "dec": [
            {"w": glorot(generator, (d, hidden), lead), "b": zeros(hidden)},
            {"w": glorot(generator, (hidden, c), lead), "b": zeros(c)},
        ],
    }


def _dense(layer, x):
    return x @ layer["w"] + layer["b"][..., None, :]


def encode(params: PyTree, s: torch.Tensor) -> torch.Tensor:
    """X̅ = f(S): imputed potential features."""
    return _dense(params["enc"][1], torch.relu(_dense(params["enc"][0], s)))


def decode(params: PyTree, x_bar: torch.Tensor) -> torch.Tensor:
    """H̄ = h(X̅); softmax last layer (paper: Softmax activation in the AE head)."""
    logits = _dense(params["dec"][1], torch.relu(_dense(params["dec"][0], x_bar)))
    return torch.softmax(logits, dim=-1)


def reconstruct(params: PyTree, s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x_bar = encode(params, s)
    return x_bar, decode(params, x_bar)


def sample_noise(generator: torch.Generator, n: int, c: int, lead=()) -> torch.Tensor:
    """Random noise S [*lead, n, c] (privacy: the AE never sees raw features)."""
    return torch.randn(tuple(lead) + (n, c), generator=generator,
                       device=generator.device, dtype=torch.float32)
