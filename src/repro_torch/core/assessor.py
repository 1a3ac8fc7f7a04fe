"""Versatile assessor + negative sampling (Sec. III-C/D, Eq. 11-14).

Counterpart of ``repro.core.assessor``. The assessor is an MLP {c, 128, 16, 1}
with ReLU hidden layers and a sigmoid head. Parameters and inputs may carry
a leading ``[N]`` server axis; each loss then returns one value per server
(reduced over the node axis), and the trainer sums them so that each
server's gradients stay its own, as under the reference's vmap.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.core import imputation
from repro_torch.core.gnn import glorot

PyTree = Dict
_EPS = 1e-6


def init_assessor(generator: torch.Generator, c: int,
                  hidden: Sequence[int] = (128, 16), lead=()) -> PyTree:
    dims = (c,) + tuple(hidden) + (1,)
    layers = []
    for i in range(len(dims) - 1):
        layers.append({"w": glorot(generator, (dims[i], dims[i + 1]), lead),
                       "b": torch.zeros(tuple(lead) + (dims[i + 1],),
                                        dtype=torch.float32, device=generator.device)})
    return {"layers": layers}


def apply_assessor(params: PyTree, h: torch.Tensor) -> torch.Tensor:
    """Score in (0,1) per node: [.., n, c] -> [.., n]."""
    z = h
    n_layers = len(params["layers"])
    for li, layer in enumerate(params["layers"]):
        z = z @ layer["w"] + layer["b"][..., None, :]
        if li < n_layers - 1:
            z = torch.relu(z)
    return torch.sigmoid(z[..., 0])


def negative_mask(h_real: torch.Tensor, theta: float) -> torch.Tensor:
    """e_u (Eq. 13): 1 where the attribute exceeds the threshold theta."""
    return (h_real > theta).to(h_real.dtype)


def _masked_mean(per_node: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    denom = torch.clamp_min(torch.sum(node_mask, dim=-1), 1.0)
    return torch.sum(per_node * node_mask, dim=-1) / denom


def assessor_loss(params_as: PyTree, h_real, h_fake, e, node_mask) -> torch.Tensor:
    """Eq. (13). Minimized in the assessor's parameters."""
    s_real = apply_assessor(params_as, h_real * e)
    s_fake = apply_assessor(params_as, h_fake * e)
    per_node = torch.log1p(-s_real + _EPS) + torch.log(s_fake + _EPS)
    return _masked_mean(per_node, node_mask)


def autoencoder_loss(params_ae: PyTree, params_as: PyTree, s_noise, h_real, e,
                     node_mask) -> torch.Tensor:
    """Eq. (14). Minimized in the autoencoder's parameters (assessor frozen)."""
    _, h_fake = imputation.reconstruct(params_ae, s_noise)
    s_fake = apply_assessor(params_as, h_fake * e)
    adv = torch.log1p(-s_fake + _EPS)
    neg = (h_real - h_fake) * (1.0 - e)
    rec = torch.sum(neg * neg, dim=-1)
    return _masked_mean(adv + rec, node_mask)


def autoencoder_loss_plain(params_ae: PyTree, params_as: PyTree, s_noise,
                           node_mask) -> torch.Tensor:
    """Eq. (11): ablation variant WITHOUT negative sampling (Fig. 7 'w/o NS')."""
    _, h_fake = imputation.reconstruct(params_ae, s_noise)
    s_fake = apply_assessor(params_as, h_fake)
    return _masked_mean(torch.log1p(-s_fake + _EPS), node_mask)


def assessor_loss_plain(params_as: PyTree, h_real, h_fake, node_mask) -> torch.Tensor:
    """Eq. (12): ablation variant WITHOUT negative sampling."""
    s_real = apply_assessor(params_as, h_real)
    s_fake = apply_assessor(params_as, h_fake)
    per_node = torch.log1p(-s_real + _EPS) + torch.log(s_fake + _EPS)
    return _masked_mean(per_node, node_mask)
