"""Functional Adam over parameter trees (counterpart of ``repro.optim.adam.Adam``).

The same order of operations as the reference, so both packages take the
same steps to float32 rounding: float32 moments, bias corrections
``1 - b1**t`` with ``t`` as float32, ``eps`` added outside the square root,
and the ``step`` counter kept in the state. ``torch.optim.Adam`` folds the
corrections into the step size differently and is not used.

State may be stacked: the per-server generator state carries ``step`` of
shape ``[N]`` (the reference vmaps ``init``/``update`` over servers), and the
corrections then broadcast over each leaf's leading ``[N]`` axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


class AdamState(NamedTuple):
    step: torch.Tensor   # int32, scalar or [N]
    mu: PyTree           # first moment (like params)
    nu: PyTree           # second moment (like params)


@dataclasses.dataclass(frozen=True)
class Adam:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: PyTree, *, lead: Tuple[int, ...] = ()) -> AdamState:
        """Zero moments; ``lead`` is the shape of a stacked step counter."""
        zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        device = tree_leaves(params)[0].device
        return AdamState(step=torch.zeros(lead, dtype=torch.int32, device=device),
                         mu=zeros, nu=tree_map(torch.clone, zeros))

    def update(self, grads: PyTree, state: AdamState, params: PyTree
               ) -> Tuple[PyTree, AdamState]:
        """Returns (new_params, new_state)."""
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state.nu, grads)
        t = step.float()
        c1 = 1.0 - torch.pow(b1, t)     # a scalar base: no host-to-device copy
        c2 = 1.0 - torch.pow(b2, t)

        def upd(p, m, v):
            tail = (1,) * (p.ndim - step.ndim)
            mhat = m / c1.reshape(step.shape + tail)
            vhat = v / c2.reshape(step.shape + tail)
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            return (p.float() - self.lr * delta).to(p.dtype)

        new_params = tree_map(upd, params, mu, nu)
        return new_params, AdamState(step=step, mu=mu, nu=nu)

