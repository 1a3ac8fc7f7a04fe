"""Adam and SGD over parameter trees, global-norm clipping and a cosine
schedule (counterpart of ``repro.optim.adam``).

The same order of operations as the reference, so both packages take the
same steps to float32 rounding: float32 moments, bias corrections
``1 - b1**t`` with ``t`` as float32, ``eps`` added outside the square root,
the ``step`` counter kept in the state, clipping by the global norm before
the moments (clipped gradients are float32, as the reference's product of a
gradient and its f32 scale), and the schedule evaluated on the float32 step.
``torch.optim.Adam`` folds the corrections into the step size differently
and is not used.

``update_`` writes the new moments and parameters into the given tensors,
one leaf at a time, so a step holds no second copy of the moments: at full
Qwen3-4B size a functional update would keep 29 GB of old and new f32
moments alive together. ``Adam.update`` is its functional form, on copies
(the FGL engine's, which keeps its states).

Adam's state may be stacked: the per-server generator state carries ``step``
of shape ``[N]`` (the reference vmaps ``init``/``update`` over servers), and
the corrections then broadcast over each leaf's leading ``[N]`` axis.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


class AdamState(NamedTuple):
    step: torch.Tensor   # int32, scalar or [N]
    mu: PyTree           # first moment (like params)
    nu: PyTree           # second moment (like params)


def _clone_tree(tree: PyTree) -> PyTree:
    return tree_map(torch.clone, tree)


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum over leaves of their f32 sums of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float())) for leaf in tree_leaves(tree)))


def _clip_scale(grads: PyTree, max_norm: float) -> torch.Tensor:
    norm = global_norm(grads)
    return torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)


def clip_by_global_norm(grads: PyTree, max_norm: float) -> PyTree:
    """Every leaf times ``min(1, max_norm / max(global_norm, 1e-12))``, in f32."""
    scale = _clip_scale(grads, max_norm)
    return tree_map(lambda g: g.float() * scale, grads)


def cosine_schedule(warmup: int, total: int, min_frac: float = 0.1
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warm-up over ``warmup`` steps, then a cosine from 1 to
    ``min_frac`` at ``total``; a multiplier of the learning rate."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = torch.clamp_max(step / max(warmup, 1), 1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return warm * cos
    return fn


@dataclasses.dataclass(frozen=True)
class Adam:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = None
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def init(self, params: PyTree, *, lead: Tuple[int, ...] = ()) -> AdamState:
        """Zero moments; ``lead`` is the shape of a stacked step counter."""
        zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        device = tree_leaves(params)[0].device
        return AdamState(step=torch.zeros(lead, dtype=torch.int32, device=device),
                         mu=zeros, nu=tree_map(torch.clone, zeros))

    def update(self, grads: PyTree, state: AdamState, params: PyTree
               ) -> Tuple[PyTree, AdamState]:
        """Returns (new_params, new_state), leaving the arguments as they were."""
        state = AdamState(step=state.step, mu=_clone_tree(state.mu), nu=_clone_tree(state.nu))
        params = _clone_tree(params)
        return params, self.update_(grads, state, params)

    @torch.no_grad()
    def update_(self, grads: PyTree, state: AdamState, params: PyTree) -> AdamState:
        """One step written into ``params`` and the moments of ``state``, leaf
        by leaf; returns the state with its step advanced."""
        scale = _clip_scale(grads, self.clip_norm) if self.clip_norm is not None else None
        step = state.step + 1
        lr = self.lr * (self.schedule(step) if self.schedule is not None else 1.0)
        b1, b2 = self.b1, self.b2
        t = step.float()
        c1 = 1.0 - torch.pow(b1, t)     # a scalar base: no host-to-device copy
        c2 = 1.0 - torch.pow(b2, t)
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state.mu), tree_leaves(state.nu)):
            g = g.float() if scale is None else g.float() * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            del g
            # The reference's mhat / (sqrt(vhat) + eps), on as few f32 temporaries as can be.
            tail = (1,) * (p.ndim - step.ndim)
            delta = m / c1.reshape(step.shape + tail)
            denom = v / c2.reshape(step.shape + tail)
            delta.div_(denom.sqrt_().add_(self.eps))
            del denom
            if self.weight_decay:
                delta.add_(self.weight_decay * p.float())
            p.copy_(p.float() - delta.mul_(lr))
        return AdamState(step=step, mu=state.mu, nu=state.nu)


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: float = 0.01
    momentum: float = 0.0
    clip_norm: Optional[float] = None

    def init(self, params: PyTree):
        """f32 momentum buffers, or ``()`` without momentum."""
        if self.momentum:
            return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return ()

    @torch.no_grad()
    def update_(self, grads: PyTree, state, params: PyTree):
        """One step written into ``params`` and the momentum buffers; returns
        the state."""
        scale = _clip_scale(grads, self.clip_norm) if self.clip_norm is not None else None
        bufs = tree_leaves(state) if self.momentum else [None] * len(tree_leaves(params))
        for p, g, buf in zip(tree_leaves(params), tree_leaves(grads), bufs):
            if scale is not None:
                g = g.float() * scale
            if buf is not None:
                buf.mul_(self.momentum).add_(g.float())
                g = buf
            # The reference's lr * g keeps g's dtype (a Python float is weakly typed).
            p.copy_(p.float() - self.lr * g)
        return state
