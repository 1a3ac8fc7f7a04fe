"""Nested dict/list/tuple parameter trees of tensors.

The reference keeps parameters and optimizer state as JAX pytrees; the port
keeps the same nesting (``{"layers": [{"w_self": .., "w_nbr": .., "b": ..}]}``)
as plain containers of tensors, walked by these helpers.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch

Tree = Any
_INT_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leafwise over trees of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> List[Any]:
    """Leaves in a fixed (insertion) order."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like: Tree, leaves: List[Any]) -> Tree:
    """Rebuild ``like``'s structure from ``leaves`` (the order of tree_leaves)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_fingerprint(tree: Tree) -> int:
    """An integer of the leaves' bits: each element's bit pattern times its
    position mod 65521 plus 1, summed per leaf, and the leaves' sums weighted
    by their place in ``tree_leaves``. Equal trees give equal numbers; a
    changed or moved element changes it (barring a collision)."""
    total = 0
    for i, t in enumerate(tree_leaves(tree)):
        t = t.detach().contiguous()
        bits = t.view(_INT_OF_WIDTH[t.element_size()]).reshape(-1).to(torch.int64)
        pos = torch.arange(bits.numel(), device=t.device, dtype=torch.int64) % 65521 + 1
        total += (i + 1) * int((bits * pos).sum())
    return total
