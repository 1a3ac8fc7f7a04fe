"""Nested dict/list/tuple parameter trees of tensors.

The reference keeps parameters and optimizer state as JAX pytrees; the port
keeps the same nesting (``{"layers": [{"w_self": .., "w_nbr": .., "b": ..}]}``)
as plain containers of tensors, walked by these two helpers.
"""
from __future__ import annotations

from typing import Any, Callable, List

Tree = Any


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
