"""Parameter and state trees to and from ``.npz`` (counterpart of
``repro.checkpoint.io``).

A tree of dicts, lists, tuples, named tuples and dataclasses is flattened
to ``/``-joined leaf names, the reference's own: dict keys, list indices,
and field names (so ``FGLState.params["layers"][0]["w_self"]`` is
``params/layers/0/w_self`` in both packages, and a bare leaf is ``_root``).
Dataclass fields marked ``metadata=dict(static=True)`` (``ClientBatch``'s
``num_classes`` and ``aug_max``) are not leaves, as in the reference.

Leaves are tensors (restored on the template's device, in its dtype; bf16
is stored as 2-byte void, as numpy writes it without a bf16 type), numpy
arrays, Python scalars (restored as Python scalars, so ``FGLState.round``
comes back an int) and ``torch.Generator``s, stored as their state bytes,
so the port's own save and resume continues a run bit for bit. An
``FGLState`` also writes the reference's PRNG ``key`` leaf
(``FGLState.reference_leaves``), so the JAX package resumes the file.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

PyTree = Any
_BF16 = np.dtype("V2")


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """``(name, child)`` pairs of a container; None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name)) for f in dataclasses.fields(node)
                if not f.metadata.get("static")]
    return None


def _leaves(tree: PyTree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        yield prefix or "_root", tree
        return
    for name, child in kids:
        yield from _leaves(child, f"{prefix}/{name}" if prefix else name)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16)
        return t.numpy()
    return np.asarray(leaf)


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save(path, tree: PyTree) -> None:
    """Write every leaf of ``tree`` to the ``.npz`` at ``path``, and the
    leaves its ``reference_leaves()`` gives, where it has that method (an
    ``FGLState``'s PRNG ``key`` for the JAX package)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves = {name: _to_numpy(leaf) for name, leaf in _leaves(tree)}
    extra = getattr(tree, "reference_leaves", None)
    if extra is not None:
        leaves.update(extra())
    np.savez(path, **leaves)


def _restore_leaf(name: str, arr: np.ndarray, leaf):
    if isinstance(leaf, torch.Generator):
        expect = tuple(leaf.get_state().shape)
    elif isinstance(leaf, torch.Tensor):
        expect = tuple(leaf.shape)
    else:
        expect = tuple(np.shape(leaf))
    if tuple(arr.shape) != expect:
        raise ValueError(f"shape mismatch for {name}: {arr.shape} vs {expect}")
    if isinstance(leaf, torch.Generator):
        gen = torch.Generator(device=leaf.device)
        gen.set_state(torch.from_numpy(np.array(arr, dtype=np.uint8)))
        return gen
    if isinstance(leaf, torch.Tensor):
        return _to_tensor(arr).to(device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, (bool, int, float)):
        return type(leaf)(arr)      # a Python scalar stays a Python scalar
    return arr.astype(np.asarray(leaf).dtype)


def _rebuild(node, values: Dict[str, Any], prefix: str = ""):
    kids = _children(node)
    if kids is None:
        return values[prefix or "_root"]
    out = {name: _rebuild(child, values, f"{prefix}/{name}" if prefix else name)
           for name, child in kids}
    if isinstance(node, dict):
        return {k: out[str(k)] for k in node}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(**out)
    if isinstance(node, (list, tuple)):
        return type(node)(out[str(i)] for i in range(len(node)))
    return dataclasses.replace(node, **out)


def restore(path, template: PyTree) -> PyTree:
    """Load the ``.npz`` at ``path`` into the structure of ``template``.

    Every leaf of the template must be in the file (``KeyError`` naming the
    leaf otherwise) with the template's shape (``ValueError``); leaves the
    template lacks are ignored.
    """
    with np.load(pathlib.Path(path), allow_pickle=False) as data:
        values = {}
        for name, leaf in _leaves(template):
            if name not in data.files:
                raise KeyError(f"checkpoint missing leaf {name!r}")
            values[name] = _restore_leaf(name, data[name], leaf)
    return _rebuild(template, values)


def load(path) -> PyTree:
    """The ``.npz`` at ``path`` as a tree rebuilt from its leaf names alone:
    nested dicts, with a node whose keys are ``0..n-1`` as a list, and
    tensors on the CPU (for a file the reference wrote, with no template at
    hand)."""
    root: Dict[str, Any] = {}
    with np.load(pathlib.Path(path), allow_pickle=False) as data:
        for name in data.files:
            if name == "_root":
                return _to_tensor(data[name])
            *parents, last = name.split("/")
            node = root
            for part in parents:
                node = node.setdefault(part, {})
            node[last] = _to_tensor(data[name])

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and set(node) == {str(i) for i in range(len(node))}:
            return [node[str(i)] for i in range(len(node))]
        return node
    return listify(root)
