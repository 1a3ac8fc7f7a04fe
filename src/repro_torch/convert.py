"""Carry weights and state across from the JAX package.

``state_from_reference`` turns a reference ``FGLState`` whose arrays were
fetched to the host (numpy; the PRNG key is not needed) into this package's
``FGLState`` on ``device``: classifier parameters and their Adam state, the
stacked per-server autoencoders and assessors with theirs, the client batch
and the round. Only attributes are read, so this module imports nothing of
the reference. The tests use it so that both packages start from the same
weights; the port's own random stream starts from ``seed``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.fedgl import FGLState
from repro_torch.core.types import ClientBatch
from repro_torch.optim.adam import AdamState
from repro_torch.tree import tree_map


def tree_to_torch(tree: Any, device) -> Any:
    """Nested dicts/lists of arrays -> the same nesting of tensors."""
    return tree_map(lambda a: torch.as_tensor(np.array(a)).to(device), tree)


def adam_to_torch(opt: Any, device) -> AdamState:
    """Anything with ``step``, ``mu``, ``nu`` (the reference's AdamState)."""
    return AdamState(step=torch.as_tensor(np.array(opt.step, np.int32)).to(device),
                     mu=tree_to_torch(opt.mu, device), nu=tree_to_torch(opt.nu, device))


def batch_to_torch(batch: Any, device) -> ClientBatch:
    fields = ("x", "adj", "y", "node_mask", "train_mask", "test_mask", "global_id")
    return ClientBatch(**{f: np.array(getattr(batch, f)) for f in fields},
                       num_classes=int(batch.num_classes),
                       aug_max=int(batch.aug_max)).to(device)


def state_from_reference(ref_state: Any, *, device="cpu", seed: int = 0) -> FGLState:
    """The reference's host-fetched ``FGLState`` as this package's state."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return FGLState(params=tree_to_torch(ref_state.params, dev),
                    opt_state=adam_to_torch(ref_state.opt_state, dev),
                    ae_params=tree_to_torch(ref_state.ae_params, dev),
                    ae_opt=adam_to_torch(ref_state.ae_opt, dev),
                    as_params=tree_to_torch(ref_state.as_params, dev),
                    as_opt=adam_to_torch(ref_state.as_opt, dev),
                    batch=batch_to_torch(ref_state.batch, dev),
                    gen=gen, round=int(ref_state.round))
