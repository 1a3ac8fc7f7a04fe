"""Carry weights and state across from the JAX package.

``state_from_reference`` turns a reference ``FGLState`` whose arrays were
fetched to the host (numpy; the PRNG key is not needed) into this package's
``FGLState`` on ``device``: classifier parameters and their Adam state, the
stacked per-server autoencoders and assessors with theirs, the client batch
and the round. Only attributes are read, so this module imports nothing of
the reference. The tests use it so that both packages start from the same
weights; the port's own random stream starts from ``seed``.

``lm_params_from_jax`` does the same for a language model: the reference's
``transformer.init_model`` pytree, fetched to numpy, becomes this package's
``Transformer``; ``lm_params_to_jax`` is its inverse, the tree that
``checkpoint.io.save`` writes in the reference's layout.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.fedgl import FGLState, resolve_device
from repro_torch.core.types import ClientBatch
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer, group_size
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


def state_from_reference(ref_state: Any, *, device="cuda", seed: int = 0) -> FGLState:
    """The reference's host-fetched ``FGLState`` as this package's state.
    Without a GPU this raises unless ``device="cpu"``."""
    dev = resolve_device(device)
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


def _host(a: Any) -> torch.Tensor:
    if isinstance(a, torch.Tensor):     # a leaf of checkpoint.io.load
        return a.cpu()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":    # numpy's bf16 extension type: widen exactly
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a))


def lm_params_from_jax(params: Any, cfg: ModelConfig, device="cuda") -> Transformer:
    """The reference's LM pytree (as numpy) as this package's ``Transformer``
    on ``device`` (without a GPU this raises unless ``device="cpu"``).

    ``params["blocks"]`` is a tuple of ``group_size(cfg)`` group members whose
    leaves carry a leading ``[n_groups]`` axis; layer ``i`` is member
    ``i % g`` at index ``i // g``. For the ssm family it is a list with one
    unstacked tree per layer. A vlm's ``params["cross_blocks"]`` leaves carry
    the groups' leading axis: group ``i`` is ``cross_blocks.<i>``; an
    encoder-decoder's ``params["encoder"]["blocks"]`` leaves carry a leading
    ``[encoder_layers]`` axis. Every other key maps by name onto the
    module's parameters (``embed.tokens``, ``embed.positions``,
    ``encoder.positions``, ``final_norm.scale``, ``blocks.<i>.moe.router``,
    ...), and the load is strict: a missing or unexpected leaf raises.
    """
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev)
    g = group_size(cfg)
    state = {}

    def put(prefix: str, tree: Any, index=None) -> None:
        for key, val in tree.items():
            if isinstance(val, dict):
                put(f"{prefix}{key}.", val, index)
            else:
                state[prefix + key] = _host(val if index is None else val[index])

    put("embed.", params["embed"])
    put("final_norm.", params["final_norm"])
    for i in range(cfg.num_layers):
        if cfg.arch_type == "ssm":
            put(f"blocks.{i}.", params["blocks"][i])
        else:
            put(f"blocks.{i}.", params["blocks"][i % g], i // g)
    if "cross_blocks" in params:
        for i in range(cfg.num_layers // g):
            put(f"cross_blocks.{i}.", params["cross_blocks"], i)
    if "encoder" in params:
        enc = params["encoder"]
        state["encoder.positions"] = _host(enc["positions"])
        put("encoder.final_norm.", enc["final_norm"])
        for i in range(cfg.encoder_layers):
            put(f"encoder.blocks.{i}.", enc["blocks"], i)
    model.load_state_dict(state, strict=True)
    return model


def _nest(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """``{"attn.wq": t}`` as ``{"attn": {"wq": t}}``."""
    out: Dict[str, Any] = {}
    for name, t in flat.items():
        *parents, last = name.split(".")
        node = out
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = t
    return out


def lm_params_to_jax(model: Transformer) -> Dict[str, Any]:
    """``model``'s parameters as the reference's LM pytree, CPU tensors in
    the parameters' dtype: ``embed`` and ``final_norm`` by name, and
    ``blocks`` a list of ``group_size(cfg)`` group members whose leaves stack
    the member's layers along a leading ``[n_groups]`` axis (layer ``i`` is
    member ``i % g`` at index ``i // g``), or for the ssm family one
    unstacked tree per layer; for a vlm ``cross_blocks`` whose leaves stack
    the groups' cross blocks; for an encoder-decoder ``encoder`` with its
    ``positions``, ``final_norm`` and ``blocks`` stacked along
    ``[encoder_layers]``. The inverse of ``lm_params_from_jax``."""
    cfg = model.cfg
    g = group_size(cfg)
    host = lambda mod: {n: t.detach().cpu() for n, t in mod.state_dict().items()}  # noqa: E731
    stack = lambda mods: _nest({name: torch.stack([m[name] for m in mods])  # noqa: E731
                                for name in mods[0]})
    layers = [host(bp) for bp in model.blocks]
    out = {"embed": _nest(host(model.embed)), "final_norm": _nest(host(model.final_norm)),
           "blocks": ([_nest(layer) for layer in layers] if cfg.arch_type == "ssm" else
                      [stack(layers[m::g]) for m in range(g)])}
    if cfg.cross_attn_interval:
        out["cross_blocks"] = stack([host(cp) for cp in model.cross_blocks])
    if cfg.is_encdec:
        enc = model.encoder
        out["encoder"] = {"positions": enc.positions.detach().cpu(),
                          "blocks": stack([host(bp) for bp in enc.blocks]),
                          "final_norm": _nest(host(enc.final_norm))}
    return out
