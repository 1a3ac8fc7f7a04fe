"""Training step: next-token loss, gradients, optimizer update.

Counterpart of ``repro.train.step``. ``make_train_step(cfg, optimizer)``
returns ``step(state, batch) -> (state, metrics)``; ``batch`` is
``{"tokens": [B, S]}``, plus ``"memory"`` [B, T, d] for a vlm config's
image embeddings or an encoder-decoder config's audio frames (a tensor on
the model's device, or numpy). The loss is the next-token
cross-entropy plus ``aux_weight`` times the MoE aux loss (0 for dense
models).

Unlike the reference's pure function, the step updates the model's
parameters and the optimizer's moments in place, leaf by leaf
(``optim.adam``'s ``update_``): at full Qwen3-4B size a functional update
would hold a second copy of 29 GB of f32 moments. The returned state holds
the same model and moment tensors with its step counters advanced.

Attention runs through ``kernels.ops.mha`` in both passes (the CUDA forward
and backward kernels on the card), and with ``cfg.remat`` each layer group
is recomputed in the backward pass (``models.transformer.forward``).

``aggregation="spread"`` is the paper's Eq. 16 as gossip between pods:
each pod is a rank of a mesh (``launch.mesh.make_host_mesh``) holding the
whole model and its share of the batch; its gradients are not averaged with
the other pods', and after the optimizer update its parameters are averaged
with its two ring neighbors' every ``gossip_every`` steps
(``core.gossip.maybe_gossip``), as the reference's step does inside
``shard_map`` over its ``pod`` axis.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import gossip
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer

Batch = Dict[str, Any]


class TrainState(NamedTuple):
    params: Transformer   # the model; its parameters are the optimizer's leaves
    opt_state: Any        # AdamState (moments keyed by parameter name) or SGD's buffers
    step: torch.Tensor    # int32 scalar


def leaves(model: Transformer) -> Dict[str, torch.Tensor]:
    """The model's parameters by name: the tree the optimizer walks."""
    return dict(model.named_parameters())


def _tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def lm_loss(model: Transformer, cfg: ModelConfig, batch: Batch, aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy (+ MoE aux): (total, {"loss", "aux"})."""
    dev = model.embed.tokens.device
    tokens = _tensor(batch["tokens"]).to(device=dev, dtype=torch.long)
    memory = batch.get("memory")
    if memory is not None:
        memory = _tensor(memory).to(dev)
    logits, aux = transformer.forward(model, tokens, memory=memory)
    targets = tokens[:, 1:]
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    del logits
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    loss = torch.mean(nll)
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux": aux}


def init_state(cfg: ModelConfig, optimizer, *, seed: int = 0, device="cuda",
               model: Optional[Transformer] = None) -> TrainState:
    """Random weights from ``seed`` drawn on ``device`` (or ``model``'s
    weights), the optimizer's zero state, step 0."""
    if model is None:
        model = transformer.init_model(cfg, seed=seed, device=device)
    for p in model.parameters():
        p.requires_grad_(True)
    dev = model.embed.tokens.device
    return TrainState(params=model, opt_state=optimizer.init(leaves(model)),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def loss_and_grads(model: Transformer, cfg: ModelConfig, batch: Batch, microbatch: int = 1
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(total, metrics, grads by parameter name). With ``microbatch`` > 1 the
    batch is split on dim 0 and f32 gradients, total, loss and aux are
    summed over the chunks and divided by their number, as the reference's
    scan does; otherwise the gradients have the parameters' dtype."""
    params = leaves(model)
    names, tensors = list(params), list(params.values())

    def grads_of(chunk):
        with torch.enable_grad():
            total, metrics = lm_loss(model, cfg, chunk)
            grads = torch.autograd.grad(total, tensors)
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    if microbatch <= 1:
        total, metrics, grads = grads_of(batch)
        return total, metrics, dict(zip(names, grads))
    n = microbatch
    chunks = {k: _tensor(v) for k, v in batch.items()}
    if chunks["tokens"].shape[0] % n:
        raise ValueError(f"batch {chunks['tokens'].shape[0]} does not split into {n} "
                         f"microbatches")
    gacc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in tensors]
    tacc, lacc, aacc = 0.0, 0.0, 0.0
    for i in range(n):
        micro = {k: torch.chunk(v, n, dim=0)[i] for k, v in chunks.items()}
        total, metrics, grads = grads_of(micro)
        for a, g in zip(gacc, grads):
            a += g.float()
        del grads
        tacc, lacc, aacc = tacc + total, lacc + metrics["loss"], aacc + metrics["aux"]
    inv = 1.0 / n
    return (tacc * inv, {"loss": lacc * inv, "aux": aacc * inv},
            {name: a * inv for name, a in zip(names, gacc)})


def make_train_step(cfg: ModelConfig, optimizer, *, aggregation: str = "allreduce",
                    gossip_every: int = 1, pod_axis=None, microbatch: int = 1
                    ) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """aggregation: "allreduce" (the plain step on one card) or "spread"
    (the paper's gossip): with ``pod_axis``, the pod mesh (a
    ``launch.mesh.Mesh``, the counterpart of the reference's axis name),
    each step's update is followed by ``maybe_gossip`` of the parameters
    over it every ``gossip_every`` steps, leaf by leaf in place; without
    it, as in the reference, the plain step. ``microbatch`` > 1 accumulates
    gradients over that many chunks of the batch (peak activation memory /
    microbatch)."""
    if aggregation not in ("allreduce", "spread"):
        raise ValueError(f"unknown aggregation {aggregation!r}")
    pods = pod_axis if aggregation == "spread" else None

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        total, metrics, grads = loss_and_grads(state.params, cfg, batch, microbatch)
        named = leaves(state.params)
        opt_state = optimizer.update_(grads, state.opt_state, named)
        del grads
        if pods is not None:
            with torch.no_grad():
                for p in named.values():
                    new = gossip.maybe_gossip(p, state.step, pods, every=gossip_every)
                    if new is not p:
                        p.copy_(new)
        return (TrainState(params=state.params, opt_state=opt_state, step=state.step + 1),
                dict(metrics, total=total))

    return step
