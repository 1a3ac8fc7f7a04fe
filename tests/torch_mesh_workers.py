"""Rank bodies of the port's mesh tests (tests/test_torch_{ring_topk,mesh}.py).

``repro_torch.launch.mesh.spawn`` starts each function here on every rank of
a ``gloo`` group on the CPU and hands back what each rank returns. The
module imports no JAX, so a rank starts in the time torch takes to import;
inputs come from the parent as numpy arrays or the port's own types, and
results go back as numpy.
"""
import dataclasses
import time

import torch

from repro_torch import convert
from repro_torch import configs as pconfigs
from repro_torch.core import gossip, imputation, registry
from repro_torch.core.types import FGLConfig
from repro_torch.launch import fgl_train
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import adam as padam
from repro_torch.train import step as pstep
from repro_torch.tree import tree_map


def _np(tree):
    return tree_map(lambda t: t.detach().numpy(), tree)


def ring_cases(cases):
    """``imputation.similarity_topk`` over a sim mesh of the world, for each
    case ``(h, cid, mask, k)``; returns the mesh size and each result."""
    torch.set_num_threads(1)
    mesh = mesh_lib.make_sim_mesh()
    out = []
    for h, cid, mask, k in cases:
        n = h.shape[-2]
        s, i = imputation.similarity_topk(torch.from_numpy(h), torch.ones(h.shape[:-1]),
                                          torch.from_numpy(cid), k,
                                          target_mask=torch.from_numpy(mask), mesh=mesh)
        assert s.shape[-2] == n
        out.append((s.numpy(), i.numpy()))
    return {"size": mesh.size, "rank": mesh.rank, "results": out}


def gossip_cases(per_rank, stacked, adj):
    """Every gossip collective on the world: ``per_rank`` [size, ...] arrays,
    rank r holding row r (the LM form), and ``stacked`` [N, ...] arrays,
    rank r holding its block of N / size servers (the edge-mesh form)."""
    torch.set_num_threads(1)
    pods = mesh_lib.make_host_mesh()
    edge = mesh_lib.make_edge_mesh(next(iter(stacked.values())).shape[0])
    me = pods.rank
    p = {k: torch.from_numpy(v[me]) for k, v in per_rank.items()}
    nb = next(iter(stacked.values())).shape[0] // edge.size
    blk = {k: torch.from_numpy(v[edge.rank * nb:(edge.rank + 1) * nb])
           for k, v in stacked.items()}
    return {"size": pods.size, "edge_size": edge.size, "rank": me,
            "ring": _np(gossip.ring_gossip(p, pods)),
            "all_average": _np(gossip.all_average(p, pods)),
            "maybe_skip": _np(gossip.maybe_gossip(p, 0, pods, every=2)),
            "maybe_do": _np(gossip.maybe_gossip(p, 1, pods, every=2)),
            "block_ring": _np(gossip.block_ring_gossip(blk, edge)),
            "adjacency": _np(gossip.adjacency_gossip(blk, torch.from_numpy(adj), edge))}


def _meshes(flags, num_servers):
    kw = {}
    if "edge" in flags:
        kw["edge_mesh"] = mesh_lib.make_edge_mesh(num_servers)
    if "sim" in flags:
        kw["sim_mesh"] = kw["edge_mesh"] if "edge" in flags else mesh_lib.make_sim_mesh()
    return kw


def fgl_runs(batch, cfg, runs, rounds, clis):
    """Each run ``(name, method, builder keywords, mesh flags, state,
    noises)`` from ``state`` (a port ``FGLState`` without its generator) for
    ``rounds`` rounds, handed the reference's noise of each imputation
    round; the link proposals of each run's first ``server_outputs``; and
    ``fgl_train.main(cli)``'s history for each of ``clis``."""
    torch.set_num_threads(1)
    out = {}
    for name, method, kw, flags, state, noises in runs:
        kw = dict(kw, **_meshes(flags, kw.get("num_servers", 1)))
        tr = registry.build(method, cfg, batch, device="cpu", **kw)
        start = dataclasses.replace(state, gen=torch.Generator().manual_seed(0))
        outs = tr.imputation.server_outputs(tr, start, noise=noises[int(state.round)])
        _, hist = tr.fit(state=start, rounds=rounds, noise=noises.get)
        out[name] = {"hist": hist, "scores": outs[4].numpy(), "idx": outs[5].numpy(),
                     "x_bar": outs[6].numpy(), "ae": _np(outs[0])}
    out["cli"] = [fgl_train.main(cli) for cli in clis]
    return out


def world_cases(gossip_args=None, fgl_args=None, spread_args=None):
    """Several groups of cases in one start of the ranks."""
    return {"gossip": gossip_cases(*gossip_args) if gossip_args else None,
            "fgl": fgl_runs(*fgl_args) if fgl_args else None,
            "spread": spread_steps(*spread_args) if spread_args else None}


def spread_steps(params, arch, batches, every):
    """LM training with ``aggregation="spread"`` over the world's pods from
    the reference's ``params`` (numpy, its layout): each pod takes its rows
    of every batch; returns the losses and the final parameters in the
    reference's layout."""
    torch.set_num_threads(1)
    pods = mesh_lib.make_host_mesh()
    cfg = pconfigs.get_config(arch, "smoke")
    model = convert.lm_params_from_jax(params, cfg, "cpu")
    opt = padam.Adam(lr=3e-4, clip_norm=1.0, schedule=padam.cosine_schedule(1, len(batches)))
    step = pstep.make_train_step(cfg, opt, aggregation="spread", gossip_every=every,
                                 pod_axis=pods)
    state = pstep.init_state(cfg, opt, model=model)
    losses = []
    for batch in batches:
        rows = batch["tokens"].shape[0] // pods.size
        mine = {k: v[pods.rank * rows:(pods.rank + 1) * rows] for k, v in batch.items()}
        state, metrics = step(state, mine)
        losses.append(float(metrics["loss"]))
    return {"losses": losses,
            "params": _np(convert.lm_params_to_jax(state.params))}


def portable_config(cfg):
    """The reference's ``FGLConfig`` as the port's (a picklable copy)."""
    return FGLConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(FGLConfig)})


def sleep_for(seconds: float) -> None:
    """A rank that outlives a short ``mesh.spawn`` timeout."""
    time.sleep(seconds)
