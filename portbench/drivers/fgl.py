"""Driver of the FGL cells: the port's ``FGLTrainer.step``, round after round.

Set-up makes the inputs from the seed (``data.py``), builds the trainer with
``repro_torch.core.registry.build`` and its state with ``init``, puts the
benchmark's weights into it, and runs the first ``first_rounds`` rounds
through ``step``, each with its own noise S: they warm up every shape the
window uses (an imputation round and, where the schedule has them, a plain
round) and are the rounds the reference follows (at K = 5 a whole period
and the next imputation round, so that an imputation after plain rounds
is compared too). The gradients of the first local step and of the first
AE and assessor steps are read from the optimizers' states after those
steps. The window then calls
``step`` on that same state as a closed loop, each round starting when the
previous one has ended and timed to its ``torch.cuda.synchronize()``,
until ``seconds`` have passed; it counts whole rounds. With ``trace``, a
whole number of K-periods runs after the window under ``torch.profiler``
with the spans of the cell's per-layer readers. Then the port's state is
freed, the inputs are made again from the seed, and the reference
(``reference/fgl.py``) follows the first rounds (``judge.py``).

``fault`` plants one of the faults the cell's check has to catch (tests
and ``calibrate.py`` only): ``unchanged`` (a round returns its state
unchanged), ``half_batch`` (half of the training nodes left out of the
loss, the mean taken over the rest), ``no_exchange`` (the aggregation left
out) and ``altered_link`` (every link the similarity search returns moved
to the next candidate).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import counts, data, judge, peaks, trace as trace_lib
from portbench.reference import fgl as ref_lib

CHECKS = judge.NUMBERS
TRAFFIC_KEYS = ("imputation_interval", "participation", "loop", "first_rounds")
FAULTS = ("unchanged", "half_batch", "no_exchange", "altered_link")


def fgl_config(cfg: Dict, traffic: Dict, seed: int):
    """The port's ``FGLConfig`` for a configuration and traffic mix."""
    from repro_torch.core.types import FGLConfig
    fgl, model = cfg["fgl"], cfg["model"]
    return FGLConfig(hidden_dim=int(model["hidden_dim"]), num_layers=int(model["num_layers"]),
                     gnn_kind=model["gnn_kind"],
                     local_rounds=int(fgl["local_rounds"]),
                     imputation_interval=int(traffic["imputation_interval"]),
                     participation=float(traffic["participation"]),
                     ae_iters=int(fgl["ae_iters"]), assessor_iters=int(fgl["assessor_iters"]),
                     ae_outer_iters=int(fgl["ae_outer_iters"]),
                     top_k_links=int(fgl["top_k_links"]), ae_hidden=int(fgl["ae_hidden"]),
                     assessor_hidden=tuple(int(w) for w in fgl["assessor_hidden"]),
                     aug_max=int(cfg["aug_max"]),
                     lr_classifier=float(fgl["lr_classifier"]),
                     lr_generator=float(fgl["lr_generator"]),
                     trace_reg=float(fgl["trace_reg"]),
                     label_ratio=float(cfg["dataset"]["label_ratio"]),
                     seed=data.sub_seed(seed, 0))


def shapes(cfg: Dict, plan: data.HostPlan, num_servers: int) -> counts.Shapes:
    fgl, model, ds = cfg["fgl"], cfg["model"], cfg["dataset"]
    ec, _, _ = plan.local_edges()
    sizes = np.bincount(plan.assign, minlength=plan.num_clients).astype(np.int64)
    per = sizes.reshape(num_servers, -1)
    pairs = int((per * (per.sum(1, keepdims=True) - per)).sum())
    dims = ([int(ds["feature_dim"])] + [int(model["hidden_dim"])] * (int(model["num_layers"]) - 1)
            + [int(ds["num_classes"])])
    return counts.Shapes(rows=int(sizes.sum()), nnz=2 * len(ec), dims=dims,
                         local_rounds=int(fgl["local_rounds"]), ae_hidden=int(fgl["ae_hidden"]),
                         assessor_hidden=[int(w) for w in fgl["assessor_hidden"]],
                         ae_iters=int(fgl["ae_iters"]), assessor_iters=int(fgl["assessor_iters"]),
                         ae_outer_iters=int(fgl["ae_outer_iters"]), cross_pairs=pairs)


def referenced_rows(plan: data.HostPlan) -> int:
    """Nodes with a neighbour in their own client: the rows of H that the
    neighbour mean reads."""
    ec, eu, ev = plan.local_edges()
    keys = np.unique(np.concatenate([ec.astype(np.int64) * plan.n_pad + eu,
                                     ec.astype(np.int64) * plan.n_pad + ev]))
    return len(keys)


def server_adjacency(num_servers: int) -> np.ndarray:
    """Eq. 16's a_rj: a ring with self loops, or one server."""
    if num_servers == 1:
        return np.ones((1, 1), np.float32)
    a = np.eye(num_servers, dtype=np.float32)
    for j in range(num_servers):
        a[j, (j - 1) % num_servers] = a[j, (j + 1) % num_servers] = 1.0
    return a


def make_inputs(cfg: Dict, plan: data.HostPlan, seed: int, num_servers: int, device) -> Dict:
    return {"batch": data.client_tensors(cfg, plan, seed, device),
            "weights": data.initial_weights(cfg, seed, num_servers, device),
            "noise": lambda t: data.noise(cfg, plan, seed, num_servers, t, device),
            "num_servers": num_servers, "aug_max": plan.aug_max,
            "server_adjacency": torch.as_tensor(server_adjacency(num_servers),
                                                device=device)}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _program_snapshot(state, metrics, aug: int) -> Dict:
    b = state.batch
    return ref_lib.snapshot(metrics["loss"], metrics["acc"], metrics["f1"], state.params,
                            state.ae_params, state.as_params,
                            {"x": b.x, "adj": b.adj, "node_mask": b.node_mask}, aug)


class _FirstSteps:
    """One of the trainer's optimizers, noting the gradient of the first
    step it takes on each network as it holds it: the first moment after
    that step over ``1 - b1``. ``name(leaves)`` names a network from its
    leaves."""

    def __init__(self, opt, name):
        self.opt, self.name, self.grads = opt, name, {}

    def __getattr__(self, attr):
        return getattr(self.opt, attr)

    def update(self, grads, state, params):
        new_params, new_state = self.opt.update(grads, state, params)
        mu = ref_lib.leaves(new_state.mu)
        net = self.name(mu)
        if net not in self.grads:
            self.grads[net] = {f"{net}{k}": v.detach().float().cpu() / (1.0 - self.opt.b1)
                               for k, v in mu.items()}
        return new_params, new_state


@contextlib.contextmanager
def planted(fault: Optional[str]):
    """The port with ``fault`` planted for the block (see the module doc)."""
    if fault is None:
        yield
        return
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; have {FAULTS}")
    from repro_torch.core import fedgl
    from repro_torch.kernels import ops
    owner, attr = {"unchanged": (fedgl.FGLTrainer, "step"),
                   "half_batch": (fedgl, "_cross_entropy"),
                   "no_exchange": (fedgl.FGLTrainer, "aggregate"),
                   "altered_link": (ops, "sim_topk")}[fault]
    orig = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)

    def unchanged(self, state, noise=None, mask=None):
        new, m = orig(self, state, noise=noise, mask=mask)
        return dataclasses.replace(state, round=new.round), m

    def half_batch(logits, y, mask):
        keep = (torch.arange(y.shape[-1], device=y.device) % 2 == 0).to(mask.dtype)
        return orig(logits, y, mask * keep)

    def no_exchange(self, params, *, round=0, mask=None):
        return params

    def altered_link(h, client_ids, target_mask, k, **kw):
        vals, idx = orig(h, client_ids, target_mask, k, **kw)
        n = h.shape[-2]
        return vals, torch.where(idx >= 0, (idx + 1) % n, idx)

    setattr(owner, attr, locals()[fault])
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def first_rounds(cfg: Dict, traffic: Dict, plan: data.HostPlan, seed: int, device,
                 fault: Optional[str] = None):
    """Set-up: the trainer and its state after the first rounds, and the
    snapshots the reference follows."""
    from repro_torch.core import registry
    from repro_torch.core.types import ClientBatch
    n = int(cfg["num_servers"])
    inputs = make_inputs(cfg, plan, seed, n, device)
    batch = ClientBatch(**inputs["batch"], num_classes=int(cfg["dataset"]["num_classes"]),
                        aug_max=plan.aug_max)
    kw = {"num_servers": n} if cfg["method"] != "FedGL" else {}
    trainer = registry.build(cfg["method"], fgl_config(cfg, traffic, seed), batch,
                             device=device, **kw)
    w = inputs["weights"]
    state = dataclasses.replace(
        trainer.init(batch), params=w["params"], opt_state=trainer.opt.init(w["params"]),
        ae_params=w["ae"], ae_opt=trainer.gen_opt.init(w["ae"], lead=(n,)),
        as_params=w["assessor"], as_opt=trainer.gen_opt.init(w["assessor"], lead=(n,)))
    snaps = [ref_lib.initial_snapshot(w)]
    del batch, inputs, w
    k = int(traffic["imputation_interval"])
    trainer.opt = clf = _FirstSteps(trainer.opt, lambda leaves: "")
    trainer.gen_opt = gen = _FirstSteps(
        trainer.gen_opt, lambda leaves: "ae." if "enc.0.w" in leaves else "assessor.")
    with planted(fault):
        for t in range(int(traffic["first_rounds"])):
            s = data.noise(cfg, plan, seed, n, t, device) if t % k == 0 else None
            state, m = trainer.step(state, noise=s)
            _sync(device)
            snaps.append(_program_snapshot(state, m, plan.aug_max))
            if t == 0:
                trainer.opt, trainer.gen_opt = clf.opt, gen.opt
                snaps[1].update(grad0=clf.grads[""],
                                gen_grad0={**gen.grads["ae."], **gen.grads["assessor."]})
    return trainer, state, snaps


def reference_readings(cfg: Dict, traffic: Dict, plan: data.HostPlan, seed: int, device,
                       subject: List[Dict]) -> Dict[str, float]:
    """The reference, made from the seed, following ``subject``'s rounds."""
    inputs = make_inputs(cfg, plan, seed, int(cfg["num_servers"]), device)
    r = ref_lib.Reference(cfg, traffic, inputs)
    ref_snaps, readings = judge.follow(r, subject)
    return judge.compare(subject, ref_snaps, readings)


def control_snapshots(cfg: Dict, traffic: Dict, plan: data.HostPlan, seed: int,
                      device) -> List[Dict]:
    """The control: the reference in TF32 in the port's place."""
    inputs = make_inputs(cfg, plan, seed, int(cfg["num_servers"]), device)
    r = ref_lib.Reference(cfg, traffic, inputs, tf32=True)
    snaps = [ref_lib.initial_snapshot(inputs["weights"])]
    for _ in range(int(traffic["first_rounds"])):
        snaps.append(r.step())
    return snaps


def _profiled(trainer, state, cfg, plan, seed, device, readers, k: int, t_next: int):
    """A whole number of K-periods (at least 3 rounds) under the profiler."""
    targets: Dict[str, str] = {}
    for reader in readers.values():
        targets.update(getattr(reader, "SPANS", {}))
    n = int(cfg["num_servers"])
    rounds = k * -(-3 // k)
    calls: List[trace_lib.Span] = []
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    flags = []
    with trace_lib.wrapped(targets, calls), torch.profiler.profile(activities=acts) as prof:
        _sync(device)
        t0 = time.perf_counter()
        for t in range(t_next, t_next + rounds):
            s = data.noise(cfg, plan, seed, n, t, device) if t % k == 0 else None
            state, _ = trainer.step(state, noise=s)
            flags.append(t % k == 0)
        _sync(device)
        window = time.perf_counter() - t0
    return state, trace_lib.read(prof, calls, window), flags


def run(cell, *, seed: int, seconds: float, trace: bool, device: str, start: float,
        readers: Dict, fault: Optional[str] = None) -> Dict:
    cfg, traffic = cell.config, cell.traffic
    dev = torch.device(device)
    plan = data.host_plan(cfg, seed)
    trainer, state, snaps = first_rounds(cfg, traffic, plan, seed, device, fault)
    setup_s = time.perf_counter() - start

    k, n = int(traffic["imputation_interval"]), int(cfg["num_servers"])
    times, flags, losses = [], [], []
    with planted(fault):
        _sync(device)
        w0 = time.perf_counter()
        while True:
            t = state.round
            r0 = time.perf_counter()
            s = data.noise(cfg, plan, seed, n, t, device) if t % k == 0 else None
            state, m = trainer.step(state, noise=s)
            _sync(device)
            r1 = time.perf_counter()
            times.append(r1 - r0)
            flags.append(t % k == 0)
            losses.append(m["loss"])
            if r1 - w0 >= seconds:
                break
        window_s = r1 - w0
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        traced = None
        if trace:
            state, traced, trace_flags = _profiled(trainer, state, cfg, plan, seed, device,
                                                   readers, k, state.round)
    failed = int(sum(not bool(torch.isfinite(x)) for x in losses))
    del trainer, state, losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = reference_readings(cfg, traffic, plan, seed, device, snaps)

    sh = shapes(cfg, plan, n)
    ctx = {"setup_s": setup_s, "round_times": times, "impute_flags": flags,
           "window_s": window_s, "peak_bytes": peak, "checks": checks,
           "attempted": len(times), "failed": failed,
           "model_flops": sum(counts.round_flops(sh, f) for f in flags),
           "peak_flops": peaks.TF32_FLOPS,
           "shapes": sh, "referenced_rows": referenced_rows(plan), "config": cfg,
           "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                      "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if traced is not None:
        ctx.update(trace=traced, trace_flags=trace_flags)
        ctx["device"].update(busy_s=traced.busy_s, window_s=traced.window_s)
        ctx["breakdown"] = {"device_ops": [[a, b] for a, b in traced.device_ops],
                            "idle_gaps": [[a, b] for a, b in traced.idle_gaps]}
    return ctx

