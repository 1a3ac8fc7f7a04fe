#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU and hold its kernels to account.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. Device: the card's name and power limit (``nvidia-smi``), then the build
   of every kernel in ``src/repro_torch/kernels/csrc`` with ``nvcc``.
2. Kernels against their plain PyTorch versions on the card, at the shapes
   the main path gives them plus a ragged shape: each kernel's time, the
   plain version's time, one library call's time (used nowhere in the port)
   and its bound on the card.
3. A small training run on the card against the same run on the CPU (the
   kernels' plain versions), from the same weights and noise.
4. The main path through ``repro_torch.launch.fgl_train.main``: SpreadFGL on
   full-size Coauthor-CS (6 clients, 3 servers, 3 rounds, 2 imputation
   rounds), then FedGL on full-size Cora, with the kernels' launch counters
   set to 0 before and read after.
5. One JSON line describing every kernel, the card line, and the result line
   ``{"ok": true, "device": {...}}`` last.

Without a CUDA device, or without the repository around it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, and HBM3.
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

SPREAD_ARGS = ["--dataset", "coauthor_cs", "--scale", "1.0", "--method", "SpreadFGL",
               "--clients", "6", "--servers", "3", "--rounds", "3", "-K", "2"]
FEDGL_ARGS = ["--dataset", "cora", "--scale", "1.0", "--method", "FedGL", "--rounds", "2"]


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# -- phase 2: kernels against their plain versions ---------------------------

def _check_sage(dev, gen):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sage_aggregate as ksage

    def inputs(m, n, d):
        a = (torch.rand((m, n, n), generator=gen, device=dev) < 2e-3).float()
        a = a / torch.clamp_min(a.sum(-1, keepdim=True), 1.0)   # the main path's a_norm
        return a, torch.randn((m, n, d), generator=gen, device=dev)

    # Ragged, then FedGL's Cora layers 1 and 2 (n_pad = 914, 1433 features,
    # hidden 32) and SpreadFGL's Coauthor-CS layer 2 (n_pad = 6123), with
    # grad_h through the autograd Function where h needs a gradient on the
    # main path (layer 2). Layer 1 of Coauthor-CS, the dominant shape, is last.
    errs = []
    for m, n, d, with_grad in ((3, 1001, 77, True), (6, 914, 1433, False),
                               (6, 914, 32, True), (6, 6123, 32, True)):
        adj, h = inputs(m, n, d)
        err = (ops.sage_aggregate(adj, h) - ref.sage_aggregate(adj, h)).abs().max().item()
        print(f"[smoke] sage_aggregate [{m},{n},{n}]x[{m},{n},{d}] max_abs_err={err:.3g}")
        if not err <= 1e-4:     # f32 sums of up to n terms in another order
            raise AssertionError(f"sage_aggregate disagrees with its plain version: {err}")
        errs.append(err)
        if with_grad:
            g = torch.randn_like(h)
            grads = []
            for fn in (ops.sage_aggregate, ref.sage_aggregate):
                x = h.clone().requires_grad_(True)
                torch.sum(fn(adj, x) * g).backward()
                grads.append(x.grad)
            gerr = (grads[0] - grads[1]).abs().max().item()
            print(f"[smoke] sage_aggregate grad_h [{m},{n},{d}] max_abs_err={gerr:.3g}")
            if not gerr <= 1e-4:
                raise AssertionError(f"sage_aggregate grad_h disagrees: {gerr}")
            errs.append(gerr)
            del g, grads
        del adj, h

    m, n, d = 6, 6123, 6805
    adj, h = inputs(m, n, d)
    out = ops.sage_aggregate(adj, h)
    plain = ref.sage_aggregate(adj, h)
    err = (out - plain).abs().max().item()
    errs.append(err)
    del out, plain
    print(f"[smoke] sage_aggregate [{m},{n},{n}]x[{m},{n},{d}] max_abs_err={err:.3g}")
    if not err <= 1e-4:     # f32 sums of 6123 terms in another order
        raise AssertionError(f"sage_aggregate disagrees with its plain version: {err}")
    ms = _time_ms(lambda: ksage.launch(adj, h), 3)
    plain_ms = _time_ms(lambda: ref.sage_aggregate(adj, h), 3)
    lib_ms = _time_ms(lambda: torch.bmm(adj, h) / torch.clamp_min(adj.sum(-1, keepdim=True), 1.0), 3)
    bound_ms, bound_by = _bound(2.0 * m * n * n * d + m * n * n, 4.0 * (m * n * n + 2 * m * n * d))
    print(f"[smoke] sage_aggregate layer-1 ms={ms:.3f} plain_ms={plain_ms:.3f} "
          f"library_ms={lib_ms:.3f} bound_ms={bound_ms:.3f} ({bound_by}) "
          f"-> {2.0 * m * n * n * d / ms / 1e9:.1f} TFLOP/s")
    del adj, h
    torch.cuda.empty_cache()
    return {"name": "sage_aggregate", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sage_aggregate.cu",
            "replaces": "src/repro/kernels/sage_aggregate.py:52",
            "max_abs_err": max(errs), "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "shape": f"[{m},{n},{n}]x[{m},{n},{d}]"}


def _topk_err(h, vals, idx, rvals, ridx):
    """Max score error, and the largest score gap between two candidates the
    kernel and the plain version chose differently (must be a near tie)."""
    if not torch.equal(idx < 0, ridx < 0):
        raise AssertionError("sim_topk: unfilled slots differ from the plain version")
    finite = torch.isfinite(rvals)
    err = (vals[finite] - rvals[finite]).abs().max().item() if finite.any() else 0.0
    diff = (idx != ridx).nonzero()
    gap = 0.0
    if len(diff):
        b, r, _ = diff.unbind(1)
        hq = h[b, r].double()
        s_k = (hq * h[b, idx[tuple(diff.T)].long()].double()).sum(-1)
        s_r = (hq * h[b, ridx[tuple(diff.T)].long()].double()).sum(-1)
        gap = (s_k - s_r).abs().max().item()
    return err, gap, len(diff)


def _check_sim(dev, gen):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sim_topk as ksim

    def inputs(nb, n, n_pad, c, n_local):
        h = torch.softmax(3 * torch.randn((nb, n, c), generator=gen, device=dev), -1)
        slot = torch.arange(n, device=dev)
        cid = (slot // n_pad).to(torch.int32)            # client of each flat slot
        node = (torch.rand((nb, n), generator=gen, device=dev) < 0.95).float()
        return h, cid, node * ((slot % n_pad) < n_local).float()

    k = 4
    # Ragged with shifted indices, then the main path's shapes (12 aug slots
    # per client): FedGL on Cora, one server of 6 clients, n_pad = 914, c = 7;
    # SpreadFGL on Coauthor-CS, N = 3 servers of 2 clients, n_pad = 6123,
    # c = 15, which is timed.
    errs = []
    for (nb, n, n_pad, c, n_local), off in (((2, 1237, 400, 7, 390), 100),
                                           ((1, 5484, 914, 7, 902), 0),
                                           ((3, 12246, 6123, 15, 6111), 0)):
        h, cid, tmask = inputs(nb, n, n_pad, c, n_local)
        vals, idx = ops.sim_topk(h, cid, tmask, k, col_offset=off)
        rvals, ridx = ref.sim_topk(h, cid, tmask, k, col_offset=off)
        unshift = lambda i: torch.where(i >= 0, i - off, i)  # noqa: E731
        err, gap, nd = _topk_err(h, vals, unshift(idx), rvals, unshift(ridx))
        print(f"[smoke] sim_topk [{nb},{n},{c}] k={k} col_offset={off} max_abs_err={err:.3g} "
              f"idx_differ={nd} max_tie_gap={gap:.3g}")
        if not (err <= 1e-5 and gap <= 1e-5):
            raise AssertionError(f"sim_topk disagrees with its plain version: "
                                 f"err={err} tie_gap={gap}")
        errs.append(err)
    ms = _time_ms(lambda: ksim.launch(h, cid, tmask, k), 10)
    plain_ms = _time_ms(lambda: ref.sim_topk(h, cid, tmask, k), 3)

    def library():
        gram = torch.bmm(h, h.transpose(1, 2))
        keep = (cid[:, None] != cid[None, :]) & (tmask[:, None, :] > 0)
        return torch.topk(gram.masked_fill_(~keep, -math.inf), k, dim=-1)
    lib_ms = _time_ms(library, 3)
    bound_ms, bound_by = _bound(2.0 * nb * n * n * c, 4.0 * nb * n * (c + 2) + 8.0 * nb * n * k)
    print(f"[smoke] sim_topk main-path ms={ms:.3f} plain_ms={plain_ms:.3f} "
          f"library_ms={lib_ms:.3f} bound_ms={bound_ms:.4f} ({bound_by})")
    del h
    torch.cuda.empty_cache()
    return {"name": "sim_topk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sim_topk.cu",
            "replaces": "src/repro/kernels/sim_topk.py:136",
            "max_abs_err": max(errs), "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "shape": f"[{nb},{n},{c}] k={k}"}


# -- phase 3: the card's training run against the CPU's ----------------------

def _check_small_run(dev):
    from repro_torch.core import imputation
    from repro_torch.core.partition import partition_graph
    from repro_torch.core.spreadfgl import make_spreadfgl
    from repro_torch.core.types import FGLConfig
    from repro_torch.data.synthetic_graphs import DATASETS, make_sbm_graph
    from repro_torch.tree import tree_map

    graph = make_sbm_graph(DATASETS["cora"], scale=0.1, seed=1, feature_noise=3.0,
                           signal_ratio=0.5)
    batch, _ = partition_graph(graph, 4, aug_max=8, seed=0)
    cfg = FGLConfig(hidden_dim=16, local_rounds=2, imputation_interval=1, top_k_links=3,
                    aug_max=8)
    hists = {}
    for where in ("cpu", dev.type):
        tr = make_spreadfgl(cfg, batch, num_servers=2, device=where)
        cpu_tr = make_spreadfgl(cfg, batch, num_servers=2, device="cpu")
        state = cpu_tr.init(batch)                 # same weights on both devices
        state.params, state.ae_params, state.as_params = (
            tree_map(lambda t: t.to(where), p)
            for p in (state.params, state.ae_params, state.as_params))
        state.opt_state, state.ae_opt, state.as_opt = (
            type(o)(o.step.to(where), tree_map(lambda t: t.to(where), o.mu),
                    tree_map(lambda t: t.to(where), o.nu))
            for o in (state.opt_state, state.ae_opt, state.as_opt))
        state.batch = state.batch.to(where)
        noise_gen = torch.Generator().manual_seed(1)
        noises = [imputation.sample_noise(noise_gen, 2 * batch.n_pad, batch.num_classes,
                                          lead=(2,)) for _ in range(3)]
        _, hists[where] = tr.fit(state=state, rounds=3, noise=lambda r: noises[r].to(where))
    for key in ("loss", "acc", "f1"):
        diff = max(abs(a - b) for a, b in zip(hists[dev.type][key], hists["cpu"][key]))
        print(f"[smoke] small SpreadFGL run {dev.type} vs cpu: max |d{key}| = {diff:.3g}")
        if not diff <= 1e-4:    # three fitted rounds of f32 in other orders
            raise AssertionError(f"the card's run disagrees with the CPU's on {key}: "
                                 f"{hists[dev.type][key]} vs {hists['cpu'][key]}")


# -- phase 4: the main path ---------------------------------------------------

def _main_path(args):
    from repro_torch.core.types import FGLConfig
    from repro_torch.kernels import sage_aggregate as ksage
    from repro_torch.kernels import sim_topk as ksim
    from repro_torch.launch import fgl_train

    # The counts the launcher's own settings imply: rounds, local steps and
    # K from its parsed flags, the layer count from the config it builds.
    flags = fgl_train._parser().parse_args(args)
    imputations = len(range(0, flags.rounds, flags.imputation_interval))
    num_layers = FGLConfig().num_layers
    ksage.launches = 0
    ksim.launches = 0
    t0 = time.perf_counter()
    hist = fgl_train.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sage_n, sim_n = ksage.launches, ksim.launches
    print(f"[smoke] main path {' '.join(args)}: {wall:.1f} s wall (data included), "
          f"round seconds {[round(s, 3) for s in hist['seconds']]}, "
          f"launches sage_aggregate={sage_n} sim_topk={sim_n}")
    if not all(math.isfinite(v) for v in hist["loss"]):
        raise AssertionError(f"non-finite loss: {hist['loss']}")
    # Every classifier forward launches the kernel once per layer: local
    # steps and evaluation every round, embeddings on each imputation round.
    forwards = flags.rounds * (flags.local_rounds + 1) + imputations
    if sage_n != forwards * num_layers:
        raise AssertionError(f"sage_aggregate launched {sage_n} times, "
                             f"expected {forwards * num_layers}")
    if sim_n != imputations:
        raise AssertionError(f"sim_topk launched {sim_n} times, expected "
                             f"{imputations} (one per imputation round)")
    return sage_n, sim_n


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = _card_line()
    print(f"[smoke] card: {card}")
    print(f"[smoke] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build.load()
    print(f"[smoke] kernels built with nvcc for sm_90a in {time.perf_counter() - t0:.1f} s "
          f"-> {build.library_path().relative_to(ROOT)}")
    for log in sorted(build.library_path().parent.glob("*.ptxas.txt")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[smoke] ptxas {log.name.split('.')[0]}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = [_check_sage(dev, gen), _check_sim(dev, gen)]
    _check_small_run(dev)

    sage_a, sim_a = _main_path(SPREAD_ARGS)
    sage_b, sim_b = _main_path(FEDGL_ARGS)
    kernels[0]["launches"] = sage_a + sage_b
    kernels[1]["launches"] = sim_a + sim_b

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
