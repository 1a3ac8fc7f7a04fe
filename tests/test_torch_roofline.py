"""The port's H100 cost model against the reference's roofline (``repro.roofline``).

FLOPs: ``FlopCounterMode`` over the port's step on the CPU against
``hlo_cost.analyze_text`` of the reference's compiled step, and the count
of the same step on ``meta`` tensors (``roofline.step_cost``, the kernels
charged through ``kernels.meta``) against the CPU count. Then the collective
scheme, the records of ``launch.dryrun`` and ``launch.gossip_dryrun``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as RC
from repro.core import gossip as RG
from repro.models import transformer as RT
from repro.optim import adam as RA
from repro.roofline import analysis as RAN
from repro.roofline import hlo_cost
from repro.train import step as RS
from repro_torch import configs as PC
from repro_torch.configs import InputShape
from repro_torch.kernels import meta, ops
from repro_torch.launch import dryrun, gossip_dryrun
from repro_torch.launch.mesh import ProductionMesh, make_card_mesh, make_production_mesh
from repro_torch.models import transformer as PT
from repro_torch.optim import adam as PA
from repro_torch.roofline import analysis, hw, step_cost
from repro_torch.train import step as PS

ROOT = Path(__file__).resolve().parents[1]


def _reference_flops(fn, *args) -> float:
    return hlo_cost.analyze_text(jax.jit(fn).lower(*args).compile().as_text())["flops"]


def _cpu_flops(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _forward_flops(arch, b, s):
    rc, pc = RC.get_config(arch, "smoke"), PC.get_config(arch, "smoke")
    params = RT.init_model(jax.random.key(0), rc)
    ref = _reference_flops(lambda p, t: RT.forward(p, rc, t), params, jnp.zeros((b, s), jnp.int32))
    model = PT.init_model(pc, device="cpu")
    return ref, _cpu_flops(lambda: PT.forward(model, torch.zeros((b, s), dtype=torch.long))), pc


@pytest.mark.parametrize("arch,b,s", [("qwen3-4b", 4, 64), ("gemma3-12b", 4, 128),
                                      ("hymba-1.5b", 4, 128)])
def test_forward_flops_equal_reference_hlo(arch, b, s):
    ref, port, _ = _forward_flops(arch, b, s)
    assert port == ref


def test_olmoe_forward_flops_differ_by_the_one_hot_products():
    """0.634x the reference: the reference dispatches and combines with
    one-hot ``[G, T, E, C]`` einsums, dots in its HLO (``gtke,gtkc->gtec``
    twice, ``gtec,gtd->gecd`` and ``gtec,gecd->gtd``); the port dispatches by
    index and combines each token's k slots in one ``[1, k] x [k, d]``
    product. The expert products and the router agree exactly."""
    ref, port, cfg = _forward_flops("olmoe-1b-7b", 4, 128)
    g, t, e, k, d, ff = 4, 128, cfg.num_experts, cfg.experts_per_token, cfg.d_model, cfg.d_ff
    c = max(1, int(cfg.capacity_factor * t * k / e))
    one_hot = 2 * (2 * g * t * e * c * k) + 2 * (2 * g * t * e * c * d)
    combine = 2 * g * t * k * d
    assert ref - port == cfg.num_layers * (one_hot - combine)
    assert round(port / ref, 3) == 0.634
    experts = 3 * 2 * e * (g * c) * d * ff          # up, gate, down, batched over experts
    moe = PT.init_model(cfg, device="cpu").blocks[0].moe
    from repro_torch.models import moe as PM
    x = torch.zeros(b := 4, 128, d)
    got = _cpu_flops(lambda: PM.apply_moe(moe, x, num_experts=e, top_k=k,
                                          capacity_factor=cfg.capacity_factor, act=cfg.act))
    assert got == experts + 2 * g * t * d * e + combine


def test_xlstm_forward_flops_differ_by_the_mlstm_einsum_order():
    """1.036x the reference: ``torch.einsum`` contracts left to right, so the
    mLSTM's ``bqhd,bqhe,bqh->bhde`` first forms each step's outer product
    k vᵀ as a batched product of inner size 1 (2 B S H Dh² counted), where
    the reference's order scales v by the gates first; and
    ``bqhd,bhd,bqh->bqh`` is a product here (2 B S H Dh) and a
    multiply-and-reduce, no dot, in the reference's HLO."""
    ref, port, cfg = _forward_flops("xlstm-125m", 4, 128)
    b, s, h = 4, 128, cfg.num_heads
    dh = cfg.ssm_expand * cfg.d_model // h
    n_mlstm = sum(k == "mlstm" for k in cfg.block_pattern)
    assert port - ref == n_mlstm * (2 * b * s * h * dh * dh + 2 * b * s * h * dh)
    assert round(port / ref, 3) == 1.036


@pytest.mark.parametrize("remat", [False, True])
def test_qwen3_train_step_flops_within_5_percent_of_reference(remat):
    """The port's step counts one attention product per layer more than the
    reference's: its backward (``ref.flash_attention_bwd``, and the kernel)
    recomputes the scores from the row log-sum-exp, five ``Sq x Skv``
    products where autodiff of the reference's attention keeps P and needs
    four. Everything else, remat's recomputed forward included, agrees."""
    rc = dataclasses.replace(RC.get_config("qwen3-4b", "smoke"), remat=remat)
    pc = dataclasses.replace(PC.get_config("qwen3-4b", "smoke"), remat=remat)
    ropt = RA.Adam(lr=1e-4, clip_norm=1.0)
    ref = _reference_flops(RS.make_train_step(rc, ropt), RS.init_state(jax.random.key(0), rc, ropt),
                           {"tokens": jnp.zeros((4, 64), jnp.int32)})
    popt = PA.Adam(lr=1e-4, clip_norm=1.0)
    state = PS.init_state(pc, popt, model=PT.init_model(pc, device="cpu"))
    step = PS.make_train_step(pc, popt)
    port = _cpu_flops(lambda: step(state, {"tokens": torch.zeros((4, 64), dtype=torch.int32)}))
    assert abs(port / ref - 1) < 0.05
    assert port - ref == pc.num_layers * 2 * 4 * pc.num_heads * 64 * 64 * pc.head_dim


def _meta_step(cfg, b, s, kind):
    model = PT.Transformer(cfg, device="meta")
    tokens = torch.empty((b, s), dtype=torch.int32, device="meta")
    if kind == "train":
        opt = PA.Adam(lr=1e-4, clip_norm=1.0)
        state = PS.init_state(cfg, opt, model=model)
        step = PS.make_train_step(cfg, opt)
        with step_cost.count() as c:
            step(state, {"tokens": tokens})
    else:
        with torch.no_grad(), step_cost.count() as c:
            PT.forward(model, tokens)
    return c


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("kind", ["train", "forward"])
def test_meta_count_equals_cpu_count(kind, remat):
    """The same port step counted on the CPU (plain attention, by
    ``FlopCounterMode``) and on meta (the kernel's charge): equal FLOPs."""
    cfg = dataclasses.replace(PC.get_config("gemma3-12b", "smoke"), remat=remat)
    b, s = 2, 64
    if kind == "train":
        opt = PA.Adam(lr=1e-4, clip_norm=1.0)
        state = PS.init_state(cfg, opt, model=PT.init_model(cfg, device="cpu"))
        step = PS.make_train_step(cfg, opt)
        cpu = _cpu_flops(lambda: step(state, {"tokens": torch.zeros((b, s), dtype=torch.int32)}))
    else:
        model = PT.init_model(cfg, device="cpu")
        with torch.no_grad():
            cpu = _cpu_flops(lambda: PT.forward(model, torch.zeros((b, s), dtype=torch.long)))
    c = _meta_step(cfg, b, s, kind)
    assert c.flops == cpu
    assert c.kernel_flops > 0 and c.hbm_bytes > c.kernel_bytes > 0
    if kind == "train":
        assert c.saved_bytes > 0 and c.peak_bytes > 0


def test_step_cost_counts_views_free_and_refuses_other_devices():
    x = torch.empty((64, 32), device="meta")
    with step_cost.count() as c:
        y = x.t()[:, :16].unsqueeze(0).transpose(1, 2).detach()
        w = x.view(-1).reshape(32, 64)
    assert c.hbm_bytes == 0 and c.flops == 0 and c.peak_bytes == 0
    assert y.device.type == w.device.type == "meta"
    with step_cost.count() as c:
        x.t().reshape(-1)           # not a view of x: a copy, read and written
        x.mul_(2.0)                 # in place: read and written
    assert c.hbm_bytes == 4 * x.numel() * 4
    with step_cost.count() as c:
        z = x @ x.t()
    assert c.flops == 2 * 64 * 64 * 32
    assert c.hbm_bytes == 2 * 64 * 32 * 4 + 64 * 64 * 4   # x read once per operand view, z written
    assert c.peak_bytes == z.numel() * 4
    with pytest.raises(RuntimeError, match="only meta"), step_cost.count():
        torch.ones(3) + torch.ones(3)


def test_kernel_meta_route_gives_shapes_and_charges():
    q = torch.empty((2, 8, 128, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 2, 128, 64), dtype=torch.bfloat16, device="meta")
    out = ops.mha(q, k, k, window=32)          # no counter: shapes only
    assert out.shape == q.shape and out.dtype == q.dtype and out.device.type == "meta"
    with step_cost.count() as c:
        ops.mha(q, k, k)
    assert c.kernel_flops == 4 * 2 * 8 * 128 * 128 * 64
    assert c.kernel_bytes == (q.numel() * 2 + 2 * k.numel()) * 2
    qg = q.clone().requires_grad_(True)
    with step_cost.count() as c:
        ops.mha(qg, k, k).float().sum().backward()
    assert qg.grad.shape == q.shape
    assert c.kernel_flops == (4 + 10) * 2 * 8 * 128 * 128 * 64
    with pytest.raises(ValueError, match="no implementation for device meta"):
        ops.sage_aggregate(torch.empty((1, 4, 4), device="meta"),
                           torch.empty((1, 4, 8), device="meta"))
    assert meta.counters == []


@pytest.mark.parametrize("arch", PC.ARCH_IDS)
@pytest.mark.parametrize("shape_name", tuple(PC.INPUT_SHAPES))
def test_model_flops_equal_reference(arch, shape_name):
    want = RAN.model_flops(RC.get_config(arch, "full"), RC.INPUT_SHAPES[shape_name])
    assert analysis.model_flops(PC.get_config(arch, "full"), PC.INPUT_SHAPES[shape_name]) == want


def test_per_device_flops_times_chips_match_one_device():
    """Where every sharded dim divides (Qwen3-4B on (data 32, model 8)), one
    device's FLOPs times 256 are the one card's count of the whole batch."""
    cfg, shape = PC.get_config("qwen3-4b", "full"), InputShape("t", 512, 64, "train")
    one = analysis.analyze(cfg, shape, make_card_mesh())
    mesh = ProductionMesh("t", {"data": 32, "model": 8}, make_production_mesh().links)
    dev = analysis.analyze(cfg, shape, mesh)
    assert abs(dev.flops * mesh.chips / one.flops - 1) < 0.01
    assert one.collective_s == 0 and dev.axis_bytes["model"] > 0 and dev.axis_bytes["data"] > 0


def test_card_record_is_the_measured_step_shape():
    """The one-card record of chip_smoke.py's training step: no collective,
    compute = FLOPs over the bf16 peak, the Adam state resident."""
    cfg = PC.get_config("qwen3-4b", "full")
    rec = dryrun.run_one(cfg, InputShape("train_2x2048", 2048, 2, "train"), make_card_mesh())
    assert rec["status"] == "ok" and rec["collective_s"] == 0 and rec["chips"] == 1
    assert rec["compute_s"] == rec["flops"] / hw.PEAK_FLOPS_BF16
    n = sum(p.numel() for p in PT.Transformer(cfg, device="meta").parameters())
    assert rec["memory_per_device"] > 12 * n               # bf16 weights and grads, f32 moments
    assert rec["hw"] == hw.NAME and rec["dominant"] in ("compute", "memory")


def test_chunked_and_reference_attention_impls():
    cfg = PC.get_config("gemma3-12b", "full")
    shape = InputShape("p", 4096, 1, "prefill")
    recs = {impl: dryrun.run_one(cfg, shape, make_card_mesh(), attention_impl=impl)
            for impl in ("", "reference", "chunked")}
    assert recs[""]["extra"]["kernel_flops"] > 0
    assert recs["reference"]["extra"]["kernel_flops"] == 0
    # plain attention materialises S x S scores; the chunked one [chunk x S] slabs
    assert (recs["reference"]["memory_per_device"] > recs["chunked"]["memory_per_device"]
            > recs[""]["memory_per_device"])
    # the window band cuts the local layers' products below the full ones
    assert recs["chunked"]["flops"] < recs["reference"]["flops"]


def test_gossip_dryrun_ratio_matches_reference():
    rec = gossip_dryrun.run("qwen3-4b", 8)
    want = RG.gossip_allreduce_ratio(rec["allreduce_bytes"], rec["spread_bytes_per_application"],
                                     every=8)
    assert rec["ratio"] == want
    mesh = make_production_mesh(multi_pod=True)
    n = sum(p.numel() for p in PT.Transformer(PC.get_config("qwen3-4b", "full"),
                                              device="meta").parameters())
    # each device holds about 1/256 of the bf16 weights: model x data shards
    assert abs(rec["local_param_bytes"] / (2 * n / (mesh.chips / 2)) - 1) < 0.05
    assert rec["allreduce_bytes"] == 2 * rec["local_param_bytes"]   # f32, 2 pods
    assert rec["spread_s_per_step"] == rec["spread_bytes_per_step"] / hw.IB_BW


def test_dryrun_cli_runs_without_a_gpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "qwen3-4b", "--shape", "train_4k", "--mesh", "both", "--out",
                          str(tmp_path)], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*.json"))]
    assert [(r["mesh"], r["status"]) for r in recs] == [("multi", "ok"), ("single", "ok")]
    for r in recs:
        assert set(r["axis_seconds"]) == set(r["axis_bytes"]) and r["collective_s"] > 0
        assert r["hw"] == hw.NAME and r["memory_per_device"] > 0
    assert recs[0]["chips"] == 512 and recs[1]["chips"] == 256
