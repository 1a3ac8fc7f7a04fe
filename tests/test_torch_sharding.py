"""The port's sharding rules and specs against the reference's (``repro.sharding``).

Every leaf of every config at full size is laid out on the reference's
``(data 16, model 16)`` TPU layout and on the port's H100 meshes, ``(data
32, model 8)`` and ``(pod 2, data 32, model 8)``: the port's per-layer specs
equal the reference's stacked ones with the ``layers`` entry dropped,
exactly. Shapes come from ``jax.eval_shape`` on one side and ``meta``
builds on the other, so nothing is allocated.
"""
import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as RC
from repro.models import transformer as RT
from repro.sharding import rules as RR
from repro.sharding import specs as RS
from repro_torch import configs as PC
from repro_torch.launch.mesh import ProductionMesh, make_card_mesh, make_production_mesh
from repro_torch.roofline import hw
from repro_torch.sharding import constraints, rules, specs


class FakeMesh:
    """Duck-typed mesh exposing .shape mapping (enough for rules)."""

    def __init__(self, **axes):
        self.shape = dict(axes)


MESHES = {"tpu_16x16": dict(data=16, model=16), "h100_single": dict(data=32, model=8),
          "h100_multi": dict(pod=2, data=32, model=8)}


def _norm(spec):
    """A reference PartitionSpec (or tuple) as the port writes specs: a
    1-tuple of axes collapsed to its name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


# The cases of tests/test_sharding.py::TestLogicalToSpec, plus a few more.
RULE_CASES = [
    (("embed", "heads"), (4096, 4096), dict(data=16, model=16)),
    (("embed", "heads"), (1600, 25 * 64), dict(data=16, model=16)),
    ((None, "heads"), (7, 25), dict(data=16, model=16)),
    (("ff", "heads"), (1024, 1024), dict(data=16, model=16)),
    (("experts", "embed", "expert_ff"), (64, 2048, 1024), dict(data=16, model=16)),
    (("experts", "embed", "expert_ff"), (8, 4096, 14336), dict(data=16, model=16)),
    (("batch", None), (256, 4096), dict(pod=2, data=16, model=16)),
    (("layers", "embed", "ff"), (32, 4096, 14336), dict(data=16, model=16)),
    (("kv_heads", "embed"), (8, 2560), dict(data=16, model=16)),
    (("batch", None), (32, 4096), dict(pod=2, data=32, model=8)),
    (("vocab", "embed"), (51865, 1024), dict(data=32, model=8)),
]


@pytest.mark.parametrize("axes,shape,mesh", RULE_CASES)
def test_logical_to_spec_matches_reference(axes, shape, mesh):
    want = RR.logical_to_spec(axes, shape, FakeMesh(**mesh))
    assert rules.logical_to_spec(axes, shape, FakeMesh(**mesh)) == _norm(want)


def test_batch_axes_and_axis_size():
    mesh = FakeMesh(pod=2, data=32, model=8)
    assert rules.batch_axes(mesh) == RR.batch_axes(mesh) == ("pod", "data")
    assert rules.axis_size(mesh, ("pod", "data")) == 64
    assert rules.local_shape((256, 4096), (("pod", "data"), None), mesh) == (4, 4096)


def _flat_specs(tree, prefix=""):
    """A reference spec tree as {dotted path: spec}."""
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    out = {}
    for path, spec in leaves:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out[prefix + ".".join(keys)] = spec
    return out


@functools.lru_cache(maxsize=None)
def _reference_specs(arch: str, mesh_name: str):
    """The reference's specs per port parameter name: stacked group leaves
    unstacked to layers, their leading ``layers`` entry dropped."""
    cfg = RC.get_config(arch, "full")
    mesh = FakeMesh(**MESHES[mesh_name])
    shapes = jax.eval_shape(functools.partial(RT.init_model, cfg=cfg), jax.random.key(0))
    tree = RR.spec_tree(RT.model_axes(cfg), shapes, mesh)
    out = {}
    for key in ("embed", "final_norm"):
        out.update(_flat_specs(tree[key], f"{key}."))
    g = RT.group_size(cfg)
    if cfg.arch_type == "ssm":
        for i, bp in enumerate(tree["blocks"]):
            out.update(_flat_specs(bp, f"blocks.{i}."))
    else:
        for r, stacked in enumerate(tree["blocks"]):
            for gi in range(cfg.num_layers // g):
                out.update({k: tuple(s)[1:] for k, s in
                            _flat_specs(stacked, f"blocks.{gi * g + r}.").items()})
    if cfg.cross_attn_interval:
        for gi in range(cfg.num_layers // g):
            out.update({k: tuple(s)[1:] for k, s in
                        _flat_specs(tree["cross_blocks"], f"cross_blocks.{gi}.").items()})
    if cfg.is_encdec:
        enc = tree["encoder"]
        out["encoder.positions"] = enc["positions"]
        out.update(_flat_specs(enc["final_norm"], "encoder.final_norm."))
        for i in range(cfg.encoder_layers):
            out.update({k: tuple(s)[1:] for k, s in
                        _flat_specs(enc["blocks"], f"encoder.blocks.{i}.").items()})
    return {k: _norm(v) for k, v in out.items()}


@pytest.mark.parametrize("mesh_name", tuple(MESHES))
@pytest.mark.parametrize("arch", PC.ARCH_IDS)
def test_param_specs_match_reference(arch, mesh_name):
    want = _reference_specs(arch, mesh_name)
    got = specs.param_specs(PC.get_config(arch, "full"), FakeMesh(**MESHES[mesh_name]))
    assert set(got) == set(want)
    diff = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
    assert not diff, list(diff.items())[:5]


@pytest.mark.parametrize("arch", ["qwen3-4b", "hymba-1.5b", "xlstm-125m", "whisper-medium",
                                  "mixtral-8x7b"])
@pytest.mark.parametrize("mesh_name", ["tpu_16x16", "h100_multi"])
def test_cache_specs_match_reference(arch, mesh_name, monkeypatch):
    """``specs.cache_specs``'s decisions equal ``_cache_entry_sharding``'s
    (its NamedShardings unwrapped to their specs) for every layer's entry."""
    monkeypatch.setattr(RS, "NamedSharding", lambda mesh, spec: spec)
    shape = PC.INPUT_SHAPES["decode_32k"]
    cfg_r, cfg_p = RC.get_config(arch, "full"), PC.get_config(arch, "full")
    mesh = FakeMesh(**MESHES[mesh_name])
    mem = None
    if cfg_r.is_encdec or cfg_r.cross_attn_interval:
        mem = jax.ShapeDtypeStruct(specs.memory_shape(cfg_p, shape.global_batch), cfg_r.dtype)
    from repro.models import decoding as RD
    ref_cache = jax.eval_shape(
        lambda m: RD.init_cache(cfg_r, shape.global_batch, shape.seq_len, memory=m), mem)
    got = specs.cache_specs(cfg_p, shape, mesh)
    assert len(got["layers"]) == len(ref_cache["layers"])
    for ref_entry, entry in zip(ref_cache["layers"], got["layers"]):
        want = RS._cache_entry_sharding(ref_entry, cfg_r, mesh, shape.global_batch)
        assert {k: v[0] for k, v in entry.items()} == {k: tuple(s.shape)
                                                       for k, s in ref_entry.items()}
        assert {k: v[2] for k, v in entry.items()} == {k: _norm(s) for k, s in want.items()}


@pytest.mark.parametrize("arch", ["qwen3-4b", "llama-3.2-vision-11b", "whisper-medium"])
@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k", "long_500k"])
def test_batch_specs_match_reference(arch, shape_name):
    """The tokens' and memory's batch entry is ``_batch_spec``'s (the
    reference builds these specs only inside a mesh context)."""
    shape = PC.INPUT_SHAPES[shape_name]
    mesh = FakeMesh(**MESHES["h100_multi"])
    cfg = PC.get_config(arch, "full")
    ba = _norm((RS._batch_spec(mesh, shape.global_batch),))[0]
    got = specs.batch_specs(cfg, shape, mesh)
    assert got["tokens"][0] == (shape.global_batch, shape.seq_len)
    assert got["tokens"][2] == (ba, None)
    if arch == "qwen3-4b":
        assert set(got) == {"tokens"}
    else:
        assert got["memory"][2] == (ba, None, None)
        assert got["memory"][0][1] == (cfg.encoder_seq or cfg.num_image_tokens)


@pytest.mark.parametrize("shape", [(8, 4096, 2560), (32, 4096, 151936), (3, 5, 7)])
@pytest.mark.parametrize("pattern", [("batch", "seq", None), ("batch", None, "vocab"),
                                     (None, "heads", "ff")])
def test_activation_spec_resolves_as_constrain(shape, pattern):
    """``constraints.activation_spec`` against the reference's ``constrain``,
    whose resolution is checked here on its own terms (the fits of
    ``src/repro/sharding/constraints.py:31-63``) on the H100 meshes."""
    for mesh in (FakeMesh(**MESHES["h100_single"]), FakeMesh(**MESHES["h100_multi"])):
        spec = constraints.activation_spec(shape, pattern, mesh)
        batch = tuple(a for a in ("pod", "data") if a in mesh.shape)
        for dim, p, e in zip(shape, pattern, spec):
            if p == "batch":
                fits = dim % rules.axis_size(mesh, batch) == 0
                assert e == ((batch if len(batch) > 1 else batch[0]) if fits else None)
            elif p is not None:
                assert e == ("model" if dim % mesh.shape["model"] == 0 else None)
            else:
                assert e is None


def test_production_meshes():
    single, multi, card = (make_production_mesh(), make_production_mesh(multi_pod=True),
                           make_card_mesh())
    assert single.shape == {"data": 32, "model": 8} and single.chips == hw.CHIPS_SINGLE_POD
    assert multi.shape == {"pod": 2, "data": 32, "model": 8}
    assert multi.chips == hw.CHIPS_MULTI_POD and card.chips == 1
    # tensor parallelism stays inside one NVLink node; the rest crosses InfiniBand
    assert multi.shape["model"] == hw.GPUS_PER_NODE
    assert multi.links["model"][1] == hw.NVLINK_BW
    assert multi.links["data"][1] == multi.links["pod"][1] == hw.IB_BW


@pytest.mark.parametrize("mesh_name", ["tpu_16x16", "h100_single"])
@pytest.mark.parametrize("arch", PC.ARCH_IDS)
def test_local_program_shapes(arch, mesh_name):
    """Every leaf of the local program is its stored shard, gathered by a
    whole number of shards on each axis, or expert-parallel; GQA on the
    reference's 16-way layout takes the kv heads its q heads need."""
    mesh = ProductionMesh(mesh_name, MESHES[mesh_name],
                          {a: ("link", 1.0) for a in MESHES[mesh_name]})
    cfg = PC.get_config(arch, "full")
    prog = specs.local_program(cfg, PC.INPUT_SHAPES["train_4k"], mesh)
    assert prog.batch == 256 // mesh.shape["data"]
    for leaf in prog.leaves.values():
        for j, (c, s, full) in enumerate(zip(leaf.compute, leaf.stored, leaf.shape)):
            assert c % s == 0 and c <= full, (leaf.name, j)
        assert 0 < leaf.share <= 1
    local = prog.local
    assert local.num_heads % local.num_kv_heads == 0
    if arch == "qwen3-4b" and mesh_name == "tpu_16x16":
        assert (local.num_heads, local.num_kv_heads) == (2, 1)
        assert prog.leaves["blocks.0.attn.wk"].gather == {"data": 16, "model": 2}


def test_local_program_on_one_card_is_the_model():
    cfg = PC.get_config("olmoe-1b-7b", "full")
    prog = specs.local_program(cfg, PC.INPUT_SHAPES["train_4k"], make_card_mesh())
    assert prog.local == cfg and prog.batch == 256
    for name, p in prog.model.named_parameters():
        leaf = prog.leaves[name]
        assert leaf.compute == leaf.stored == leaf.shape == tuple(p.shape)
        assert not leaf.gather and not leaf.expert_parallel and p.device.type == "meta"
    assert all(isinstance(p, torch.nn.Parameter) for p in prog.model.parameters())
