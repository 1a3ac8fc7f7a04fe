"""The port stands alone and never hides the device.

- Every ``repro_torch`` module, ``chip_smoke.py`` and the examples of
  ``examples_torch/`` import with ``jax`` blocked, and none of their sources
  imports ``jax`` or the ``repro`` package.
- The trainer, the launchers (FGL training, LM training) and the builders of
  LM weights and FGL state raise without CUDA unless told to use the CPU.
- The modules of the distributed edge layer (ring top-k, meshes, the edge
  mesh launcher) are among those imported with jax blocked.
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs, convert
from repro_torch.core.partition import partition_graph
from repro_torch.core.spreadfgl import make_fedgl, make_spreadfgl_gossip
from repro_torch.core.types import FGLConfig
from repro_torch.data.synthetic_graphs import DATASETS, make_sbm_graph
from repro_torch.launch import fgl_train
from repro_torch.launch import train as lm_train
from repro_torch.models import transformer

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples_torch").glob("*.py"))
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES


def _modules():
    return sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))


def test_imports_without_jax():
    code = "\n".join([
        "import sys, importlib, importlib.util",
        "sys.modules['jax'] = None",
        f"sys.path.insert(0, {str(ROOT / 'src')!r})",
        f"sys.path.insert(0, {str(ROOT)!r})",
        *(f"importlib.import_module({m!r})" for m in _modules()),
        *(f"importlib.import_module('examples_torch.{p.stem}')" for p in EXAMPLES),
        f"spec = importlib.util.spec_from_file_location('chip_smoke', {str(ROOT / 'chip_smoke.py')!r})",
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))",
        "assert not any(k == 'repro' or k.startswith(('repro.', 'jax.')) for k in sys.modules), "
        "sorted(k for k in sys.modules if k == 'repro' or k.startswith(('repro.', 'jax.')))",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {name}"


@pytest.fixture(scope="module")
def tiny_batch():
    g = make_sbm_graph(DATASETS["cora"], scale=0.03, seed=1)
    return partition_graph(g, 2, aug_max=2, seed=0)[0]


def test_trainer_defaults_to_cuda(tiny_batch):
    cfg = FGLConfig(hidden_dim=4, local_rounds=1)
    if torch.cuda.is_available():
        assert make_fedgl(cfg, tiny_batch).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_fedgl(cfg, tiny_batch)
    assert make_fedgl(cfg, tiny_batch, device="cpu").device.type == "cpu"


def test_launcher_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        fgl_train.main(["--scale", "0.03", "--rounds", "1"])


def test_lm_train_launcher_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_train.main(["--arch", "qwen3-4b", "--steps", "1"])
    out = lm_train.main(["--arch", "qwen3-4b", "--device", "cpu", "--steps", "1", "--batch",
                         "2", "--seq", "16"])
    assert out["state"].params.embed.tokens.device.type == "cpu"


def test_lm_builders_default_to_cuda():
    """``transformer.init_model``, ``convert.lm_params_from_jax`` and
    ``convert.state_from_reference`` build on the card unless told
    ``device="cpu"``: without one they raise before reading their inputs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    cfg = configs.get_config("qwen3-4b", "smoke")
    for build in (lambda: transformer.init_model(cfg),
                  lambda: convert.lm_params_from_jax({}, cfg),
                  lambda: convert.state_from_reference(None)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    assert transformer.init_model(cfg, device="cpu").embed.tokens.device.type == "cpu"


def test_train_modules_are_covered():
    """The LM training modules are among those imported with jax blocked."""
    assert {"repro_torch.train", "repro_torch.train.step",
            "repro_torch.launch.train"} <= set(_modules())


@pytest.mark.parametrize("field,value", [("participation", 0.5), ("async_buffer", 2),
                                         ("gossip_every", 2), ("gnn_kind", "gcn")])
def test_ported_config_builds(tiny_batch, field, value):
    cfg = FGLConfig(hidden_dim=4, **{field: value})
    assert getattr(make_fedgl(cfg, tiny_batch, device="cpu").cfg, field) == value


@pytest.mark.parametrize("build", [make_fedgl, make_spreadfgl_gossip])
def test_mesh_config_builds(tiny_batch, build):
    """Without a process group every mesh has size 1: the builders take one."""
    from repro_torch.launch import mesh
    kw = ({"sim_mesh": mesh.make_sim_mesh()} if build is make_fedgl
          else {"edge_mesh": mesh.make_edge_mesh(2), "num_servers": 2})
    tr = build(FGLConfig(hidden_dim=4), tiny_batch, device="cpu", **kw)
    got = tr.imputation.sim_mesh if build is make_fedgl else tr.edge_mesh
    assert got.size == 1 and got.rank == 0


def test_examples_are_covered():
    """The four examples of the JAX package have counterparts of the same
    names, scanned for imports and imported with jax blocked."""
    assert [p.name for p in EXAMPLES] == sorted(p.name for p in (ROOT / "examples").glob("*.py"))


def test_mesh_modules_are_covered():
    """The ring top-k and the mesh modules are among those imported with jax
    blocked, and scanned for imports."""
    assert {"repro_torch.core.ring_topk", "repro_torch.launch.mesh",
            "repro_torch.launch.edge_mesh"} <= set(_modules())
    assert {PORT / "core" / "ring_topk.py", PORT / "launch" / "mesh.py",
            PORT / "launch" / "edge_mesh.py"} <= set(SOURCES)
