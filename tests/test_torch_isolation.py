"""The port stands alone and never hides the device.

- Every ``repro_torch`` module and ``chip_smoke.py`` import with ``jax``
  blocked, and none of their sources imports ``jax`` or the ``repro``
  package.
- The trainer and the launcher raise without CUDA unless told to use the
  CPU.
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core.partition import partition_graph
from repro_torch.core.spreadfgl import make_fedgl
from repro_torch.core.types import FGLConfig
from repro_torch.data.synthetic_graphs import DATASETS, make_sbm_graph
from repro_torch.launch import fgl_train

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))


def test_imports_without_jax():
    code = "\n".join([
        "import sys, importlib, importlib.util",
        "sys.modules['jax'] = None",
        f"sys.path.insert(0, {str(ROOT / 'src')!r})",
        *(f"importlib.import_module({m!r})" for m in _modules()),
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


@pytest.mark.parametrize("field,value", [("participation", 0.5), ("async_buffer", 2),
                                         ("gossip_every", 2), ("gnn_kind", "gcn")])
def test_unported_config_raises(tiny_batch, field, value):
    cfg = FGLConfig(hidden_dim=4, **{field: value})
    with pytest.raises(NotImplementedError, match=field):
        make_fedgl(cfg, tiny_batch, device="cpu")
