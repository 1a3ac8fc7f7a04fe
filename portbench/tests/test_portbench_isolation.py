"""No module the benchmark runs loads JAX or the JAX package, and the
reference takes nothing of the port.

Top-level names are compared whole: ``repro_torch`` is the port, ``repro``
the JAX package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.relative_to(HERE).parts)
REFERENCE = sorted((HERE / "reference").rglob("*.py"))


def _imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_or_jax_package_import(path):
    assert not _imported(path) & {"jax", "jaxlib", "flax", "repro"}
    assert "benchmarks/" not in path.read_text()


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_port(path):
    assert not _imported(path) & {"repro_torch", "jax", "jaxlib", "flax", "repro"}
    assert _imported(path) <= {"__future__", "dataclasses", "typing", "torch"}


def test_a_run_loads_no_jax_module():
    """A whole run on the CPU, with JAX's and the JAX package's imports made
    to fail, and ``run.forbidden_modules`` empty at its end."""
    code = "\n".join([
        "import sys",
        "for name in ('jax', 'jaxlib', 'flax', 'repro'):",
        "    sys.modules[name] = None",
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]",
        "from portbench import run",
        "from portbench.tests import tiny",
        "c = tiny.cell('spreadfgl-coauthor_cs.k5')",
        "r = tiny.run(c, seconds=0.2)",
        "for name in ('jax', 'jaxlib', 'flax', 'repro'):",
        "    del sys.modules[name]",
        "assert r['correct'], r['checks']",
        "assert run.forbidden_modules() == [], run.forbidden_modules()",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from portbench import run
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", None)
    assert "repro_torch_lookalike" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", None)
    assert "repro.core" in run.forbidden_modules()
