"""The harness finds a cell's parts by name, and a new cell or metric needs
only new files and ``BENCHMARK.json`` entries."""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness, judge
from portbench.tests import tiny

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(workload):
    cell = harness.load_cell(ROOT, workload)
    assert cell.config["driver"] == "fgl" and (HERE / "drivers" / "fgl.py").is_file()
    assert "imputation_interval" in cell.traffic
    assert {"loss_abs_gap", "grad_gap_clf", "gen_grad_gap", "change_gap_clf", "link_gap",
            "slots_gap"} <= set(cell.limits) <= set(judge.NUMBERS)
    e2e, layer = cell.readers(trace=False), cell.readers(trace=True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    assert all(callable(r.read) for r in (*e2e.values(), *layer.values()))


def test_benchmark_json_keeps_the_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and (HERE / "metrics" / f"{m['name']}.py").is_file()
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_a_new_cell_and_metric_need_only_new_files(tmp_path):
    """A throwaway traffic mix, configuration, limits and per-layer reader,
    added as files beside copies of the existing ones, run as a new cell."""
    home = tmp_path / "bench"
    shutil.copytree(HERE, home, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    cfg = tiny.shrink(json.loads((HERE / "configs" / "spreadfgl-coauthor_cs.json").read_text()))
    (home / "configs" / "tiny-spreadfgl.json").write_text(json.dumps(cfg))
    (home / "traffic" / "k2-throwaway.json").write_text(json.dumps(
        {"imputation_interval": 2, "participation": 1.0, "loop": "closed", "first_rounds": 3}))
    limits = json.loads((HERE / "limits" / "spreadfgl-coauthor_cs.k5.json").read_text())
    (home / "limits" / "tiny-spreadfgl.k2.json").write_text(json.dumps(limits))
    (home / "metrics" / "plain_rounds.py").write_text(
        "def read(ctx):\n    return float(len(ctx['impute_flags']) - sum(ctx['impute_flags']))\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "tiny-spreadfgl"})
    spec["workloads"].append({"name": "tiny-spreadfgl.k2", "config": "tiny-spreadfgl",
                              "traffic": "k2-throwaway", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "plain_rounds", "unit": "rounds", "better": "higher",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["tiny-spreadfgl.k2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell(tmp_path, "tiny-spreadfgl.k2", home)
    result = tiny.run(cell, seconds=0.3)
    assert result["correct"], result["checks"]
    assert result["metrics"]["plain_rounds"]["value"] > 0
    assert {"round_s", "round_p90_s", "setup_s", "peak_mem_gb"} <= set(result["metrics"])


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would go ahead")
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                          SPEC["workloads"][0]["name"], "--seed", "3", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
