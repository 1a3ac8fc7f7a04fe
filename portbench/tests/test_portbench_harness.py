"""The harness finds a cell's parts by name, holds each cell to its driver's
contract, and a new cell, metric or driver needs only new files and
``BENCHMARK.json`` entries."""
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import counts, harness, judge, peaks
from portbench.tests import tiny

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FGL_LAYERS = {"local_ms", "impute_ms", "aggregate_ms", "generator_ms",
              "sage_aggregate_roofline", "sim_topk_roofline"}


def chips_allowed(workloads) -> bool:
    """Each cell on 1 or 4 chips, and at most a quarter of the cells, rounded
    down, on 4; one always may."""
    four = sum(w["chips"] == 4 for w in workloads)
    return (all(w["chips"] in (1, 4) for w in workloads)
            and four <= max(1, len(workloads) // 4))


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(workload):
    cell = harness.load_cell(ROOT, workload)
    assert (HERE / "drivers" / f"{cell.config['driver']}.py").is_file()
    assert set(cell.limits) <= set(cell.driver.CHECKS)
    assert set(cell.driver.TRAFFIC_KEYS) <= set(cell.traffic)
    if "fgl" in cell.config:
        assert cell.config["driver"] == "fgl" and cell.driver.CHECKS == judge.NUMBERS
        assert "imputation_interval" in cell.traffic
        assert {"loss_abs_gap", "grad_gap_clf", "gen_grad_gap", "change_gap_clf",
                "link_gap", "slots_gap"} <= set(cell.limits) <= set(judge.NUMBERS)
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
    assert chips_allowed(SPEC["workloads"])
    for w in SPEC["workloads"]:
        assert len(w["why"]) <= 200


@pytest.mark.parametrize("chips,allowed", [
    ([1, 4], True), ([4], True), ([1, 1, 1, 4], True), ([1] * 6 + [4, 4], True),
    ([1, 1, 4, 4], False), ([1] * 5 + [4] * 3, False), ([1, 2], False)])
def test_four_chip_cells_up_to_a_quarter(chips, allowed):
    assert chips_allowed([{"chips": c} for c in chips]) == allowed


def _throwaway_tree(tmp_path):
    """A copy of the benchmark's files under ``tmp_path``, and its spec."""
    home = tmp_path / "bench"
    shutil.copytree(HERE, home, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    return home, json.loads(json.dumps(SPEC))


@pytest.mark.parametrize("fault", ["undeclared_check", "missing_traffic_key"])
def test_load_cell_refuses_a_cell_outside_its_drivers_contract(tmp_path, fault):
    home, spec = _throwaway_tree(tmp_path)
    w = spec["workloads"][0]
    if fault == "undeclared_check":
        path = home / "limits" / f"{w['name']}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), "made_up_gap": 1.0}))
        said = "made_up_gap"
    else:
        path = home / "traffic" / f"{w['traffic']}.json"
        traffic = json.loads(path.read_text())
        del traffic["loop"]
        path.write_text(json.dumps(traffic))
        said = "lacks ['loop']"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    with pytest.raises(SystemExit, match=re.escape(said)):
        harness.load_cell(tmp_path, w["name"], home)


def test_mfu_equals_the_round_flops_formula():
    """``mfu`` from the driver's ``model_flops`` and ``peak_flops``, bit for bit
    the FLOPs of ``counts.round_flops`` over the window's rounds."""
    cell = tiny.cell(SPEC["workloads"][0]["name"])
    ctx = cell.driver.run(cell, seed=41, seconds=0.2, trace=False, device="cpu",
                          start=time.perf_counter(), readers={})
    flops = sum(counts.round_flops(ctx["shapes"], imp) for imp in ctx["impute_flags"])
    mfu = harness.load_module(HERE / "metrics" / "mfu.py").read(ctx)
    assert ctx["model_flops"] == flops and ctx["peak_flops"] == peaks.TF32_FLOPS
    assert mfu == 100.0 * flops / ctx["window_s"] / peaks.TF32_FLOPS


@pytest.mark.parametrize("trace", [False, True])
def test_a_cell_of_another_driver_needs_only_new_files(tmp_path, trace):
    """A training driver that is not an FGL round, with its configuration,
    traffic and limits, added as files and entries beside copies of the
    existing ones, run as a new cell: the shared readers read it, the FGL
    layers' readers do not."""
    home, spec = _throwaway_tree(tmp_path)
    shutil.copy(HERE / "tests" / "throwaway_lm_driver.py", home / "drivers" / "lm_throwaway.py")
    (home / "configs" / "olmoe-smoke.json").write_text(json.dumps(
        {"driver": "lm_throwaway", "arch": "olmoe-1b-7b", "variant": "smoke", "reduced": []}))
    (home / "traffic" / "b2s32.json").write_text(json.dumps(
        {"batch": 2, "seq": 32, "first_steps": 2}))
    (home / "limits" / "olmoe-smoke.b2s32.json").write_text(json.dumps({"nonfinite_losses": 0}))
    spec["configs"].append({"name": "olmoe-smoke"})
    spec["workloads"].append({"name": "olmoe-smoke.b2s32", "config": "olmoe-smoke",
                              "traffic": "b2s32", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell(tmp_path, "olmoe-smoke.b2s32", home)
    result = tiny.run(cell, trace=trace, seconds=0.3)
    assert result["correct"] and result["attempted"] > 0, result
    if trace:
        assert set(result["metrics"]) == {"mfu", "idle_share"}
        assert result["metrics"]["mfu"]["value"] > 0
    else:
        assert set(result["metrics"]) == {"round_s", "round_p90_s", "peak_mem_gb", "setup_s"}
    assert not set(result["metrics"]) & FGL_LAYERS


def test_a_new_cell_and_metric_need_only_new_files(tmp_path):
    """A throwaway traffic mix, configuration, limits and per-layer reader,
    added as files beside copies of the existing ones, run as a new cell."""
    home, spec = _throwaway_tree(tmp_path)
    cfg = tiny.shrink(json.loads((HERE / "configs" / "spreadfgl-coauthor_cs.json").read_text()))
    (home / "configs" / "tiny-spreadfgl.json").write_text(json.dumps(cfg))
    (home / "traffic" / "k2-throwaway.json").write_text(json.dumps(
        {"imputation_interval": 2, "participation": 1.0, "loop": "closed", "first_rounds": 3}))
    limits = json.loads((HERE / "limits" / "spreadfgl-coauthor_cs.k5.json").read_text())
    (home / "limits" / "tiny-spreadfgl.k2.json").write_text(json.dumps(limits))
    (home / "metrics" / "plain_rounds.py").write_text(
        "def read(ctx):\n    return float(len(ctx['impute_flags']) - sum(ctx['impute_flags']))\n")
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
