"""A run of each cell, shrunk to CPU size, through the window and the check.

The sound port agrees with the reference under the cell's own limits; the
control (the reference in TF32 in the port's place) and each fault planted
in the port (``drivers/fgl.py``'s ``FAULTS``) come out not correct."""
import json
from pathlib import Path

import pytest

from portbench import calibrate
from portbench.drivers import fgl
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
WORKLOADS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    result = tiny.run(tiny.cell(workload), seed=17)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert {"round_s", "round_p90_s", "peak_mem_gb", "setup_s"} == set(result["metrics"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_run_reads_the_spans(workload):
    result = tiny.run(tiny.cell(workload), seed=18, trace=True)
    assert result["correct"], result["checks"]
    assert "mfu" in result["metrics"] and result["device"]["window_s"] > 0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload):
    cell = tiny.cell(workload)
    for seed in (21, 22, 23):
        nums = calibrate.readings(cell, "control", seed, "cpu")["readings"]
        assert any(nums[k] > limit for k, limit in cell.limits.items()), nums


@pytest.mark.parametrize("fault", fgl.FAULTS)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_is_not_correct(workload, fault):
    result = tiny.run(tiny.cell(workload), seed=19, fault=fault)
    assert not result["correct"], result["checks"]
