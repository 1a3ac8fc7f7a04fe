"""Finds a cell's files by name, runs its driver, reads its metrics, prints.

A cell is one entry of ``workloads`` in ``BENCHMARK.json``. Its parts are
files named after it, so that a later cell or metric is added by adding
files and entries:

- ``configs/<config>.json``: the deployment; its ``driver`` key names
  ``drivers/<driver>.py``;
- ``traffic/<traffic>.json``: the traffic mix's parameters;
- ``limits/<workload>.json``: the numbers compared, each with its limit;
- ``metrics/<metric>.py``: a reader, ``read(ctx) -> float | None``, for each
  metric; ``None`` leaves the metric out of the line. A per-layer reader
  may declare ``SPANS = {span: "module:attribute"}``: the calls the
  driver wraps in ``pb.<span>#<i>`` ranges in the profiled stretch.

A driver declares ``CHECKS``, the names its judge can produce, and
``TRAFFIC_KEYS``, the keys it reads from a traffic mix; :func:`load_cell`
refuses, before any run, a cell whose limits name another check or whose
traffic lacks one of those keys. Its ``run(cell, seed=, seconds=, trace=,
device=, start=, readers=, fault=)`` returns the run's context, a dict. The
shared readers (``setup_s``, ``round_s``, ``round_p90_s``, ``peak_mem_gb``,
``mfu``, ``idle_share``) read only these keys of it, which every driver
returns:

- ``setup_s``: seconds from ``start`` to the window;
- ``window_s``: the measured window's seconds;
- ``round_times``: host seconds of each round of the window, one entry a
  round; a round is the driver's unit of closed-loop work (a global round
  for ``fgl``, an optimizer step for a training driver);
- ``peak_bytes``: the device's peak allocation over set-up and window;
- ``checks``: each number the judge compared, by name;
- ``attempted``, ``failed``: rounds run, and those whose result was bad;
- ``device``: the result line's ``device`` object;
- with ``trace``: ``trace`` (a ``trace.Trace``: ``busy_s``, ``spans``) and
  ``trace_flags`` (one entry per profiled round), ``model_flops`` (the model
  FLOPs of the window's rounds, as the driver counts them) and
  ``peak_flops`` (the card's dense peak in the cell's dtype, ``peaks.py``);
  and optionally ``breakdown``.

A driver adds what its own readers need beside these.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    driver: ModuleType
    end_to_end: List[Dict]
    per_layer: List[Dict]
    home: Path            # the directory holding configs/, traffic/, ...

    def readers(self, trace: bool) -> Dict[str, ModuleType]:
        """The reader of each metric this cell reports in this kind of run."""
        metrics = self.per_layer if trace else self.end_to_end
        return {m["name"]: load_module(self.home / "metrics" / f"{m['name']}.py")
                for m in metrics if self.name in m.get("workloads", [self.name])}


def load_module(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, workload: str, home: Optional[Path] = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, its files under
    ``home`` (this directory by default)."""
    home = home or HERE
    spec = _json(root / "BENCHMARK.json")
    found = [w for w in spec["workloads"] if w["name"] == workload]
    if not found:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json; have "
                         f"{', '.join(w['name'] for w in spec['workloads'])}")
    w = found[0]
    config = _json(home / "configs" / f"{w['config']}.json")
    traffic = _json(home / "traffic" / f"{w['traffic']}.json")
    limits = _json(home / "limits" / f"{workload}.json")
    driver = load_module(home / "drivers" / f"{config['driver']}.py")
    unknown = sorted(set(limits) - set(driver.CHECKS))
    missing = [k for k in driver.TRAFFIC_KEYS if k not in traffic]
    if unknown or missing:
        raise SystemExit(f"portbench: workload {workload!r}: driver {config['driver']!r} "
                         f"declares no check {unknown} (has {list(driver.CHECKS)}); traffic "
                         f"{w['traffic']!r} lacks {missing}")
    return Cell(name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=limits, driver=driver, end_to_end=spec["end_to_end"],
                per_layer=spec["per_layer"], home=home)


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, device: str, start: float,
        fault: Optional[str] = None) -> Dict:
    """Run the cell's driver, then read its metrics and judge its numbers."""
    readers = cell.readers(trace)
    ctx = cell.driver.run(cell, seed=seed, seconds=seconds, trace=trace, device=device,
                          start=start, readers=readers, fault=fault)
    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    for name, reader in readers.items():
        value = reader.read(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    checks = {k: {"value": float(ctx["checks"][k]), "limit": float(v)}
              for k, v in cell.limits.items()}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": ctx["attempted"], "failed": ctx["failed"],
              "metrics": metrics, "device": ctx["device"]}
    if trace and "breakdown" in ctx:
        result["breakdown"] = ctx["breakdown"]
    result["checks"] = checks
    return result


def report(result: Dict) -> None:
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
