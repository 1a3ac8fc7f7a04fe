"""A cell of the benchmark shrunk to a size the CPU tests can run in seconds:
the same configuration, traffic and limits files, with the dataset, the
widths and the loop counts cut, but not so far that the TF32 control
stops failing the cells' limits (it does from about 256 features, hidden
32 and 4 local steps)."""
from __future__ import annotations

import copy
import time
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


def shrink(config: dict) -> dict:
    c = copy.deepcopy(config)
    c["dataset"].update(num_nodes=240, num_edges=600, feature_dim=256, num_classes=4)
    c["num_clients"] = 4
    c["aug_max"] = 4
    if c["num_servers"] > 1:
        c["num_servers"] = 2
    c["model"]["hidden_dim"] = 32
    c["fgl"].update(local_rounds=4, top_k_links=3, ae_hidden=4, assessor_hidden=[8, 4],
                    ae_iters=2, assessor_iters=2, ae_outer_iters=2)
    return c


def cell(workload: str, root: Path = ROOT, home: Path = None) -> harness.Cell:
    c = harness.load_cell(root, workload, home)
    c.config = shrink(c.config)
    return c


def run(c: harness.Cell, *, seed: int = 5, trace: bool = False, fault: str = None,
        seconds: float = 0.3) -> dict:
    return harness.run(c, seed=seed, seconds=seconds, trace=trace, device="cpu",
                       start=time.perf_counter(), fault=fault)
