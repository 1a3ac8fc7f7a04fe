"""Quickstart: FedGL on a synthetic Cora stand-in, 10 communication rounds.

  PYTHONPATH=src python examples_torch/quickstart.py [--device cuda|cpu]

The PyTorch/CUDA port of ``examples/quickstart.py``: the paper's full
pipeline (GraphSAGE clients + graph imputation generator + versatile
assessor + negative sampling) on one edge server, accuracy per round, through
the public ``init / step / fit`` lifecycle of ``repro_torch``. On the card
(``--device cuda``, the default; it raises without one) the classifier's
aggregation and the imputation round's similarity top-k run as the CUDA
kernels ``sage_aggregate`` and ``sim_topk``; ``--device cpu`` runs their
plain PyTorch versions.
"""
from __future__ import annotations

import argparse
from typing import Any, Callable, Dict, Optional, Sequence

from repro_torch.core import registry
from repro_torch.core.fedgl import resolve_device
from repro_torch.core.partition import count_missing_links, partition_graph
from repro_torch.core.types import FGLConfig
from repro_torch.data.synthetic_graphs import DATASETS, make_sbm_graph

# FedGL (Sec. III-B): one edge server, imputation every K=2 rounds.
CONFIG = FGLConfig(hidden_dim=32, local_rounds=4, imputation_interval=2, top_k_links=4,
                   aug_max=12)


def data(scale: float = 0.15, clients: int = 6):
    """SBM stand-in for Cora (offline), split across ``clients`` clients
    with all cross-client links DELETED (the missing links): (graph,
    batch, assign)."""
    graph = make_sbm_graph(DATASETS["cora"], scale=scale, seed=1, feature_noise=3.0,
                           signal_ratio=0.5)
    batch, assign = partition_graph(graph, num_clients=clients, aug_max=CONFIG.aug_max,
                                    seed=0, label_ratio=0.3)
    return graph, batch, assign


def run(*, scale: float = 0.15, clients: int = 6, steps: int = 4, rounds: int = 6,
        device: str = "cuda", state=None,
        noise: Optional[Callable[[int], Any]] = None) -> Dict[str, Any]:
    """``steps`` rounds by ``step``, then ``fit(state=, rounds=rounds)``
    picking up where they stopped. ``state``: a state to start from instead
    of ``trainer.init``; ``noise(round)``: the imputation rounds' S (drawn
    from the state's generator when None or when it returns None). Returns
    the graph, batch, assign, trainer, final state, the steps' metrics
    (``step``) and the fit's history (``fit``), each a dict of per-round
    lists."""
    dev = resolve_device(device)
    graph, batch, assign = data(scale, clients)
    print(f"graph: {graph.num_nodes} nodes, {graph.num_edges} edges, "
          f"{graph.num_classes} classes")
    print(f"deleted cross-client links: {count_missing_links(graph, assign)}")

    # Every named method is a strategy composition in the registry.
    trainer = registry.build("FedGL", CONFIG, batch, device=dev)

    # Drive Algorithm 1 round by round: init -> step -> step -> ...
    state = trainer.init(batch) if state is None else state
    stepped: Dict[str, list] = {"round": [], "loss": [], "acc": [], "f1": []}
    for _ in range(steps):
        state, m = trainer.step(state, noise=noise(int(state.round)) if noise else None)
        for key in stepped:
            stepped[key].append(int(m[key]) if key == "round" else float(m[key]))
        print(f"round {m['round']:2d}  loss={float(m['loss']):7.4f}  "
              f"acc={float(m['acc']):.3f}  f1={float(m['f1']):.3f}")

    # fit() is the same loop, picking up exactly where `state` stopped.
    state, hist = trainer.fit(state=state, rounds=rounds, noise=noise)
    for i, r in enumerate(hist["round"]):
        print(f"round {r:2d}  loss={hist['loss'][i]:7.4f}  "
              f"acc={hist['acc'][i]:.3f}  f1={hist['f1'][i]:.3f}")
    print(f"best accuracy: {max(stepped['acc'] + hist['acc']):.3f}")
    return {"graph": graph, "batch": batch, "assign": assign, "trainer": trainer, "state": state,
            "step": stepped, "fit": hist}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda launches the CUDA kernels, cpu runs their plain versions")
    args = ap.parse_args(argv)
    return run(scale=0.15, clients=6, steps=4, rounds=6, device=args.device)


if __name__ == "__main__":
    main()
