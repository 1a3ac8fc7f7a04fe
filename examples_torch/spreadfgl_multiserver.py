"""SpreadFGL vs FedGL vs baselines: the paper's multi-edge scenario.

  PYTHONPATH=src python examples_torch/spreadfgl_multiserver.py [--device cuda|cpu]

The PyTorch/CUDA port of ``examples/spreadfgl_multiserver.py``. Three edge
servers on a ring (the paper's testbed topology), Eq. 16 neighbor
aggregation + Eq. 15 trace regularizer, compared against the centralized
FedGL, the decentralized gossip variant (``spreadfgl_gossip``, cross-server
exchange every ``--gossip-every`` rounds only), and the three baselines of
Sec. IV-A on the same partition.

The reference's ``--impl`` (reference | pallas | pallas_interpret) gives way
to ``--device``: the port has no ``kernel_impl`` knob, the tensors' device
decides. On the card (``cuda``, the default; it raises without one) every
method's classifier aggregation and imputation similarity top-k launch the
CUDA kernels ``sage_aggregate`` and ``sim_topk``; on the CPU their plain
PyTorch versions run.

The heterogeneity axis rides along: ``--partitioner dirichlet --alpha 0.1``
skews the client split non-IID and ``--participation 0.5`` lets only half
the clients aggregate per round.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

from repro_torch.core import registry
from repro_torch.core.fedgl import resolve_device
from repro_torch.core.partition import (PARTITIONERS, label_skew_entropy, make_partitioner,
                                        partition_graph)
from repro_torch.core.types import FGLConfig
from repro_torch.data.synthetic_graphs import DATASETS, make_sbm_graph
from repro_torch.launch.mesh import make_edge_mesh


def data(scale: float = 0.15, partitioner: str = "label_prop", alpha: float = 1.0):
    """The Citeseer stand-in split over 6 clients: (graph, batch, assign)."""
    graph = make_sbm_graph(DATASETS["citeseer"], scale=scale, seed=1, feature_noise=3.0,
                           signal_ratio=0.5)
    part = make_partitioner(partitioner, alpha=alpha)
    batch, assign = partition_graph(graph, num_clients=6, aug_max=12, seed=0,
                                    partitioner=part)
    return graph, batch, assign


def run(*, scale: float = 0.15, rounds: int = 12, gossip_every: int = 4,
        partitioner: str = "label_prop", alpha: float = 1.0, participation: float = 1.0,
        device: str = "cuda") -> Dict[str, Any]:
    """Fit the six methods ``rounds`` rounds each on one partition; returns
    the label entropies (``entropy``) and each method's history by its row
    name (``methods``)."""
    dev = resolve_device(device)
    graph, batch, assign = data(scale, partitioner, alpha)
    ent = label_skew_entropy(assign, graph.y, 6)
    print(f"partitioner={partitioner} rho={participation} "
          f"mean client label entropy={ent.mean():.3f} nats")
    cfg = FGLConfig(hidden_dim=32, local_rounds=4, imputation_interval=2, top_k_links=4,
                    aug_max=12, participation=participation)

    # The [N] server axis splits over the ranks of a process group (a size-1
    # mesh in a single process: identical numbers, no sharding). Every
    # method is a registered strategy composition.
    mesh = make_edge_mesh(3)
    methods = {
        "LocalFGL": registry.build("local", cfg, batch, device=dev),
        "FedAvg-fusion": registry.build("fedavg_fusion", cfg, batch, device=dev),
        "FedSage+": registry.build("fedsage_plus", cfg, batch, device=dev),
        "FedGL": registry.build("FedGL", cfg, batch, device=dev),
        "SpreadFGL (3 servers, ring)": registry.build(
            "SpreadFGL", cfg, batch, num_servers=3, edge_mesh=mesh, device=dev),
        f"SpreadFGL-gossip (K={gossip_every})": registry.build(
            "spreadfgl_gossip", cfg, batch, num_servers=3, gossip_every=gossip_every,
            edge_mesh=mesh, device=dev),
    }
    print(f"{'method':30s} {'best ACC':>9s} {'best F1':>9s} {'final loss':>11s}")
    hists = {}
    for name, tr in methods.items():
        _, hist = tr.fit(batch, rounds=rounds)
        hists[name] = hist
        print(f"{name:30s} {max(hist['acc']):9.3f} {max(hist['f1']):9.3f} "
              f"{hist['loss'][-1]:11.4f}")
    return {"graph": graph, "assign": assign, "entropy": ent, "methods": hists}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda launches the CUDA kernels, cpu runs their plain versions")
    ap.add_argument("--gossip-every", type=int, default=4,
                    help="cross-server exchange interval of the gossip row")
    ap.add_argument("--partitioner", default="label_prop",
                    choices=tuple(sorted(PARTITIONERS)),
                    help="client-split strategy (heterogeneity axis)")
    ap.add_argument("--alpha", type=float, default=1.0,
                    help="Dirichlet concentration (--partitioner dirichlet)")
    ap.add_argument("--participation", type=float, default=1.0,
                    help="per-round participating-client fraction rho")
    args = ap.parse_args(argv)
    return run(scale=0.15, rounds=12, gossip_every=args.gossip_every,
               partitioner=args.partitioner, alpha=args.alpha,
               participation=args.participation, device=args.device)


if __name__ == "__main__":
    main()
