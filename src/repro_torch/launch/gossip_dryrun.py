"""Cross-pod aggregation dry-run: SpreadFGL's ring gossip (Eq. 16) against an all-reduce.

Counterpart of ``repro.launch.gossip_dryrun``. For one architecture on the
multi-pod H100 mesh (``launch.mesh.make_production_mesh(multi_pod=True)``)
it gives the bytes each device moves across pods:

  allreduce : one ``core.gossip.all_average`` over ``pod`` (the FedAvg
              analogue: an f32 all-reduce of the parameters every step);
  spread    : one ``core.gossip.ring_gossip`` application (each leaf sent to
              both ring neighbours in its own dtype), every K steps.

Both are sized from that device's local parameter shards (``sharding.specs``:
the full config's leaves laid out by the sharding rules) through the byte
functions of ``core.gossip``, and timed over the ``pod`` axis's link
(InfiniBand NDR, ``roofline.hw``). Nothing is allocated and no card is used.

  PYTHONPATH=src python -m repro_torch.launch.gossip_dryrun --arch qwen3-4b -K 8
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
from typing import Optional, Sequence

import torch

from repro_torch import configs
from repro_torch.core import gossip
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding import rules, specs


def local_param_bytes(cfg, mesh) -> dict:
    """One device's parameter shards: bytes in their own dtypes and in f32."""
    shapes = specs.param_shapes(cfg)
    spec = specs.param_specs(cfg, mesh)
    own = f32 = 0
    for name, (shape, dtype) in shapes.items():
        n = math.prod(rules.local_shape(shape, spec[name], mesh))
        own += n * torch.empty((), dtype=dtype).element_size()
        f32 += n * 4
    return {"own": own, "f32": f32}


def run(arch: str, every: int) -> dict:
    cfg = configs.get_config(arch, "full")
    mesh = make_production_mesh(multi_pod=True)
    pods = mesh.shape["pod"]
    link, bw = mesh.links["pod"]
    shards = local_param_bytes(cfg, mesh)
    ar = gossip.allreduce_bytes_per_round(shards["f32"], pods)
    sp = gossip.ring_gossip_bytes_per_round(shards["own"])
    ratio = gossip.gossip_allreduce_ratio(ar, sp, every=every)
    return {"arch": arch, "K": every, "mesh": dict(mesh.shape), "link": link,
            "local_param_bytes": shards["own"], "allreduce_bytes": ar,
            "spread_bytes_per_application": sp, "spread_bytes_per_step": sp / every,
            "ratio": ratio, "allreduce_s": ar / bw, "spread_s_per_step": sp / every / bw}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=configs.ARCH_IDS, default="qwen3-4b")
    ap.add_argument("-K", "--gossip-every", type=int, default=8)
    ap.add_argument("--out", default="build/dryrun_h100")
    args = ap.parse_args(argv)
    rec = run(args.arch, args.gossip_every)
    print(f"[gossip-dryrun] {args.arch} on {rec['mesh']}, per device across pods over "
          f"{rec['link']}: allreduce={rec['allreduce_bytes'] / 1e9:.3f} GB "
          f"({rec['allreduce_s'] * 1e3:.2f} ms) spread(K={args.gossip_every})="
          f"{rec['spread_bytes_per_step'] / 1e9:.3f} GB/step "
          f"({rec['spread_s_per_step'] * 1e3:.2f} ms) ratio={rec['ratio']:.3f}")
    if args.out:
        p = pathlib.Path(args.out)
        p.mkdir(parents=True, exist_ok=True)
        (p / f"gossip_{args.arch}_K{args.gossip_every}.json").write_text(
            json.dumps(rec, indent=1))
    return rec


if __name__ == "__main__":
    main()
