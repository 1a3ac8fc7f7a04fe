"""H100 dry-run: the cost of every (arch x input shape x mesh), with no card.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each
combination for 512 placeholder TPU devices and reads XLA's HLO. Here each
configuration is built at full size on PyTorch's ``meta`` device (shapes,
no memory), laid over an H100 mesh by the reference's sharding rules, and
one device's step of the port's own code is run and counted
(``roofline.analysis``): compute, memory and collective seconds from
``roofline.hw``'s H100 constants, and the memory per device. It builds only
``meta`` tensors and raises on any other device, so it needs no card and
never computes on the CPU.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh both
  python -m repro_torch.launch.dryrun --all --mesh both      # 80 records

``--attention-impl``: "" charges the attention kernel its own work;
``reference`` runs the plain ``ref.flash_attention`` on meta, with its S x S
temporaries; ``chunked`` runs ``attention._sdpa_chunked``. ``--no-scan`` is
accepted and changes nothing: the port's layers are always separate modules
(the record says so). Records go to ``--out`` as JSON, one file each.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
from typing import Optional, Sequence

from repro_torch import configs
from repro_torch.configs import INPUT_SHAPES, InputShape, get_config, shape_applicable
from repro_torch.kernels import ref
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import attention as A
from repro_torch.models.config import ModelConfig
from repro_torch.roofline import analysis

ATTENTION_IMPLS = {
    "": None,
    "reference": lambda q, k, v, *, window: ref.flash_attention(q, k, v, window=window),
    "chunked": lambda q, k, v, *, window: A._sdpa_chunked(q, k, v, causal=True,
                                                          window=window or 0),
}


def run_one(cfg: ModelConfig, shape: InputShape, mesh, *, microbatch: int = 1,
            attention_impl: str = "", arch: Optional[str] = None, tag: str = "",
            no_scan: bool = False) -> dict:
    """One record: ``cfg`` at ``shape`` on ``mesh`` (any ``ProductionMesh``,
    the one-card mesh too)."""
    t0 = time.perf_counter()
    rec = analysis.analyze(cfg, shape, mesh, arch=arch, microbatch=microbatch,
                           attention=ATTENTION_IMPLS[attention_impl],
                           extra={"microbatch": microbatch, "tag": tag,
                                  "seq_parallel": cfg.seq_parallel_activations,
                                  "attention_impl": attention_impl or "kernel",
                                  "no_scan": "accepted; the port's layers are separate "
                                             "modules either way" if no_scan else False})
    out = {"status": "ok", **rec.to_json()}
    out["extra"]["count_s"] = round(time.perf_counter() - t0, 2)
    return out


def _write(rec: dict, out_dir: Optional[str], tag: str = "") -> None:
    if not out_dir:
        return
    p = pathlib.Path(out_dir)
    p.mkdir(parents=True, exist_ok=True)
    suffix = f"_{tag}" if tag else ""
    (p / f"{rec['arch']}_{rec['shape']}_{rec['mesh']}{suffix}.json").write_text(
        json.dumps(rec, indent=1))


def _one(arch: str, shape_name: str, mesh_name: str, args) -> dict:
    overrides = {"seq_parallel_activations": True} if args.seq_parallel else {}
    cfg = get_config(arch, "full", **overrides)
    shape = INPUT_SHAPES[shape_name]
    if not shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "skipped",
                "reason": "long_500k requires sub-quadratic attention"}
    rec = run_one(cfg, shape, make_production_mesh(multi_pod=mesh_name == "multi"),
                  microbatch=args.microbatch, attention_impl=args.attention_impl, arch=arch,
                  tag=args.tag, no_scan=args.no_scan)
    print(f"[dryrun] {arch} x {shape_name} x {mesh_name}"
          + (f" [{args.tag}]" if args.tag else "")
          + f": compute={rec['compute_s']:.4f}s memory={rec['memory_s']:.4f}s "
          f"collective={rec['collective_s']:.4f}s "
          f"({', '.join(f'{a} {s:.4f}' for a, s in rec['axis_seconds'].items())}) "
          f"dominant={rec['dominant']} memory/device={rec['memory_per_device'] / 1e9:.2f} GB "
          f"(counted in {rec['extra']['count_s']:.1f} s)")
    return rec


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=configs.ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(INPUT_SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="single")
    ap.add_argument("--all", action="store_true", help="every (arch x shape) combination")
    ap.add_argument("--out", default="build/dryrun_h100")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--microbatch", type=int, default=1,
                    help="grad-accumulation chunks")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="sequence-parallel activations (all-gather + reduce-scatter)")
    ap.add_argument("--attention-impl", default="", choices=tuple(ATTENTION_IMPLS),
                    help="attention on meta: the kernel's charge, plain, or chunked")
    ap.add_argument("--no-scan", action="store_true",
                    help="accepted for the reference's CLI; the port never scans")
    ap.add_argument("--tag", default="", help="suffix of the output records")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> list:
    args = _parser().parse_args(argv)
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    if args.all:
        combos = [(a, s) for a in configs.ARCH_IDS for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        raise SystemExit("--arch and --shape are required unless --all")
    records, failures = [], []
    for arch, shape in combos:
        for mesh_name in meshes:
            suffix = f"_{args.tag}" if args.tag else ""
            f = pathlib.Path(args.out) / f"{arch}_{shape}_{mesh_name}{suffix}.json"
            if args.skip_existing and f.exists() and json.loads(f.read_text()).get(
                    "status") in ("ok", "skipped"):
                print(f"[dryrun] skip existing {f.name}")
                continue
            try:
                rec = _one(arch, shape, mesh_name, args)
            except Exception as e:  # noqa: BLE001 - a record per failure, the run goes on
                print(f"[dryrun] FAILED {arch} x {shape} x {mesh_name}: {e!r}")
                rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "status": "failed",
                       "error": repr(e)}
                failures.append(rec)
            _write(rec, args.out, args.tag)
            records.append(rec)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: "
                         f"{[(r['arch'], r['shape'], r['mesh']) for r in failures]}")
    return records


if __name__ == "__main__":
    main()
