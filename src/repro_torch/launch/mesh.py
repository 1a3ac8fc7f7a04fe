"""Device meshes of the port: ``torch.distributed`` process groups.

Counterpart of ``repro.launch.mesh``. Where the reference places an axis on
a JAX device mesh and runs SPMD code under ``shard_map``, the port runs one
process per mesh device, joined by a process group; a :class:`Mesh` is this
process's view of one 1-D axis: the group, its size, this rank's coordinate
on it, the axis name and the device it computes on.

- :func:`make_edge_mesh` carries SpreadFGL's stacked ``[N]`` edge-server
  axis: the largest divisor of N that fits the world. A rank outside that
  mesh gets a size-1 mesh and runs the unsharded engine, so every rank ends
  each round with the same state.
- :func:`make_sim_mesh` carries the candidate axis of the imputation
  similarity search (``core/ring_topk.py``); no divisibility rule.
- :func:`make_host_mesh` carries the ``pod`` axis of spread LM training.

With no process group initialised every mesh has size 1, the degenerate mesh
the reference has on a 1-device host.

:func:`make_production_mesh` and :func:`make_card_mesh` describe the meshes
the dry-run (``launch.dryrun``) lays a model over: a frozen
:class:`ProductionMesh` of axis sizes and the link each axis runs over, not a
process group.

:func:`spawn` starts ``world_size`` ranks of a function, the counterpart of
the reference's ``--devices N`` host emulation: rank r computes on
``cuda:(r % card count)``, over ``nccl`` when each rank has a card of its
own and over ``gloo`` otherwise (several ranks on one card, or the CPU).
Under ``gloo`` a CUDA tensor sent to another rank goes through the host:
:func:`_wire` copies it out and :func:`_unwire` back, the one place that
does.
"""
from __future__ import annotations

import dataclasses
import math
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.roofline import hw


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One mesh axis as this process sees it."""

    group: Any              # the process group, or None for a size-1 mesh
    size: int
    rank: int               # this process's coordinate on the axis
    axis_name: str
    device: torch.device    # where this rank computes
    ranks: tuple = (0,)     # the global rank of each coordinate

    def peer(self, shift: int) -> int:
        """The global rank ``shift`` coordinates along the ring from this one."""
        return self.ranks[(self.rank + shift) % self.size]


@dataclasses.dataclass(frozen=True, eq=False)
class ProductionMesh:
    """Axis sizes (``shape``, as ``sharding.rules`` reads a mesh) and the
    link each axis's collectives run over: ``(name, bytes/s each way)``."""

    name: str
    shape: Dict[str, int]
    links: Dict[str, Tuple[str, float]]

    @property
    def chips(self) -> int:
        return math.prod(self.shape.values())


_NVLINK = ("NVLink", hw.NVLINK_BW)
_IB = ("InfiniBand NDR", hw.IB_BW)


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    """The H100 fleet: 256 cards as ``(data 32, model 8)``, or 512 as
    ``(pod 2, data 32, model 8)``; the ``pod`` axis carries SpreadFGL's
    edge-server topology (``core/gossip.py``).

    ``model`` is the 8 cards of one HGX node, joined by NVLink; ``data`` and
    ``pod`` cross nodes over InfiniBand (one NDR adapter a card). The
    reference's TPU layout, ``(data 16, model 16)``, would stretch tensor
    parallelism over two nodes: its per-layer all-reduces would then run at
    InfiniBand's 50 GB/s instead of NVLink's 450.
    """
    model = hw.GPUS_PER_NODE
    data = hw.CHIPS_SINGLE_POD // model
    if multi_pod:
        pods = hw.CHIPS_MULTI_POD // hw.CHIPS_SINGLE_POD
        return ProductionMesh("multi", {"pod": pods, "data": data, "model": model},
                              {"pod": _IB, "data": _IB, "model": _NVLINK})
    return ProductionMesh("single", {"data": data, "model": model},
                          {"data": _IB, "model": _NVLINK})


def make_card_mesh() -> ProductionMesh:
    """One card: every axis of size 1, so nothing is sharded or exchanged."""
    return ProductionMesh("card", {"data": 1, "model": 1}, {"data": _IB, "model": _NVLINK})


def _device() -> torch.device:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(size: int, axis: str) -> Mesh:
    """The mesh of global ranks 0..size-1; a size-1 mesh on other ranks.
    Every rank of the world must call it (``new_group`` is collective)."""
    dev = _device()
    if size <= 1 or not dist.is_initialized():
        return Mesh(None, 1, 0, axis, dev)
    ranks = tuple(range(size))
    group = dist.group.WORLD if size == _world() else dist.new_group(list(ranks))
    me = dist.get_rank()
    if me not in ranks:
        return Mesh(None, 1, 0, axis, dev)
    return Mesh(group, size, me, axis, dev, ranks)


def make_edge_mesh(num_servers: int, *, devices: int = 0) -> Mesh:
    """1-D mesh carrying SpreadFGL's stacked [N] edge-server axis: the
    largest divisor of ``num_servers`` that fits ``devices`` ranks (default:
    the world), so the server axis always splits evenly."""
    n_dev = min(devices or _world(), _world())
    size = max(d for d in range(1, min(num_servers, n_dev) + 1) if num_servers % d == 0)
    return _mesh(size, "edge")


def make_sim_mesh(*, devices: int = 0) -> Mesh:
    """1-D mesh carrying the candidate axis of the imputation similarity
    search over the first ``devices`` ranks (default: the world); the ring
    pads the axis to a multiple of its size, so no divisibility rule."""
    return _mesh(min(devices or _world(), _world()), "sim")


def make_host_mesh(*, pod: int = 0) -> Mesh:
    """The ``pod`` axis of spread LM training over the first ``pod`` ranks
    (default: the world)."""
    return _mesh(min(pod or _world(), _world()), "pod")


# ---------------------------------------------------------------------------
# Collectives over a mesh.
# ---------------------------------------------------------------------------

def _wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backend can send it: contiguous, and on the host under
    gloo (which moves only CPU tensors between processes)."""
    if t.is_cuda and dist.get_backend(mesh.group) == "gloo":
        return t.detach().to("cpu").contiguous()
    return t.detach().contiguous()


def _unwire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.to(like.device)


def shift(mesh: Mesh, tensors: Sequence[torch.Tensor], by: int = 1) -> List[torch.Tensor]:
    """Send each tensor ``by`` coordinates along the ring and receive the
    ones sent from ``by`` coordinates back, in one ``batch_isend_irecv``
    (the port's ``ppermute`` of the reference's ring schedules)."""
    if mesh.size == 1:
        return list(tensors)
    out, ops = [], []
    for t in tensors:
        w = _wire(mesh, t)
        r = torch.empty_like(w)
        ops.append(dist.P2POp(dist.isend, w, mesh.peer(by), mesh.group))
        ops.append(dist.P2POp(dist.irecv, r, mesh.peer(-by), mesh.group))
        out.append((r, t))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [_unwire(r, t) for r, t in out]


def all_gather(mesh: Mesh, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in mesh order."""
    if mesh.size == 1:
        return t
    w = _wire(mesh, t)
    parts = [torch.empty_like(w) for _ in range(mesh.size)]
    dist.all_gather(parts, w, group=mesh.group)
    return _unwire(torch.cat(parts, dim), t)


def all_gather_tree(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """:func:`all_gather` along dim 0 of many tensors, one collective per
    dtype: each rank's tensors of a dtype go flat into one buffer."""
    if mesh.size == 1:
        return list(tensors)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        gathered = all_gather(mesh, flat[None], 0)              # [size, total]
        at = 0
        for i in idx:
            t = tensors[i]
            n = t.numel()
            out[i] = gathered[:, at:at + n].reshape((mesh.size * t.shape[0],) + t.shape[1:])
            at += n
    return out


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``t``."""
    if mesh.size == 1:
        return t
    w = _wire(mesh, t).clone()
    dist.all_reduce(w, group=mesh.group)
    return _unwire(w, t)


# ---------------------------------------------------------------------------
# Starting ranks.
# ---------------------------------------------------------------------------

def _backend(device: str, world_size: int) -> str:
    """Pick this rank's card (rank % card count) and the backend: nccl when
    each rank has a card of its own, else gloo."""
    if device != "cuda":
        return "gloo"
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("a CUDA mesh needs a CUDA device; pass device='cpu' to run "
                           "the ranks on the CPU")
    rank = dist.get_rank() if dist.is_initialized() else int(os.environ.get("RANK", 0))
    torch.cuda.set_device(rank % cards)
    torch.cuda.init()
    return "nccl" if cards >= world_size else "gloo"


def init_from_env(device: str = "cuda") -> bool:
    """Join the process group a launcher such as ``torchrun`` describes in
    the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``PORT``);
    False, and nothing done, when it describes none or one is joined."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dist.is_initialized() or world <= 1 or "RANK" not in os.environ:
        return False
    dist.init_process_group(_backend(device, world), init_method="env://",
                            world_size=world, rank=int(os.environ["RANK"]))
    return True

def _rank_entry(rank: int, fn: Callable, world_size: int, device: str, init: str,
                out_dir: str, args: tuple, kwargs: dict) -> None:
    os.environ["RANK"] = str(rank)
    dist.init_process_group(_backend(device, world_size), init_method=init,
                            world_size=world_size, rank=rank)
    try:
        result = fn(*args, **kwargs)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, device: str = "cuda", *, args: tuple = (),
          kwargs: Optional[dict] = None, timeout: Optional[float] = None) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` on ``world_size`` new ranks joined by a
    process group, and return each rank's result (picklable) in rank order.

    Start method ``spawn``, so a parent that already holds CUDA can start
    them; build the kernels before (``kernels.build.load``), so the ranks
    load the library rather than each compiling it. The rendezvous is a
    ``file://`` in a temporary directory, so no port is fixed. Rank r
    computes on ``cuda:(r % card count)`` (``device="cuda"``) or on the CPU;
    the backend is ``nccl`` when each rank has a card of its own, otherwise
    ``gloo``. A rank that fails fails the call. With ``timeout``
    (seconds), the ranks still running then are killed and the call raises
    ``TimeoutError``.
    """
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="repro-torch-mesh-")
    try:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        ranks = mp.spawn(_rank_entry, args=(fn, world_size, device, init, tmp, args,
                                            kwargs or {}), nprocs=world_size, join=False)
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ranks.join(None if deadline is None
                             else max(deadline - time.monotonic(), 0.0)):
            if deadline is not None and time.monotonic() >= deadline:
                for proc in ranks.processes:
                    proc.kill()
                    proc.join()
                raise TimeoutError(f"mesh.spawn: {world_size} ranks of {fn.__name__} still "
                                   f"running after {timeout} s; killed")
        results = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def describe(mesh: Mesh) -> str:
    """Backend, world size and device, as the launchers' first line prints them."""
    backend = dist.get_backend() if dist.is_initialized() else "none"
    return (f"backend {backend}, world size {_world()}, device {mesh.device}, "
            f"{mesh.axis_name} mesh size {mesh.size}")

