"""Process groups, the two-axis mesh, and the collectives of the
distributed layer on `torch.distributed` (counterpart of
`slam1_tpu/parallel/mesh.py`).

One process (rank) is one device of the mesh. The mesh lays the world's
ranks out row-major on two axes:

  "batch" — data parallelism over frames (detection, matching and
            per-frame geometry are independent across frames);
  "lm"    — landmark / keyframe-block sharding of the backends
            (`dist_ba`, `dist_pgo`): camera-side reductions ride an
            all_reduce over this axis.

Rank r sits at batch index r // lm and lm index r % lm; each axis has a
process group per row of the other axis.

Backend rule (`choose_backend`, printed once by `init_multihost`): NCCL
when the ranks run on CUDA and every rank of a host has a card of its
own; gloo when ranks share a card (NCCL refuses two ranks on one
device) or run on the CPU. gloo takes CUDA tensors in all_reduce but
not in point-to-point sends, so `ring_shift` (the pose-graph halo)
copies its one buffer through host memory when the backend is gloo and
the tensor is on a card; every all_reduce goes to the backend as it is.

The distributed solvers capture their iterations as CUDA graphs,
collectives inside, only on a card under NCCL (`utils/graphs.graphed`
with the mesh).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import sys
from typing import Dict, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def local_rank(rank: int) -> int:
    """This process's index among the ranks of its host (torchrun's
    LOCAL_RANK; the global rank when no launcher says)."""
    v = _env_int("LOCAL_RANK")
    return rank if v is None else v


def choose_backend(device, local_world_size: int):
    """(backend, reason): "nccl" when the ranks run on CUDA and this
    host has a card for each of its `local_world_size` ranks, else
    "gloo"."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo", f"ranks on {dev.type}"
    cards = torch.cuda.device_count()
    if cards >= local_world_size:
        return "nccl", f"{local_world_size} ranks on {cards} cards"
    return "gloo", f"{local_world_size} ranks share {cards} card(s)"


def rank_device(device, rank: int) -> torch.device:
    """The device rank `rank` computes on: the CPU, or the card of its
    local index (modulo the cards there are)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return torch.device("cuda", local_rank(rank) % torch.cuda.device_count())


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, device="cuda",
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Bring up the default process group and return its backend.

    `coordinator` "host:port" becomes tcp://host:port; a URL
    ("tcp://...", "file://...") is used as it is; both need
    `num_processes` and `process_id`. With no coordinator, torchrun's
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) is used
    when it is set, else the process is a world of one on an in-process
    store. A group that is already up is kept (only its size is
    checked); any other failure raises."""
    if dist.is_initialized():
        backend = dist.get_backend()
    else:
        kw = {}
        if coordinator:
            if num_processes is None or process_id is None:
                raise ValueError("a coordinator needs num_processes and "
                                 "process_id")
            kw = dict(init_method=(coordinator if "://" in coordinator
                                   else f"tcp://{coordinator}"),
                      world_size=num_processes, rank=process_id)
            world, rank = num_processes, process_id
        elif _env_int("RANK") is not None:
            kw = dict(init_method="env://")
            world, rank = _env_int("WORLD_SIZE") or 1, _env_int("RANK")
        else:
            if num_processes not in (None, 1) or process_id not in (None, 0):
                raise ValueError("num_processes / process_id without a "
                                 "coordinator or torchrun's environment")
            kw = dict(store=dist.HashStore(), world_size=1, rank=0)
            world, rank = 1, 0
        local_world = _env_int("LOCAL_WORLD_SIZE") or world
        backend, why = choose_backend(device, local_world)
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, timeout=datetime.timedelta(seconds=timeout_s), **kw)
        print(f"torch.distributed: backend {backend} ({why}), world "
              f"{dist.get_world_size()}", file=sys.stderr, flush=True)
    if num_processes and dist.get_world_size() != num_processes:
        raise RuntimeError(
            f"multi-process init ineffective: world size "
            f"{dist.get_world_size()} != {num_processes}")
    return backend


@dataclasses.dataclass
class Mesh:
    """This rank's view of the (batch, lm) mesh. `comm` counts the bytes
    this rank hands to each kind of collective (reset it freely)."""
    shape: Dict[str, int]
    rank: int
    batch_index: int
    lm_index: int
    batch_group: object
    lm_group: object
    batch_ranks: tuple
    lm_ranks: tuple
    device: torch.device
    backend: str
    comm: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"all_reduce_bytes": 0, "all_reduce_calls": 0,
                                 "p2p_bytes": 0, "p2p_calls": 0})

    def group(self, axis: str):
        return {"batch": self.batch_group, "lm": self.lm_group}[axis]

    def index(self, axis: str) -> int:
        return {"batch": self.batch_index, "lm": self.lm_index}[axis]

    def ranks(self, axis: str) -> tuple:
        return {"batch": self.batch_ranks, "lm": self.lm_ranks}[axis]


def default_lm_axis(n: int) -> int:
    """Favour landmark sharding (BA is the communication-heavy stage):
    4 when it divides n, else 2, else 1."""
    for cand in (4, 2):
        if n % cand == 0 and n >= cand:
            return cand
    return 1


def make_mesh(n_devices: Optional[int] = None,
              lm_axis: Optional[int] = None, device="cuda") -> Mesh:
    """The (batch, lm) mesh over all ranks of the process group (a world
    of one is brought up when there is none). `n_devices`, when given,
    must be the world size: each rank is one device."""
    if not dist.is_initialized():
        init_multihost(device=device)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs {n} ranks; the "
                         f"world has {world}")
    lm = lm_axis or default_lm_axis(n)
    if n % lm:
        raise ValueError(f"lm axis {lm} does not divide {n} ranks")
    nb = n // lm
    groups = {}
    # Every rank creates every group, in the same order.
    for b in range(nb):
        ranks = tuple(b * lm + i for i in range(lm))
        groups[("lm", ranks)] = _group(ranks, world)
    for i in range(lm):
        ranks = tuple(b * lm + i for b in range(nb))
        groups[("batch", ranks)] = _group(ranks, world)
    bi, li = divmod(rank, lm)
    lm_ranks = tuple(bi * lm + i for i in range(lm))
    batch_ranks = tuple(b * lm + li for b in range(nb))
    return Mesh(shape={"batch": nb, "lm": lm}, rank=rank, batch_index=bi,
                lm_index=li, batch_group=groups[("batch", batch_ranks)],
                lm_group=groups[("lm", lm_ranks)], batch_ranks=batch_ranks,
                lm_ranks=lm_ranks, device=rank_device(device, rank),
                backend=dist.get_backend())


def _group(ranks, world):
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(list(ranks))


def _shard(mesh: Mesh, x, axis: str):
    n = mesh.shape[axis]
    if x.shape[0] % n:
        raise ValueError(f"leading axis {x.shape[0]} does not split over "
                         f"{n} ranks of axis {axis!r}")
    k = x.shape[0] // n
    i = mesh.index(axis)
    return x[i * k:(i + 1) * k].to(mesh.device)


def batch_shard(mesh: Mesh, x):
    """This rank's block of x's leading axis split over "batch" (the
    counterpart of `batch_sharding`), on the rank's device."""
    return _shard(mesh, x, "batch")


def lm_shard(mesh: Mesh, x):
    """This rank's block of x's leading axis split over "lm" (the
    counterpart of `lm_sharding`), on the rank's device."""
    return _shard(mesh, x, "lm")


def replicated(mesh: Mesh, x):
    """x, whole, on the rank's device (the counterpart of `replicated`:
    every rank holds the same value)."""
    return x.to(mesh.device)


def all_reduce(mesh: Mesh, x, axis: str = "lm"):
    """Sum x over the ranks of `axis` (in place; returns x)."""
    mesh.comm["all_reduce_bytes"] += x.numel() * x.element_size()
    mesh.comm["all_reduce_calls"] += 1
    dist.all_reduce(x, group=mesh.group(axis))
    return x


def gather_blocks(mesh: Mesh, block, axis: str = "lm"):
    """The whole array whose block along the leading axis this rank
    holds, on every rank of `axis`: an all_reduce of the blocks placed
    into zeros (exact: every other term of each sum is 0)."""
    n, i, k = mesh.shape[axis], mesh.index(axis), block.shape[0]
    full = block.new_zeros((n * k,) + tuple(block.shape[1:]))
    full[i * k:(i + 1) * k] = block
    return all_reduce(mesh, full, axis)


def ring_shift(mesh: Mesh, x, shift: int, axis: str = "lm"):
    """Send x to the rank `shift` places along the ring of `axis` and
    return what the rank `shift` places before sends (jax's ppermute on
    the ring i -> i + shift). Through host memory when the backend is
    gloo and x is on a card (gloo has no CUDA send)."""
    ranks = mesh.ranks(axis)
    n, i = len(ranks), mesh.index(axis)
    if n == 1:
        return x
    staged = mesh.backend == "gloo" and x.is_cuda
    src = x.detach().contiguous()
    if staged:
        src = src.cpu()
    buf = torch.empty_like(src)
    mesh.comm["p2p_bytes"] += src.numel() * src.element_size()
    mesh.comm["p2p_calls"] += 1
    ops = [dist.P2POp(dist.isend, src, ranks[(i + shift) % n]),
           dist.P2POp(dist.irecv, buf, ranks[(i - shift) % n])]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return buf.to(x.device) if staged else buf
