"""The port's mesh: a fleet of ranks over ``torch.distributed``.

The JAX package lays its instances over a device mesh
(``launch/mesh.py::make_test_mesh``) and ``shard_map``s over its
``"data"`` axis.  The port's counterpart is a process group: a
``FleetMesh`` is the one-axis mesh ``(("data", P),)`` of P ranks, each
rank with its own device, and rank r holds the r-th block of every
instance-sharded array (``core/distributed.py``).

The backend is the caller's choice; nothing switches it on its own:

* ``"nccl"`` puts one rank on each card (local rank r on ``cuda:r``) and
  refuses more ranks than cards;
* ``"gloo"`` lets ranks share a card (all on the one the caller names,
  ``cuda:0`` by default) or run on the CPU.  Several host processes
  feeding one H100 is the paper's node layout (~31 processes a node).
  Gloo's collectives on CUDA tensors are ``broadcast``, ``all_reduce``
  and ``barrier`` only; the fleet functions use ``all_reduce`` alone.

Two ways to start a fleet:

    torchrun --nproc-per-node P script.py   # script: make_fleet_mesh("gloo")
    spawn_fleet(fn, P, "gloo", "cuda", tmpdir)   # fn(mesh, *args) on P ranks

``spawn_fleet`` is the port's stand-in for the JAX package's forced host
device count: it starts the ranks with the spawn start method (never
fork: the parent may hold a CUDA context) and a ``file://`` rendezvous
in a fresh directory, so concurrent fleets never share a port.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
from typing import Any, Tuple

import torch

from repro_torch import resolve_device

BACKENDS = ("gloo", "nccl")
# a rank that waits longer than this in a collective fails instead of
# hanging the fleet
TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class FleetMesh:
    """One rank's view of the fleet: its process group, rank and size,
    its device and the mesh's one axis name."""
    group: Any
    rank: int
    size: int
    device: torch.device
    axis_names: Tuple[str, ...] = ("data",)


def _check_backend(backend: str, world_size: int) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl" and world_size > torch.cuda.device_count():
        raise ValueError(f"nccl runs one rank per card: {world_size} ranks, "
                         f"{torch.cuda.device_count()} cards (use gloo to "
                         f"share a card)")


def _rank_device(backend: str, device, local_rank: int) -> torch.device:
    if backend == "nccl":
        if device is not None and torch.device(device).type != "cuda":
            raise ValueError(f"nccl runs on CUDA devices, got {device}")
        dev = resolve_device(torch.device("cuda", local_rank))
    else:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def make_fleet_mesh(backend: str, device=None) -> FleetMesh:
    """This rank's ``FleetMesh``: from the default process group if one is
    initialized (it must use ``backend``), else from the ``torchrun``
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``).  The rank's device is CUDA unless ``device`` names
    the CPU (``resolve_device``); under nccl it is ``cuda:<LOCAL_RANK>``."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()}, "
                             f"not {backend}")
    else:
        _check_backend(backend, int(os.environ.get("LOCAL_WORLD_SIZE", 1)))
        dist.init_process_group(backend, init_method="env://",
                                timeout=TIMEOUT)
    rank, size = dist.get_rank(), dist.get_world_size()
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    return FleetMesh(group=dist.group.WORLD, rank=rank, size=size,
                     device=_rank_device(backend, device, local_rank))


def _rank_main(rank: int, fn, world_size: int, backend: str, device,
               run_dir: str, args: tuple) -> None:
    import torch.distributed as dist
    os.environ["LOCAL_RANK"] = str(rank)
    dist.init_process_group(backend,
                            init_method=f"file://{run_dir}/store",
                            rank=rank, world_size=world_size,
                            timeout=TIMEOUT)
    out = fn(make_fleet_mesh(backend, device), *args)
    dist.destroy_process_group()
    path = os.path.join(run_dir, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(path + ".tmp", path)


def spawn_fleet(fn, world_size: int, backend: str, device,
                rendezvous_dir: str, args: tuple = ()) -> list:
    """Run ``fn(mesh, *args)`` on ``world_size`` ranks and return their
    results in rank order.

    ``fn`` must be importable by name (a module-level function) and its
    result picklable (numpy arrays, numbers: no CUDA tensors).  Each call
    rendezvouses through a fresh directory under ``rendezvous_dir``, where
    the ranks also leave their results.  A rank that raises makes
    ``torch.multiprocessing.spawn`` stop the others and raise."""
    _check_backend(backend, world_size)
    run_dir = tempfile.mkdtemp(prefix="fleet-", dir=rendezvous_dir)
    torch.multiprocessing.spawn(
        _rank_main, args=(fn, world_size, backend, device, run_dir, args),
        nprocs=world_size, join=True)
    results = []
    for r in range(world_size):
        with open(os.path.join(run_dir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results
