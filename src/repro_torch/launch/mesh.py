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
  The fleet functions use ``all_reduce`` alone.  On CUDA tensors gloo
  takes the ``torch.distributed`` collectives, but the functional
  all-gather that DTensor's redistribution calls ends the process with a
  segmentation fault (torch 2.11 on an H100, four ranks on one card), so
  a DTensor step there needs nccl and one card a rank.

Two ways to start a fleet:

    torchrun --nproc-per-node P script.py   # script: make_fleet_mesh("gloo")
    spawn_fleet(fn, P, "gloo", "cuda", tmpdir)   # fn(mesh, *args) on P ranks

``spawn_fleet`` is the port's stand-in for the JAX package's forced host
device count: it starts the ranks with the spawn start method (never
fork: the parent may hold a CUDA context) and a ``file://`` rendezvous
in a fresh directory, so concurrent fleets never share a port.

The sharding layer (``distribution/sharding.py``) runs over a
``torch.distributed.device_mesh.DeviceMesh`` built on the initialized
process group, rank r at the r-th position of the mesh in row-major
order:

* ``make_test_mesh(shape=(2, 2), axes=("data", "model"))``: any shape
  whose size is the world size;
* ``make_production_mesh()``: ``(16, 16)`` over ``("data", "model")``,
  256 ranks; ``multi_pod=True``: ``(2, 16, 16)`` over ``("pod", "data",
  "model")``, 512 ranks.  Any other world size raises.  ``data`` is the
  FSDP axis, ``model`` the TP/EP axis, ``pod`` pure DP whose only
  traffic is the per-step gradient all-reduce.  Building one in one
  process needs a fake process group (``FakeStore``, backend
  ``"fake"``), which the caller starts: it gives shapes, not execution;
* ``fleet_device_mesh(fleet)``: the one-axis ``("data",)`` mesh of a
  ``FleetMesh``'s ranks, in the same order, so a ``Shard(0)`` placement
  gives rank r the instances ``core.distributed.local_block`` gives it.

Each is on the card unless the caller names the CPU (``device``).
"""
from __future__ import annotations

import dataclasses
import datetime
import math
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


PRODUCTION_MESHES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the process group
    (initialized by the caller, or from the ``torchrun`` environment),
    on this rank's current CUDA device unless ``device`` names the CPU;
    raises without a card."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if dev.type == "cuda":
        # a CUDA context on the device the rank chose (gloo ranks share
        # cuda:0): init_device_mesh would pick LOCAL_RANK's card otherwise
        torch.cuda.init()
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The ``(16, 16)`` ``("data", "model")`` mesh of 256 ranks, or with
    ``multi_pod`` the ``(2, 16, 16)`` ``("pod", "data", "model")`` mesh of
    512; raises, naming the shape and the world size, on any other world
    size."""
    import torch.distributed as dist
    device = resolve_device(device)
    shape, axes = PRODUCTION_MESHES[bool(multi_pod)]
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != need:
        raise RuntimeError(
            f"production mesh {shape} over {axes} needs a world of {need} "
            f"ranks, the process group has "
            f"{'none' if world is None else world}")
    return make_test_mesh(shape, axes, device)


def fleet_device_mesh(fleet: FleetMesh):
    """The one-axis ``DeviceMesh`` of ``fleet``'s ranks (rank r at
    position r, the axis named as the fleet's), on the fleet's device."""
    return make_test_mesh((fleet.size,), fleet.axis_names, fleet.device)
