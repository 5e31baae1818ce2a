"""Instance fleets on one device.

On one card the paper's share-nothing instances are a leading batch axis
``[I, ...]`` on every tensor of a ``HierAssoc``; ``core/stream.py`` runs
the fleet.  ``instance_assignment`` is the rendezvous hash that places
instances on devices for an elastic restart.  The sharded ingest / query
functions of the JAX package (mesh fanout and semiring gathers across
devices) are not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import hier
from repro_torch.core import semiring as sr_mod
from repro_torch.core.hier import HierAssoc
from repro_torch.core.semiring import Semiring


def instance_assignment(n_instances: int, n_devices: int) -> torch.Tensor:
    """Rendezvous (highest-random-weight) assignment instance -> device,
    int32 [n_instances], bit-equal to the JAX package's.

    device(i) = argmax_d hash(i, d): stable across runs, and when the
    fleet grows from N to N+k devices only the instances whose new device
    wins move (~k/(N+k) in expectation).  The hash is uint32 arithmetic;
    torch's uint32 lacks it, so it runs in int64 with every product and
    xor-shift masked back to 32 bits (ties go to the lowest device, as
    ``jnp.argmax`` breaks them).
    """
    ids = torch.arange(n_instances, dtype=torch.int64)[:, None]
    devs = torch.arange(n_devices, dtype=torch.int64)[None, :]
    h = _mul32(ids, 2654435761) ^ _mul32(devs, 40503)
    h = h ^ (h >> 16)
    h = _mul32(h, 2246822519)
    h = h ^ (h >> 13)
    return torch.argmax(h, dim=1).to(torch.int32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32): by 16-bit halves
    of ``c``, so no product leaves int64's range."""
    m = 0xFFFFFFFF
    return ((x * (c & 0xFFFF)) + (((x * (c >> 16)) & 0xFFFF) << 16)) & m


def create_instances(n_instances: int, cuts: Tuple[int, ...], block_size: int,
                     dtype=torch.float32, sr: Semiring = sr_mod.PLUS_TIMES,
                     device=None) -> HierAssoc:
    """Instance-batched hierarchy (leading axis = instance), on the CUDA
    device unless ``device`` says otherwise."""
    one = hier.create(cuts, block_size, dtype, sr, device=device)
    return hier.map_state(
        lambda x: x.expand((n_instances,) + x.shape).contiguous(), one)
