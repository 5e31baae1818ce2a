"""Instance fleets on one device.

On one card the paper's share-nothing instances are a leading batch axis
``[I, ...]`` on every tensor of a ``HierAssoc``; ``core/stream.py`` runs
the fleet.  The sharded ingest / query functions of the JAX package (mesh
fanout and semiring gathers across devices) are not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import hier
from repro_torch.core import semiring as sr_mod
from repro_torch.core.hier import HierAssoc
from repro_torch.core.semiring import Semiring


def create_instances(n_instances: int, cuts: Tuple[int, ...], block_size: int,
                     dtype=torch.float32, sr: Semiring = sr_mod.PLUS_TIMES,
                     device=None) -> HierAssoc:
    """Instance-batched hierarchy (leading axis = instance), on the CUDA
    device unless ``device`` says otherwise."""
    one = hier.create(cuts, block_size, dtype, sr, device=device)
    return hier.map_state(
        lambda x: x.expand((n_instances,) + x.shape).contiguous(), one)
