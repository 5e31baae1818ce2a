"""Hierarchical sparse-update accumulator — the port of
``repro/optim/sparse_update.py``: the paper's technique as an optimizer
feature.

Any row-sparse gradient stream (embedding tables) can be routed through a
``HierVec`` accumulator: per-step updates are block-added into the small
fast layer; the large master array is only touched when the spill cascade
reaches it.

API:
    acc   = SparseAccumulator.create(cuts, block, dim, device=...)
    acc   = acc.add(keys, vals [, mask])          # fast-layer block update
    acc, table = acc.apply_if_pressured(table, scale)   # cascade-driven
    acc, table = acc.drain(table, scale)                # forced full apply

The table is updated in place and returned (``core/vassoc.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import vassoc


@dataclasses.dataclass(frozen=True)
class SparseAccumulator:
    hier: vassoc.HierVec

    @classmethod
    def create(cls, cuts: Tuple[int, ...], block_size: int, dim: int,
               dtype=torch.float32, device=None) -> "SparseAccumulator":
        return cls(hier=vassoc.create(cuts, block_size, dim, dtype, device))

    def add(self, keys: torch.Tensor, vals: torch.Tensor,
            mask: torch.Tensor | None = None) -> "SparseAccumulator":
        return SparseAccumulator(vassoc.update(self.hier, keys, vals, mask))

    def pending(self) -> torch.Tensor:
        return torch.sum(self.hier.nnz_per_layer(), dtype=torch.int32)

    def pressured(self) -> torch.Tensor:
        return self.hier.layers[-1].nnz > self.hier.cuts[-1]

    def apply_if_pressured(self, table: torch.Tensor,
                           scale: float | torch.Tensor = 1.0
                           ) -> Tuple["SparseAccumulator", torch.Tensor]:
        if vassoc.host_flag(self.pressured()):
            return self.drain(table, scale)
        return self, table

    def drain(self, table: torch.Tensor, scale: float | torch.Tensor = 1.0
              ) -> Tuple["SparseAccumulator", torch.Tensor]:
        hier, table = vassoc.drain_to_table(self.hier, table, scale)
        return SparseAccumulator(hier), table

    def snapshot(self) -> vassoc.VecSegment:
        """Canonical merged view of all pending mass (query path)."""
        return vassoc.query_all(self.hier)
