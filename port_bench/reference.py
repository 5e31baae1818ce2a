"""The plain reference of a D4M deployment: exact sums by key of the
generated update stream, worked out again from the stream alone.

For one instance's stream of ``T`` blocks, every update's key (row, col)
is packed with its block index into one int64 ``(row << scale | col) <<
bits | block`` and the updates are sorted by it once: a key's updates then
lie together in block order, so

- the sum of a key's values over the first ``b`` blocks (what a point
  query served after ``b`` blocks must return) is a difference of two
  prefix sums found by binary search, and
- the contents after ``b`` blocks (every key with its sum, what the
  hierarchy's layers hold together) are the runs of the prefix's keys.

Values are whole numbers, summed in float64, so every sum is exact; the
comparison that decides ``correct`` is exact too.  Plain PyTorch on
whatever device the stream is on.  Nothing here imports the program.
"""
from __future__ import annotations

import torch


def pack(rows: torch.Tensor, cols: torch.Tensor, scale: int) -> torch.Tensor:
    """One int64 key per (row, col) in [0, 2**scale)**2, ordered as the
    pair."""
    return (rows.to(torch.int64) << scale) | cols.to(torch.int64)


class PrefixSums:
    """One instance's stream ``[T, B]`` sorted by (key, block)."""

    def __init__(self, rows, cols, vals, scale: int):
        T, B = rows.shape
        self.bits = max(int(T).bit_length(), 1)
        dev = rows.device
        block = torch.arange(T, device=dev, dtype=torch.int64) \
            .repeat_interleave(B)
        comp = (pack(rows.reshape(-1), cols.reshape(-1), scale)
                << self.bits) | block
        self.comp, order = torch.sort(comp)
        self.vals = vals.reshape(-1)[order].to(torch.float64)
        self.csum = torch.cat([torch.zeros(1, dtype=torch.float64,
                                           device=dev),
                               torch.cumsum(self.vals, 0)])

    def answers(self, keys: torch.Tensor, blocks: torch.Tensor
                ) -> torch.Tensor:
        """Sum of each packed key's values over blocks ``< blocks`` (one
        block count per key); 0 where the key is absent."""
        base = keys.to(torch.int64) << self.bits
        lo = torch.searchsorted(self.comp, base)
        hi = torch.searchsorted(self.comp, base | blocks.to(torch.int64))
        return self.csum[hi] - self.csum[lo]

    def contents(self, b: int):
        """(sorted unique packed keys, float64 sums) of the first ``b``
        blocks."""
        live = (self.comp & ((1 << self.bits) - 1)) < b
        return sums_by_key(self.comp[live] >> self.bits, self.vals[live],
                           presorted=True)


def sums_by_key(keys: torch.Tensor, vals: torch.Tensor,
                presorted: bool = False):
    """(sorted unique keys, float64 sum of each key's values)."""
    if not presorted:
        keys, order = torch.sort(keys)
        vals = vals[order]
    uniq, counts = torch.unique_consecutive(keys, return_counts=True)
    ends = torch.cumsum(counts, 0)
    csum = torch.cat([torch.zeros(1, dtype=torch.float64, device=keys.device),
                      torch.cumsum(vals.to(torch.float64), 0)])
    return uniq, csum[ends] - csum[ends - counts]


def mismatches(keys_a, sums_a, keys_b, sums_b) -> int:
    """The number of keys whose sums differ, a key held by one side only
    counting as a difference."""
    keys = torch.cat([keys_a, keys_b])
    if keys.numel() == 0:
        return 0
    uniq, inv = torch.unique(keys, return_inverse=True)
    a = torch.zeros(uniq.numel(), dtype=torch.float64, device=keys.device)
    b = torch.zeros_like(a)
    a.index_add_(0, inv[:keys_a.numel()], sums_a.to(torch.float64))
    b.index_add_(0, inv[keys_a.numel():], sums_b.to(torch.float64))
    present_a = torch.zeros(uniq.numel(), dtype=torch.bool,
                            device=keys.device)
    present_b = torch.zeros_like(present_a)
    present_a[inv[:keys_a.numel()]] = True
    present_b[inv[keys_a.numel():]] = True
    return int(((a != b) | (present_a != present_b)).sum())
