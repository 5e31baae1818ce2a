"""Reads what the program produced, for the comparison with the reference.

A fleet state is read by its fields alone (``layers[j].hi/lo/val/nnz``
with a leading instance axis, ``n_updates``, ``overflow``), so nothing of
the program is imported: the slots ``[0, nnz)`` of every layer are the
live ones (layer 0 may be an unsorted append buffer with repeated keys;
deeper layers are canonical), and an instance's contents are the sum by
key over all of them, as a point query combines them.
"""
from __future__ import annotations

import torch

from port_bench import reference


def contents(state, i: int, scale: int):
    """(sorted unique packed keys, float64 sums) of instance ``i``, all
    layers combined."""
    keys, vals = [], []
    for layer in state.layers:
        n = int(layer.nnz[i])
        keys.append(reference.pack(layer.hi[i, :n], layer.lo[i, :n], scale))
        vals.append(layer.val[i, :n].to(torch.float64))
    return reference.sums_by_key(torch.cat(keys), torch.cat(vals))


def counters(state):
    """(per-instance update counts, per-instance overflow), on the host."""
    return (state.n_updates.to("cpu").to(torch.int64),
            state.overflow.to("cpu").to(torch.int64))
