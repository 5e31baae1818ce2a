"""Sort-based oracle for the hier_merge kernels.

Independent of the kernels' sorting networks and of ``assoc``'s packed
sort key: two stable sorts (minor key, then major key) give the
lexicographic order, then a segment reduction combines duplicates.  Runs on
any device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

SENTINEL = 2**31 - 1

_REDUCE = {"plus.times": "sum", "max.plus": "amax", "max.min": "amax",
           "min.plus": "amin"}


def _zero_for(sr_name: str, dtype: torch.dtype):
    """The semiring zero for ``dtype`` as a Python number."""
    if sr_name == "plus.times":
        return 0 if not dtype.is_floating_point else 0.0
    if dtype.is_floating_point:
        return -math.inf if sr_name.startswith("max") else math.inf
    info = torch.iinfo(dtype)
    return info.min if sr_name.startswith("max") else info.max


def _as_tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)) \
        if isinstance(x, np.ndarray) else x


def _next_pow2(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


def _pad_canonical(hi, lo, val, cap: int, zero):
    """Append (SENTINEL, SENTINEL, zero) entries up to length ``cap``: a
    canonical tail, and for an unsorted block more keys that sort last."""
    pad = cap - hi.shape[0]
    if pad == 0:
        return hi, lo, val
    dev = hi.device
    fill = torch.full((pad,), SENTINEL, dtype=torch.int32, device=dev)
    return (torch.cat([hi, fill]), torch.cat([lo, fill]),
            torch.cat([val, torch.full((pad,), zero, dtype=val.dtype,
                                       device=dev)]))


def merge_ref(hi_a, lo_a, val_a, hi_b, lo_b, val_b, *,
              sr_name: str = "plus.times"):
    """Merge two canonical segments; returns (hi, lo, val, nnz[1])."""
    return merge_multi_ref([hi_a, hi_b], [lo_a, lo_b], [val_a, val_b],
                           sr_name=sr_name)


def merge_multi_ref(his, los, vals, *, sr_name: str = "plus.times"):
    """Merge any number of (not necessarily sorted) buffers; the sort does
    not care about pre-order, so this also oracles the multi-way kernel's
    'k sorted runs + one unsorted block' contract."""
    hi = torch.cat([_as_tensor(x) for x in his])
    lo = torch.cat([_as_tensor(x) for x in los])
    val = torch.cat([_as_tensor(x) for x in vals])
    n = hi.shape[0]
    dev = hi.device

    o1 = torch.sort(lo, stable=True).indices
    o2 = torch.sort(hi[o1], stable=True).indices
    order = o1[o2]
    hi, lo, val = hi[order], lo[order], val[order]

    first = torch.ones((n,), dtype=torch.bool, device=dev)
    first[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    seg = torch.cumsum(first, 0) - 1
    zero = _zero_for(sr_name, val.dtype)
    combined = torch.full((n,), zero, dtype=val.dtype, device=dev) \
        .scatter_reduce(0, seg, val, _REDUCE[sr_name], include_self=True)

    out_hi = torch.full((n,), SENTINEL, dtype=torch.int32,
                        device=dev).scatter(0, seg, hi)
    out_lo = torch.full((n,), SENTINEL, dtype=torch.int32,
                        device=dev).scatter(0, seg, lo)
    n_unique = torch.sum(first & (hi != SENTINEL)).to(torch.int32)

    live = torch.arange(n, device=dev) < n_unique
    out_hi = torch.where(live, out_hi, SENTINEL)
    out_lo = torch.where(live, out_lo, SENTINEL)
    out_val = torch.where(live, combined, zero)
    return out_hi, out_lo, out_val, n_unique.reshape(1)
