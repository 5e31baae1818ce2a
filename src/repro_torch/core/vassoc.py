"""Vector-valued associative arrays: int keys -> R^D payloads — the port of
``repro/core/vassoc.py``.

The scalar ``AssocSegment`` (``core/assoc.py``) stores A: (row, col) ->
scalar.  Sparse *gradient* streams in training are row-keyed with vector
payloads (embedding rows), so this module provides the same canonical-form
machinery for A: key -> R^D:

    key: int32[C]       sorted, unique, SENTINEL-padded
    val: f32[C, D]      payload rows (zeros in padding)
    nnz: int32 0-d

plus the hierarchical stack (``HierVec``) with the paper's cut/spill
cascade.  ``optim/sparse_update.py`` builds the embedding-gradient
accumulator on top: updates land in the small fast layer; spills
batch-apply to the master table.

Sorts are stable, as JAX's ``argsort`` is; ``n_updates`` is int32, as the
reference holds it (it wraps past 2**31 - 1).  Where the reference takes a
``lax.cond`` on a device flag (a spill, a drain), the port reads the flag
on the host: one synchronisation per layer boundary of ``update`` and one
per drain decision, counted at the ``vassoc`` site of
``obs.trace.host_reads``.  ``scatter_apply`` and
``drain_to_table`` add into the table IN PLACE and return it (the
reference returns a new array): a master table of gigabytes is never
copied.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.assoc import SENTINEL
from repro_torch.obs import trace as obs_trace


def host_flag(flag: torch.Tensor) -> bool:
    """``bool(flag)``, counted at the ``vassoc`` host-read site."""
    obs_trace.host_read("vassoc")
    return bool(flag)


@dataclasses.dataclass(frozen=True)
class VecSegment:
    key: torch.Tensor             # int32[C]
    val: torch.Tensor             # f32[C, D]
    nnz: torch.Tensor             # int32 0-d

    @property
    def capacity(self) -> int:
        return self.key.shape[-1]

    @property
    def dim(self) -> int:
        return self.val.shape[-1]


def empty(capacity: int, dim: int, dtype=torch.float32,
          device=None) -> VecSegment:
    return VecSegment(
        key=torch.full((capacity,), SENTINEL, dtype=torch.int32,
                       device=device),
        val=torch.zeros((capacity, dim), dtype=dtype, device=device),
        nnz=torch.zeros((), dtype=torch.int32, device=device))


def _canonicalize(key: torch.Tensor, val: torch.Tensor, out_capacity: int
                  ) -> Tuple[VecSegment, torch.Tensor]:
    n, dev = key.shape[0], key.device
    k_s, order = torch.sort(key, stable=True)
    v_s = val[order]
    first = torch.ones((n,), dtype=torch.bool, device=dev)
    first[1:] = k_s[1:] != k_s[:-1]
    seg_id = torch.cumsum(first, 0) - 1
    combined = torch.zeros_like(v_s).index_add_(0, seg_id, v_s)
    valid = k_s != SENTINEL
    n_unique = torch.sum(first & valid).to(torch.int32)
    out_key = torch.full((n,), SENTINEL, dtype=torch.int32, device=dev)
    out_key[seg_id] = k_s
    live = torch.arange(n, device=dev) < n_unique
    out_key = torch.where(live, out_key, SENTINEL)
    out_val = torch.where(live[:, None], combined.to(val.dtype), 0)

    if out_capacity >= n:
        pad = out_capacity - n
        out_key = torch.cat([out_key, torch.full((pad,), SENTINEL,
                                                 dtype=torch.int32,
                                                 device=dev)])
        out_val = torch.cat([out_val, torch.zeros((pad, val.shape[1]),
                                                  dtype=val.dtype,
                                                  device=dev)])
        overflow = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        out_key = out_key[:out_capacity]
        out_val = out_val[:out_capacity]
        overflow = torch.clamp(n_unique - out_capacity, min=0).to(
            torch.int32)
    nnz = torch.clamp(n_unique, max=out_capacity).to(torch.int32)
    return VecSegment(out_key, out_val, nnz), overflow


def from_rows(keys: torch.Tensor, vals: torch.Tensor, capacity: int,
              mask: torch.Tensor | None = None
              ) -> Tuple[VecSegment, torch.Tensor]:
    keys = keys.to(torch.int32)
    if mask is not None:
        keys = torch.where(mask, keys, SENTINEL)
        vals = torch.where(mask[:, None], vals, 0)
    return _canonicalize(keys, vals, capacity)


def merge(a: VecSegment, b: VecSegment, out_capacity: int
          ) -> Tuple[VecSegment, torch.Tensor]:
    return _canonicalize(torch.cat([a.key, b.key]),
                         torch.cat([a.val, b.val.to(a.val.dtype)]),
                         out_capacity)


def clear(seg: VecSegment) -> VecSegment:
    return empty(seg.capacity, seg.dim, seg.val.dtype, seg.key.device)


@torch.no_grad()
def scatter_apply(table: torch.Tensor, seg: VecSegment,
                  scale: float | torch.Tensor = 1.0,
                  sorted: bool = True) -> torch.Tensor:
    """table[key] += scale * val for live entries (batched apply), in
    place; returns ``table``.

    ``sorted=False`` admits a RAW buffer (unknown provenance, e.g. a
    restored checkpoint): live entries are additionally gated by ``nnz``
    instead of trusting the sentinel tail — the raw-buffer contract."""
    safe = torch.clamp(seg.key, 0, table.shape[0] - 1)
    live = seg.key != SENTINEL
    if not sorted:
        live &= torch.arange(seg.capacity, device=seg.key.device) < seg.nnz
    contrib = torch.where(live[:, None], seg.val, 0)
    return table.index_add_(0, safe, (scale * contrib).to(table.dtype))


# --------------------------------------------------------------- hierarchy --

@dataclasses.dataclass(frozen=True)
class HierVec:
    layers: Tuple[VecSegment, ...]
    spills: torch.Tensor          # int32[L]
    overflow: torch.Tensor        # int32 0-d
    n_updates: torch.Tensor       # int32 0-d (the reference's width)
    cuts: Tuple[int, ...]         # static: not a checkpoint leaf

    def nnz_per_layer(self) -> torch.Tensor:
        return torch.stack([l.nnz for l in self.layers])


def create(cuts: Tuple[int, ...], block_size: int, dim: int,
           dtype=torch.float32, device=None) -> HierVec:
    """An empty hierarchy on ``device`` (the caller resolves it): layer i
    holds cuts[i] plus everything the layer above may spill into it."""
    caps, prev = [], block_size
    for c in cuts:
        caps.append(c + prev)
        prev = caps[-1]
    zeros = lambda shape: torch.zeros(shape, dtype=torch.int32,
                                      device=device)
    return HierVec(layers=tuple(empty(c, dim, dtype, device) for c in caps),
                   spills=zeros((len(cuts),)), overflow=zeros(()),
                   n_updates=zeros(()), cuts=tuple(int(c) for c in cuts))


def update(h: HierVec, keys: torch.Tensor, vals: torch.Tensor,
           mask: torch.Tensor | None = None) -> HierVec:
    """Block-add (keys, vals) into layer 0, then spill layer i into layer
    i + 1 wherever layer i holds more than cuts[i] entries."""
    block, ovf0 = from_rows(keys, vals, keys.shape[0], mask)
    layer0, ovf1 = merge(h.layers[0], block, h.layers[0].capacity)
    n_new = keys.shape[0] if mask is None else torch.sum(
        mask, dtype=torch.int32)
    layers = [layer0] + list(h.layers[1:])
    spills, overflow = h.spills, h.overflow + ovf0 + ovf1
    for i in range(len(layers) - 1):
        src, dst = layers[i], layers[i + 1]
        if host_flag(src.nnz > h.cuts[i]):
            merged, ovf = merge(dst, src, dst.capacity)
            layers[i], layers[i + 1] = clear(src), merged
            spills = spills.clone()
            spills[i] += 1
            overflow = overflow + ovf
    return dataclasses.replace(
        h, layers=tuple(layers), spills=spills,
        overflow=overflow.to(torch.int32),
        n_updates=(h.n_updates + n_new).to(torch.int32))


def drain_to_table(h: HierVec, table: torch.Tensor,
                   scale: float | torch.Tensor = 1.0
                   ) -> Tuple[HierVec, torch.Tensor]:
    """Apply every layer to the table (in place) and clear the hierarchy
    (flush)."""
    for seg in h.layers:
        table = scatter_apply(table, seg, scale)
    return dataclasses.replace(
        h, layers=tuple(clear(l) for l in h.layers)), table


def query_all(h: HierVec) -> VecSegment:
    cap = sum(l.capacity for l in h.layers)
    acc = h.layers[-1]
    for layer in reversed(h.layers[:-1]):
        acc, _ = merge(acc, layer, cap)
    return acc
