"""Hierarchical associative arrays (paper Fig 2).

Layers A_0 .. A_L with cut thresholds c_0 < c_1 < ... < c_L.  Block updates
are semiring-merged into A_0 (the smallest array, sized for the fastest
memory).  After each update the spill cascade runs bottom-up: if
nnz(A_i) > c_i then A_i is merged into A_{i+1} and cleared.  Queries merge
every layer.

Capacity discipline (static shapes):
    C_0 = c_0 + block_size
    C_i = c_i + C_{i-1}            (a spill can deposit at most C_{i-1})
so no merge can arithmetically overflow except at the last layer, where an
``overflow`` counter records dropped entries.

The single-sort fused cascade (``fused=True``) is the production default for
``update``, ``flush`` and ``query_all``: the spill chain is planned with
scalar nnz arithmetic and executed as ONE canonicalization
(``assoc.merge_many``).  The per-layer pairwise path stays available behind
``fused=False`` as the reference oracle.

The port runs eagerly: a planned spill depth is read to the host (one
``int()`` per update here; one ``.tolist()`` per fleet step in
``core/stream.py``) and the branch for that depth runs directly, so
``batch_mode="switch"`` and ``"branchfree"`` differ only in the merge width
the branch-free form keeps (every layer up to ``up_to``, non-participants
gated to empty runs) — they give identical states.  A ``HierAssoc`` is
single-instance or batched with a leading instance axis ``[I, ...]`` on
every tensor (``core/stream.py``, ``core/distributed.py``).

The update counter (``n_updates``) is one int64 per instance — the exact
64-bit count the JAX package keeps as a (uint32 lo, int32 hi) word pair;
``counter_words`` gives that view.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch import resolve_device, stages
from repro_torch.analysis import contracts
from repro_torch.core import assoc
from repro_torch.core import semiring as sr_mod
from repro_torch.core.assoc import AssocSegment
from repro_torch.core.semiring import Semiring

Tensor = torch.Tensor


def layer_capacities(cuts: Tuple[int, ...], block_size: int) -> Tuple[int, ...]:
    caps = []
    prev = block_size
    for c in cuts:
        caps.append(c + prev)
        prev = caps[-1]
    return tuple(caps)


@dataclasses.dataclass(frozen=True)
class HierAssoc:
    """Hierarchical associative array state."""

    layers: Tuple[AssocSegment, ...]
    spills: Tensor       # int32[..., L]  cumulative spill events per layer
    overflow: Tensor     # int32[...]     unique entries dropped at the last layer
    n_updates: Tensor    # int64[...]     exact raw-update count
    cuts: Tuple[int, ...]

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    @property
    def capacities(self) -> Tuple[int, ...]:
        return tuple(l.capacity for l in self.layers)

    @property
    def device(self) -> torch.device:
        return self.spills.device


def map_state(fn, *states: HierAssoc) -> HierAssoc:
    """Apply ``fn`` leaf-wise over one or more same-shaped states (the
    port's ``jax.tree.map``)."""
    h = states[0]
    layers = tuple(
        AssocSegment(*(fn(*(getattr(s.layers[i], f) for s in states))
                       for f in ("hi", "lo", "val", "nnz")))
        for i in range(h.num_layers))
    return HierAssoc(layers=layers,
                     spills=fn(*(s.spills for s in states)),
                     overflow=fn(*(s.overflow for s in states)),
                     n_updates=fn(*(s.n_updates for s in states)),
                     cuts=h.cuts)


def create(cuts: Tuple[int, ...], block_size: int, dtype=torch.float32,
           sr: Semiring = sr_mod.PLUS_TIMES, device=None) -> HierAssoc:
    """An empty hierarchy, on the CUDA device unless ``device`` says
    otherwise."""
    if list(cuts) != sorted(cuts) or len(set(cuts)) != len(cuts):
        raise ValueError(f"cuts must be strictly increasing, got {cuts}")
    device = resolve_device(device)
    caps = layer_capacities(cuts, block_size)
    return HierAssoc(
        layers=tuple(assoc.empty(c, dtype, sr, device=device) for c in caps),
        spills=torch.zeros((len(cuts),), dtype=torch.int32, device=device),
        overflow=torch.zeros((), dtype=torch.int32, device=device),
        n_updates=torch.zeros((), dtype=torch.int64, device=device),
        cuts=tuple(cuts),
    )


def counter_words(h: HierAssoc) -> Tuple[Tensor, Tensor]:
    """The (lo, hi) word view of the update counter: lo = count mod 2**32
    (as int64 holding a uint32 value), hi = count >> 32 (int32)."""
    return h.n_updates & 0xFFFFFFFF, (h.n_updates >> 32).to(torch.int32)


def exact_update_count(h: HierAssoc) -> int:
    """Exact 64-bit update total; sums over any leading instance axes."""
    return int(h.n_updates.sum())


def metrics_snapshot(h: HierAssoc) -> dict:
    """Fleet observability sample: the whole ``[I, ...]`` (or single)
    state reduced on the device to a handful of tensors — per-layer nnz
    totals (int32) and mean occupancy, cumulative spills per layer, a
    depth histogram (instances per deepest non-empty layer; bin 0 =
    empty), overflow, and the exact update total as the reference's word
    pair: ``updates_lo`` (the low 32 bits, as int64) and ``updates_hi``
    (int32).  The host transfer is the caller's
    (``obs.metrics.fleet_sample``).  Knob-free: the signature pins
    geometry only, so every variant of a fleet shares one entry."""
    return metrics_snapshot_wrapped(stages.signature_for_state(h))(h)


def metrics_snapshot_wrapped(sig: stages.Signature) -> stages.Wrapped:
    """Keyed snapshot program for one hierarchy geometry (eager)."""
    return stages.wrap(_metrics_snapshot_body, "hier.metrics_snapshot", sig)


def _metrics_snapshot_body(h: HierAssoc) -> dict:
    nnz = [l.nnz for l in h.layers]
    nnz_total = torch.stack([torch.sum(n).to(torch.int32) for n in nnz])
    occupancy = torch.stack([torch.mean(n.to(torch.float32)) / c
                             for n, c in zip(nnz, h.capacities)])
    depth = torch.zeros_like(nnz[0])
    for i, n in enumerate(nnz):
        depth = torch.where(n > 0, i + 1, depth)
    depth_hist = torch.bincount(depth.reshape(-1).long(),
                                minlength=h.num_layers + 1).to(torch.int32)
    spills = torch.sum(h.spills.reshape(-1, len(h.cuts)), 0,
                       dtype=torch.int32)
    total = torch.sum(h.n_updates)
    return dict(
        nnz=nnz_total,
        occupancy=occupancy,
        depth_hist=depth_hist,
        spills=spills,
        overflow=torch.sum(h.overflow).to(torch.int32),
        updates_lo=total & 0xFFFFFFFF,
        updates_hi=(total >> 32).to(torch.int32),
    )


# --------------------------------------------------- numpy state converter ---

def state_to_numpy(h: HierAssoc) -> dict:
    """The state as numpy arrays keyed by the JAX pytree's leaf names
    (``layers[i].hi/lo/val/nnz``, ``spills``, ``overflow``, ``n_updates``
    — the uint32 low word —, ``n_updates_hi`` and ``cuts``)."""
    out = {}
    for i, l in enumerate(h.layers):
        for f in ("hi", "lo", "val", "nnz"):
            out[f"layers[{i}].{f}"] = getattr(l, f).cpu().numpy()
    out["spills"] = h.spills.cpu().numpy()
    out["overflow"] = h.overflow.cpu().numpy()
    n = h.n_updates.cpu().numpy().astype(np.int64)
    out["n_updates"] = (n & 0xFFFFFFFF).astype(np.uint32)
    out["n_updates_hi"] = (n >> 32).astype(np.int32)
    out["cuts"] = tuple(h.cuts)
    return out


def state_from_numpy(d: dict, device=None) -> HierAssoc:
    """Inverse of ``state_to_numpy``: start the port from a state written
    by either package (batched or single-instance)."""
    device = resolve_device(device)
    cuts = tuple(int(c) for c in d["cuts"])

    def t(x, dtype=None):
        x = torch.as_tensor(np.array(x), device=device)  # keeps 0-d leaves
        return x if dtype is None else x.to(dtype)

    layers = tuple(
        AssocSegment(hi=t(d[f"layers[{i}].hi"], torch.int32),
                     lo=t(d[f"layers[{i}].lo"], torch.int32),
                     val=t(d[f"layers[{i}].val"]),
                     nnz=t(d[f"layers[{i}].nnz"], torch.int32))
        for i in range(len(cuts)))
    lo = np.asarray(d["n_updates"]).astype(np.int64)
    hi = np.asarray(d["n_updates_hi"]).astype(np.int64)
    return HierAssoc(layers=layers, spills=t(d["spills"], torch.int32),
                     overflow=t(d["overflow"], torch.int32),
                     n_updates=t((hi << 32) + lo, torch.int64), cuts=cuts)


# ------------------------------------------------------- layered cascade ---

def _merge(a, b, cap, sr, use_kernel):
    if use_kernel:
        return assoc.merge_kernel(a, b, cap, sr)
    return assoc.merge(a, b, cap, sr)


def _spill(src: AssocSegment, dst: AssocSegment, sr: Semiring,
           use_kernel: bool = False, src_canonical: bool = True
           ) -> Tuple[AssocSegment, AssocSegment, Tensor]:
    if src_canonical:
        merged, ovf = _merge(dst, src, dst.capacity, sr, use_kernel)
    else:
        # src is a lazy append buffer (unsorted, duplicated): the pairwise
        # merge kernel requires canonical inputs, so route through the
        # multi-way merge, which sorts the raw side first.
        merged, ovf = assoc.merge_many((dst,), src.hi, src.lo, src.val,
                                       out_capacity=dst.capacity, sr=sr,
                                       use_kernel=use_kernel)
    return assoc.clear(src, sr), merged, ovf


def _pressure(spills: Tensor, last: AssocSegment, cut: int) -> Tensor:
    """Add the spill-less last layer's pressure flag (nnz past its cut)."""
    spills = spills.clone()
    spills[..., -1] += (last.nnz > cut).to(torch.int32)
    return spills


def _cascade(h: HierAssoc, sr: Semiring, use_kernel: bool = False,
             lazy_l0: bool = False) -> HierAssoc:
    layers = list(h.layers)
    spills = h.spills.clone()
    overflow = h.overflow
    for i in range(len(layers) - 1):
        if int(layers[i].nnz) > h.cuts[i]:
            layers[i], layers[i + 1], ovf = _spill(
                layers[i], layers[i + 1], sr, use_kernel,
                src_canonical=not (lazy_l0 and i == 0))
            spills[i] += 1
            overflow = overflow + ovf
    return dataclasses.replace(
        h, layers=tuple(layers), overflow=overflow,
        spills=_pressure(spills, layers[-1], h.cuts[-1]))


# ---------------------------------------------------------- fused cascade ---

def _lazy_append(l0: AssocSegment, hi: Tensor, lo: Tensor, val: Tensor,
                 n_live: Tensor | None = None) -> Tuple[AssocSegment, Tensor]:
    """Append a block into the layer-0 buffer (LSM memtable discipline).

    ``n_live`` is the number of potentially-live slots in the block's prefix
    (``sum(mask)`` for a compacted masked block, ``nnz`` for a canonical
    one); the buffer's nnz advances by that count, not by the physical block
    width, so sparse blocks stop inflating occupancy.  The block's sentinel
    tail still gets written, but the next append starts at the new nnz and
    overwrites it — every slot past nnz stays sentinel.

    The clamp keeps the write in-bounds, but when nnz > capacity - block it
    lands the block on top of live buffer slots [start, nnz).  Those entries
    are destroyed, not merged — the returned ``clobbered`` count (an upper
    bound on unique keys lost, consistent with slot-counting nnz) must be
    added to overflow.  Cascade planning keeps this at zero in normal
    operation.  Works on a single segment or an instance batch [I, C].
    """
    b = hi.shape[-1]
    if n_live is None:
        n_live = torch.full_like(l0.nnz, b)
    start = torch.clamp(l0.nnz, max=l0.capacity - b)
    clobbered = torch.clamp(l0.nnz - start, min=0).to(torch.int32)
    pos = (start.unsqueeze(-1)
           + torch.arange(b, device=hi.device, dtype=torch.int32)).long()
    layer0 = AssocSegment(
        hi=l0.hi.scatter(-1, pos, hi),
        lo=l0.lo.scatter(-1, pos, lo),
        val=l0.val.scatter(-1, pos, val.to(l0.val.dtype)),
        nnz=(start + n_live).to(torch.int32))
    return layer0, clobbered


def _compact_masked(rows: Tensor, cols: Tensor, vals: Tensor, mask: Tensor
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """Stable-partition a sentinel-blanked masked block: live entries to the
    front, masked-out sentinels to the tail.  One O(B) scatter — no sort —
    so the lazy-append fast path stays sort-free.  The destination indices
    form a permutation, so every slot is written exactly once."""
    mask = mask.to(torch.bool)
    b = rows.shape[-1]
    live_pos = torch.cumsum(mask, -1) - 1
    dead_pos = b - torch.cumsum(~mask, -1)
    dest = torch.where(mask, live_pos, dead_pos)
    return (torch.empty_like(rows).scatter(-1, dest, rows),
            torch.empty_like(cols).scatter(-1, dest, cols),
            torch.empty_like(vals).scatter(-1, dest, vals))


def _plan_spill_depth(h: HierAssoc, block_slots) -> Tensor:
    """Pure scalar arithmetic on per-layer nnz counters: the fused cascade's
    destination layer for an incoming block of ``block_slots`` entries
    (per instance for a batched state).

    Layer 0 spills iff its slots plus the block exceed c_0; layer i spills
    iff every layer above it spills AND the accumulated slot count exceeds
    c_i.  ``nnz`` is a slot count (an upper bound on unique keys), so the
    plan never under-provisions: overflow is possible only at the last
    layer.  No array data is touched.
    """
    occupancy = torch.as_tensor(block_slots, dtype=torch.int32,
                                device=h.device)
    depth = torch.zeros_like(h.layers[0].nnz)
    chain = torch.ones_like(h.layers[0].nnz, dtype=torch.bool)
    for i in range(h.num_layers - 1):
        occupancy = occupancy + h.layers[i].nnz
        chain = chain & (occupancy > h.cuts[i])
        depth = torch.where(chain, i + 1, depth)
    return depth


def _fused_execute_planned(h: HierAssoc, rows: Tensor, cols: Tensor,
                           vals: Tensor, n_live: Tensor, depth: int, *,
                           up_to: int, sr: Semiring, use_kernel: bool,
                           lazy_l0: bool, may_not_fit: bool = False
                           ) -> HierAssoc:
    """Branch-free fused-cascade executor for a block planned to ``depth``.

    Serves every spill depth in [0, ``up_to``] with ONE fixed-width
    ``assoc.merge_many``: layer i's buffer participates iff ``i <= depth``
    (``assoc.gate_segment`` blanks non-participants to all-sentinel runs,
    which are still canonical), the canonical result lands in the planned
    destination layer, and shallower layers are cleared.  ``depth <=
    up_to`` is the caller's contract.  With ``lazy_l0`` a depth-0 plan is
    the lazy append and merges nothing — the all-append cohort pays zero
    sorts; that path also runs on an instance batch ([I, ...] state and
    block, ``depth`` 0 for all).  Every other path is single-instance.

    ``rows``/``cols``/``vals`` must already be sentinel-masked, compacted
    and dtype-cast (``_prepare_block``); ``may_not_fit`` marks the one shape
    (masked block wider than the creation block size) whose append can
    physically clobber, needing the fit check.
    """
    B = rows.shape[-1]
    caps = h.capacities
    L = h.num_layers
    vdtype = h.layers[0].dtype

    if lazy_l0 and B <= h.cuts[0] and depth == 0 and (
            not may_not_fit or int(h.layers[0].nnz) + B <= caps[0]):
        # the LSM fast path: zero sorts
        l0_app, clobbered = _lazy_append(h.layers[0], rows, cols, vals,
                                         n_live=n_live)
        new_layers = (l0_app,) + h.layers[1:]
        return dataclasses.replace(
            h, layers=new_layers,
            spills=_pressure(h.spills, new_layers[-1], h.cuts[-1]),
            overflow=h.overflow + clobbered, n_updates=h.n_updates + n_live)

    # The ONE masked merge: raw block (+ lazy layer-0 buffer) plus every
    # gated layer buffer in [first, up_to].
    if lazy_l0:
        l0 = h.layers[0]
        raw = (torch.cat([rows, l0.hi]), torch.cat([cols, l0.lo]),
               torch.cat([vals, l0.val]))
        first = 1
    else:
        raw = (rows, cols, vals)
        first = 0
    runs = tuple(assoc.gate_segment(h.layers[i], i <= depth, sr)
                 for i in range(first, up_to + 1))
    width = raw[0].shape[-1] + sum(caps[first:up_to + 1])
    seg, _ = assoc.merge_many(runs, *raw, out_capacity=width, sr=sr,
                              use_kernel=use_kernel)
    n_unique = seg.nnz
    ovf = torch.clamp(n_unique - caps[depth], min=0).to(torch.int32)

    new_layers = list(h.layers)
    for i in range(depth):
        new_layers[i] = assoc.empty(caps[i], vdtype, sr, device=h.device)
    new_layers[depth] = AssocSegment(
        hi=seg.hi[:caps[depth]], lo=seg.lo[:caps[depth]],
        val=seg.val[:caps[depth]],
        nnz=torch.clamp(n_unique, max=caps[depth]).to(torch.int32))
    spills = h.spills + (torch.arange(L, device=h.device) < depth) \
        .to(torch.int32)
    return dataclasses.replace(
        h, layers=tuple(new_layers),
        spills=_pressure(spills, new_layers[-1], h.cuts[-1]),
        overflow=h.overflow + ovf, n_updates=h.n_updates + n_live)


def _prepare_block(h: HierAssoc, rows: Tensor, cols: Tensor, vals: Tensor,
                   mask: Tensor | None, sr: Semiring
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Shared fused-path prologue: int32/dtype-cast, sentinel-blank masked
    entries, compact a masked block front-first and return its live-slot
    count (``sum(mask)`` — the mask-aware occupancy the planner charges),
    per instance for a batched block."""
    vdtype = h.layers[0].dtype
    rows, cols, vals = assoc.mask_coo(rows, cols, vals.to(vdtype), mask, sr)
    if mask is None:
        n_live = torch.full(rows.shape[:-1], rows.shape[-1],
                            dtype=torch.int32, device=rows.device)
    else:
        n_live = torch.sum(mask.to(torch.int32), -1).to(torch.int32)
        rows, cols, vals = _compact_masked(rows, cols, vals, mask)
    return rows, cols, vals, n_live


def _update_fused(h: HierAssoc, rows: Tensor, cols: Tensor, vals: Tensor,
                  mask: Tensor | None, sr: Semiring, use_kernel: bool,
                  lazy_l0: bool, batch_mode: str = "switch") -> HierAssoc:
    """Single-sort fused spill cascade (tentpole path).

    The spill chain is *planned* first (scalar arithmetic on nnz counters
    and cuts), then one branch concatenates the raw COO block with every
    spilling layer's buffer and runs ONE canonicalization into the deepest
    destination layer.  With ``lazy_l0`` the no-spill branch degenerates to
    a pure append — zero sorts for the common case.

    ``batch_mode="switch"`` runs the branch for the planned depth, merging
    exactly the participating layers; ``"branchfree"`` runs
    ``_fused_execute_planned`` with every layer in the merge (the
    non-participants gated empty).  Both give identical states.
    """
    B = rows.shape[-1]
    vdtype = h.layers[0].dtype
    rows, cols, vals, n_live = _prepare_block(h, rows, cols, vals, mask, sr)
    depth = int(_plan_spill_depth(h, n_live))
    caps = h.capacities
    L = h.num_layers

    # The mask-aware plan admits nnz + n_live <= c_0, but the append
    # physically writes B slots: only a MASKED block wider than the
    # creation block_size (B > C_0 - c_0) can reach past capacity and
    # clobber live entries.
    append_always_fits = mask is None or B <= caps[0] - h.cuts[0]

    if batch_mode == "branchfree":
        return _fused_execute_planned(
            h, rows, cols, vals, n_live, depth, up_to=L - 1, sr=sr,
            use_kernel=use_kernel, lazy_l0=lazy_l0,
            may_not_fit=not append_always_fits)

    # A block physically wider than c_0 cannot use the append fast path
    # even when the mask-aware plan lands on depth 0 — the branch then runs
    # the canonicalizing merge into layer 0 instead.
    if depth == 0 and lazy_l0 and B <= h.cuts[0] and (
            append_always_fits or int(h.layers[0].nnz) + B <= caps[0]):
        layer0, ovf = _lazy_append(h.layers[0], rows, cols, vals,
                                   n_live=n_live)
        new_layers = (layer0,) + h.layers[1:]
        spills = h.spills
    else:
        if lazy_l0:
            # Layer 0 is an append buffer (unsorted); fold it into the raw
            # side so the kernel path sees true sorted runs only — also for
            # depth 0, where the buffer re-canonicalizes in place.
            l0 = h.layers[0]
            raw = (torch.cat([rows, l0.hi]), torch.cat([cols, l0.lo]),
                   torch.cat([vals, l0.val]))
            runs = h.layers[1:depth + 1]
        else:
            raw = (rows, cols, vals)
            runs = h.layers[:depth + 1]
        seg, ovf = assoc.merge_many(runs, *raw, out_capacity=caps[depth],
                                    sr=sr, use_kernel=use_kernel)
        new_layers = tuple(assoc.empty(caps[i], vdtype, sr, device=h.device)
                           for i in range(depth)) + (seg,) \
            + h.layers[depth + 1:]
        spills = h.spills.clone()
        spills[:depth] += 1
    return dataclasses.replace(
        h, layers=new_layers,
        spills=_pressure(spills, new_layers[-1], h.cuts[-1]),
        overflow=h.overflow + ovf, n_updates=h.n_updates + n_live)


def _as_block(h: HierAssoc, *xs):
    return tuple(None if x is None else torch.as_tensor(x, device=h.device)
                 for x in xs)


def update(h: HierAssoc, rows, cols, vals, mask=None,
           sr: Semiring = sr_mod.PLUS_TIMES,
           use_kernel: bool = False,
           lazy_l0: bool = False,
           fused: bool = True,
           batch_mode: str = "switch") -> HierAssoc:
    """Block-update: semiring-add a COO block into a single-instance
    hierarchy (Fig 2).

    ``lazy_l0=True``: layer 0 becomes an APPEND buffer — the incoming block
    is NOT re-merged with layer 0's contents; layer 0 is only canonicalized
    when the spill cascade or a query consumes it (the LSM memtable
    discipline).  ``nnz`` of layer 0 then counts occupied SLOTS (an upper
    bound on unique keys), which is exactly what the cut threshold compares
    against.  Restricted to plus.times.

    ``fused=True`` (the production default) routes through the single-sort
    fused spill cascade (``_update_fused``); ``fused=False`` keeps the
    per-layer reference cascade.  ``batch_mode`` (fused only): ``"switch"``
    or ``"branchfree"``.  Returns a new state; ``h`` is not modified.

    Under ``REPRO_CHECK=1`` the input and output states are checked
    against the contracts (layer 0 as a raw buffer with ``lazy_l0``), and
    every merge inside (``analysis/contracts.py``).
    """
    sig = stages.signature_for_state(
        h, sr=sr, use_kernel=use_kernel, lazy_l0=lazy_l0, fused=fused,
        batch_mode=batch_mode,
        allowed_batch_modes=("switch", "branchfree"))
    rows, cols, vals, mask = _as_block(h, rows, cols, vals, mask)
    return update_wrapped(contracts.front_door_signature(sig))(
        h, rows, cols, vals, mask)


def update_wrapped(sig: stages.Signature) -> stages.Wrapped:
    """Keyed block-update program for one config signature (eager: a spill
    plan is read on the host).  A signature carrying
    ``contracts.DEBUG_EXTRA`` keys the checked build."""
    sr = sr_mod.get(sig.sr)

    def run(h, rows, cols, vals, mask):
        return _update_body(h, rows, cols, vals, mask, sr, sig)

    if contracts.sig_debug(sig):
        def checked(h, rows, cols, vals, mask):
            return contracts.checked(
                "hier.update", h, sr,
                lambda: run(h, rows, cols, vals, mask),
                l0_sorted=not sig.lazy_l0)
        return stages.wrap(checked, "hier.update", sig)
    return stages.wrap(run, "hier.update", sig)


def _update_body(h: HierAssoc, rows, cols, vals, mask, sr: Semiring,
                 sig: stages.Signature) -> HierAssoc:
    use_kernel, lazy_l0 = sig.use_kernel, sig.lazy_l0
    if sig.fused:
        return _update_fused(h, rows, cols, vals, mask, sr, use_kernel,
                             lazy_l0, batch_mode=sig.batch_mode)
    merged, ovf0 = assoc.from_coo(rows, cols, vals, rows.shape[-1], sr,
                                  mask=mask)
    if lazy_l0:
        # merged is canonical (live prefix, sentinel tail): advance the
        # buffer by its unique count, not the physical block width.
        layer0, ovf1 = _lazy_append(h.layers[0], merged.hi, merged.lo,
                                    merged.val, n_live=merged.nnz)
    else:
        layer0, ovf1 = _merge(h.layers[0], merged,
                              h.layers[0].capacity, sr, use_kernel)
    n_new = rows.shape[-1] if mask is None else torch.sum(mask.to(torch.int64))
    h2 = dataclasses.replace(
        h,
        layers=(layer0,) + h.layers[1:],
        overflow=h.overflow + ovf0 + ovf1,
        n_updates=h.n_updates + n_new,
    )
    return _cascade(h2, sr, use_kernel, lazy_l0)


# ---------------------------------------------------------- query / drain ---

def query_all(h: HierAssoc, sr: Semiring = sr_mod.PLUS_TIMES,
              use_kernel: bool = False,
              lazy_l0: bool = False,
              fused: bool = True) -> AssocSegment:
    """Sum all layers into one canonical segment (paper: query path).

    ``fused=True`` (default) runs ONE ``assoc.merge_many`` canonicalization
    over every layer — layer 0's buffer rides the raw side, which is correct
    whether it is a lazy append buffer or canonical.  ``fused=False`` keeps
    the pairwise reference path; it needs ``lazy_l0=True`` when the
    hierarchy is operated with lazy layer-0 appends.
    """
    sig = stages.signature_for_state(h, sr=sr, use_kernel=use_kernel,
                                     lazy_l0=lazy_l0, fused=fused)
    return query_all_wrapped(sig)(h)


def query_all_wrapped(sig: stages.Signature) -> stages.Wrapped:
    """Keyed merge-all-layers program for one config signature (eager)."""
    sr = sr_mod.get(sig.sr)

    def run(h):
        return _query_all_body(h, sr, sig.use_kernel, sig.lazy_l0,
                               sig.fused)

    return stages.wrap(run, "hier.query_all", sig)


def _query_all_body(h: HierAssoc, sr: Semiring, use_kernel: bool,
                    lazy_l0: bool, fused: bool) -> AssocSegment:
    cap = sum(h.capacities)
    l0 = h.layers[0]
    if fused:
        return assoc.merge_many(h.layers[1:], l0.hi, l0.lo, l0.val,
                                out_capacity=cap, sr=sr,
                                use_kernel=use_kernel)[0]
    if h.num_layers == 1:
        if lazy_l0:
            acc, _ = assoc.merge_many((), l0.hi, l0.lo, l0.val,
                                      out_capacity=cap, sr=sr,
                                      use_kernel=use_kernel)
            return acc
        return l0
    acc = h.layers[-1]
    for layer in reversed(h.layers[1:-1]):
        acc, _ = _merge(acc, layer, cap, sr, use_kernel)
    if lazy_l0:
        acc, _ = assoc.merge_many((acc,), l0.hi, l0.lo, l0.val,
                                  out_capacity=cap, sr=sr,
                                  use_kernel=use_kernel)
    else:
        acc, _ = _merge(acc, l0, cap, sr, use_kernel)
    return acc


def lookup(h: HierAssoc, row, col, sr: Semiring = sr_mod.PLUS_TIMES,
           use_kernel: bool = False) -> Tensor:
    """Point query without materializing the merged array (the batched
    query engine, ``query/engine.py``)."""
    from repro_torch.query import engine
    return engine.lookup(h, row, col, sr=sr, use_kernel=use_kernel)


def lookup_layered(h: HierAssoc, row, col,
                   sr: Semiring = sr_mod.PLUS_TIMES) -> Tensor:
    """Reference point query: full per-layer scans, scalar row/col (the
    engine's oracle).  Layer 0 is queried under the raw-buffer contract
    (live slots gated by ``nnz``), valid whether it is a lazy append
    buffer or canonical; deeper layers are canonical."""
    vals = [assoc.lookup(l, row, col, sr, sorted=i > 0)
            for i, l in enumerate(h.layers)]
    out = vals[0]
    for v in vals[1:]:
        out = sr.add(out, v)
    return out


def total_nnz_upper_bound(h: HierAssoc) -> Tensor:
    """Sum of per-layer nnz (keys may repeat across layers), over every
    instance of a batch: an int32 scalar."""
    return torch.stack([l.nnz for l in h.layers]).sum(dtype=torch.int32)


def _flush_fused(h: HierAssoc, sr: Semiring, use_kernel: bool) -> HierAssoc:
    """Fused drain: ONE ``assoc.merge_many`` canonicalization folds every
    layer into the last one.  Spill accounting matches the layered drain:
    layer i records an event when any data exists in layers [0, i], plus
    the last-layer pressure flag."""
    caps = h.capacities
    l0 = h.layers[0]
    seg, ovf = assoc.merge_many(h.layers[1:], l0.hi, l0.lo, l0.val,
                                out_capacity=caps[-1], sr=sr,
                                use_kernel=use_kernel)
    spills = h.spills.clone()
    cum_nnz = torch.zeros_like(l0.nnz)
    for i in range(h.num_layers - 1):
        cum_nnz = cum_nnz + h.layers[i].nnz
        spills[i] += (cum_nnz > 0).to(torch.int32)
    new_layers = tuple(assoc.empty(caps[i], l0.dtype, sr, device=h.device)
                       for i in range(h.num_layers - 1)) + (seg,)
    return dataclasses.replace(h, layers=new_layers,
                               spills=_pressure(spills, seg, h.cuts[-1]),
                               overflow=h.overflow + ovf)


def flush(h: HierAssoc, sr: Semiring = sr_mod.PLUS_TIMES,
          use_kernel: bool = False, lazy_l0: bool = False,
          fused: bool = True) -> HierAssoc:
    """Force-spill every layer downward (checkpoint/drain path).

    ``fused=True`` (default) drains with a single canonicalization
    (``_flush_fused``); ``fused=False`` keeps the pairwise per-layer
    reference drain.  Both record a spill event per non-empty source layer
    and the ``spills[-1]`` pressure bump.  Under ``REPRO_CHECK=1`` the
    input and the drained output are checked (every layer of the output is
    canonical, layer 0 emptied).
    """
    sig = stages.signature_for_state(h, sr=sr, use_kernel=use_kernel,
                                     lazy_l0=lazy_l0, fused=fused)
    return flush_wrapped(contracts.front_door_signature(sig))(h)


def flush_wrapped(sig: stages.Signature) -> stages.Wrapped:
    """Keyed force-spill program for one config signature (eager).  A
    signature carrying ``contracts.DEBUG_EXTRA`` keys the checked build:
    every layer of the drained output is checked as canonical."""
    sr = sr_mod.get(sig.sr)

    def run(h):
        return _flush_body(h, sr, sig.use_kernel, sig.lazy_l0, sig.fused)

    if contracts.sig_debug(sig):
        def checked(h):
            return contracts.checked("hier.flush", h, sr, lambda: run(h),
                                     l0_sorted=not sig.lazy_l0,
                                     out_l0_sorted=True)
        return stages.wrap(checked, "hier.flush", sig)
    return stages.wrap(run, "hier.flush", sig)


def _flush_body(h: HierAssoc, sr: Semiring, use_kernel: bool,
                lazy_l0: bool, fused: bool) -> HierAssoc:
    if fused:
        return _flush_fused(h, sr, use_kernel)
    layers = list(h.layers)
    spills = h.spills.clone()
    overflow = h.overflow
    for i in range(len(layers) - 1):
        spills[i] += (layers[i].nnz > 0).to(torch.int32)
        layers[i], layers[i + 1], ovf = _spill(
            layers[i], layers[i + 1], sr, use_kernel,
            src_canonical=not (lazy_l0 and i == 0))
        overflow = overflow + ovf
    return dataclasses.replace(
        h, layers=tuple(layers), overflow=overflow,
        spills=_pressure(spills, layers[-1], h.cuts[-1]))
