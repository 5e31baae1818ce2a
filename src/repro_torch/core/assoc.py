"""Static-capacity associative-array segments (sorted COO) — paper §II.

A D4M associative array maps (row, col) string/int keys to semiring values.
An array is stored as a fixed-capacity *segment*:

    hi : int32[C]   row keys   (lexicographic major)
    lo : int32[C]   col keys   (lexicographic minor)
    val: V[C]       semiring values
    nnz: int32      live-entry count

Entries [0, nnz) are sorted by (hi, lo) and unique; slots [nnz, C) hold the
SENTINEL key and the semiring zero.  This invariant ("canonical form") lets
merges concatenate raw buffers without masking.

Functions here act on one segment (1-D tensors) and return new tensors;
instance batching of the update path lives in ``core/stream.py``.  The
reductions (``reduce_rows``, ``reduce_cols``, ``spmv``, ``spmv_t``,
``to_dense``, ``total``) also take an instance batch (``[I, C]`` fields,
``[I]`` nnz) and return one result per instance: the port's counterpart
of ``jax.vmap`` over them.

CONTRACTS
---------
The invariants every producer and consumer of a segment trades on.

1. **Canonical form** (``sorted=True`` paths, every layer >= 1, and layer 0
   outside lazy-append mode): entries [0, nnz) are sorted-unique by
   (hi, lo) and contain no SENTINEL key.  Consumers may binary-search,
   run-merge without re-sorting, and pass ``indices_are_sorted`` hints.
2. **Sentinel tail**: slots [nnz, C) hold exactly (SENTINEL, SENTINEL,
   semiring zero).  This is what lets ``merge``/``merge_many`` concatenate
   whole buffers without masking — a single dirty tail slot silently
   corrupts every downstream merge and reduction.
3. **Raw-buffer contract** (``sorted=False`` paths — the lazy layer-0
   append buffer, checkpoint-restored or externally built segments): ONLY
   slots [0, nnz) are meaningful.  Entries there may be unsorted and
   duplicated; the tail is not trusted.  Reductions over raw buffers must
   gate live slots via ``_live_slots(seg, sorted=False)`` (the
   ``arange(C) < nnz`` gate) — lint rule R005 flags reductions over
   ``.val`` that do neither.
4. **nnz bound**: 0 <= nnz <= C always; overflow is reported through the
   separate ``overflow`` counters, never by letting nnz exceed capacity.
5. **Counter words** (``hier.HierAssoc``): the raw-update total is a
   (hi, lo) = (int32, uint32) carry pair — lo wraps mod 2**32, hi counts
   wraps and is never negative; total live slots never exceed the 64-bit
   update total.

In this port the counter of contract 5 is held as one int64 per instance;
``hier.counter_words`` gives its (hi, lo) view.  Keys stay int32; the one
int64 key is the transient packed sort key inside ``_canonicalize``.

With tracing on (``obs.trace``), each ``merge_many`` is an ``assoc.merge``
span: its ``route`` (``"kernel"`` or ``"sort"``), ``width`` (the slots it
takes in) and ``out_capacity``, and on the sort route ``live`` (the
non-sentinel slots among them, a device scalar read when the session is
collected).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.analysis import contracts
from repro_torch.core import semiring as sr_mod
from repro_torch.core.semiring import Semiring
from repro_torch.kernels import registry
from repro_torch.obs import trace as obs_trace

Tensor = torch.Tensor

# Largest int32 — real keys must be strictly smaller.
SENTINEL = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class AssocSegment:
    """One canonical-form associative array segment (any leading batch
    axes allowed on every field; ``capacity`` is the last axis)."""

    hi: Tensor
    lo: Tensor
    val: Tensor
    nnz: Tensor

    @property
    def capacity(self) -> int:
        return self.hi.shape[-1]

    @property
    def dtype(self) -> torch.dtype:
        return self.val.dtype

    @property
    def device(self) -> torch.device:
        return self.hi.device


def empty(capacity: int, dtype=torch.float32,
          sr: Semiring = sr_mod.PLUS_TIMES, device=None) -> AssocSegment:
    from repro_torch import resolve_device
    device = resolve_device(device)
    zero = sr_mod.integer_zero(sr, dtype)
    return AssocSegment(
        hi=torch.full((capacity,), SENTINEL, dtype=torch.int32, device=device),
        lo=torch.full((capacity,), SENTINEL, dtype=torch.int32, device=device),
        val=torch.full((capacity,), zero, dtype=dtype, device=device),
        nnz=torch.zeros((), dtype=torch.int32, device=device),
    )


# torch.sort has no two-key sort: each (hi, lo) pair packs into one int64
# tracekit: allow(J005) entry=* the pair's sort key, on purpose
def pack_key(hi: Tensor, lo: Tensor) -> Tensor:
    """One int64 per (hi, lo) pair, ordered as the signed lexicographic
    pair.  lo is offset by 2**31 so a negative lo sorts below a
    non-negative one (a plain ``hi << 32 | lo`` sign-extends lo into hi's
    bits and misorders it)."""
    return (hi.to(torch.int64) << 32) + (lo.to(torch.int64) + 2**31)


def _sorted_by_key(hi: Tensor, lo: Tensor, val: Tensor):
    """Co-sort by signed lexicographic (hi, lo) through ``pack_key``."""
    _, order = torch.sort(pack_key(hi, lo), stable=True)
    return hi[order], lo[order], val[order]


def _canonicalize(hi: Tensor, lo: Tensor, val: Tensor, out_capacity: int,
                  sr: Semiring, span=obs_trace.NO_SPAN
                  ) -> Tuple[AssocSegment, Tensor]:
    """Sort by (hi, lo), combine duplicate keys with sr.add, compact, pad.

    Inputs may contain SENTINEL entries (ignored).  Returns the canonical
    segment of the requested capacity plus an ``overflow`` count of unique
    entries dropped because they exceeded out_capacity (largest keys drop
    first, preserving the sorted prefix).  This is the sort route: it runs
    above the merge kernels' capacity ceiling and with the kernels off, and
    is counted as ``assoc.sort_route`` in the kernel registry.  A kept
    ``span`` (``merge_many``'s) takes the count of live input slots.
    """
    registry.count("assoc.sort_route")
    n = hi.shape[-1]
    dev = hi.device
    hi_s, lo_s, val_s = _sorted_by_key(hi, lo, val)

    first = torch.ones((n,), dtype=torch.bool, device=dev)
    first[1:] = (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])
    valid = hi_s != SENTINEL
    # Run index per slot, each sentinel slot a run of its own.  Sentinels
    # sort last, so live runs keep their ids and every sentinel slot gets an
    # id >= n_unique that no other slot has: the sentinel run's adds and key
    # writes go to distinct addresses (``live`` masks those slots).
    ids = torch.cumsum(first | ~valid, 0) - 1
    combined = sr.segment_add(val_s, ids, n)             # [n]

    n_unique = torch.sum(first & valid).to(torch.int32)
    if span.on:
        span.set(live=torch.sum(valid))

    # Scatter each run's key to its run slot.  Duplicate writes within a run
    # carry identical key values, so write order is immaterial.
    out_hi = torch.full((n,), SENTINEL, dtype=torch.int32,
                        device=dev).scatter(0, ids, hi_s)
    out_lo = torch.full((n,), SENTINEL, dtype=torch.int32,
                        device=dev).scatter(0, ids, lo_s)

    zero = sr_mod.integer_zero(sr, val.dtype)
    live = torch.arange(n, device=dev) < n_unique
    out_hi = torch.where(live, out_hi, SENTINEL)
    out_lo = torch.where(live, out_lo, SENTINEL)
    out_val = torch.where(live, combined.to(val.dtype), zero)

    if out_capacity >= n:
        pad = out_capacity - n
        out_hi = torch.cat([out_hi, torch.full((pad,), SENTINEL,
                                               dtype=torch.int32, device=dev)])
        out_lo = torch.cat([out_lo, torch.full((pad,), SENTINEL,
                                               dtype=torch.int32, device=dev)])
        out_val = torch.cat([out_val, torch.full((pad,), zero,
                                                 dtype=val.dtype, device=dev)])
        overflow = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        out_hi = out_hi[:out_capacity]
        out_lo = out_lo[:out_capacity]
        out_val = out_val[:out_capacity]
        overflow = torch.clamp(n_unique - out_capacity, min=0).to(torch.int32)

    nnz = torch.clamp(n_unique, max=out_capacity).to(torch.int32)
    return AssocSegment(out_hi, out_lo, out_val, nnz), overflow


def mask_coo(rows: Tensor, cols: Tensor, vals: Tensor,
             mask: Tensor | None, sr: Semiring
             ) -> Tuple[Tensor, Tensor, Tensor]:
    """int32-cast a COO block and blank masked-out entries to the SENTINEL
    key / semiring zero (the canonical 'ignore me' encoding)."""
    rows = rows.to(torch.int32)
    cols = cols.to(torch.int32)
    if mask is not None:
        mask = mask.to(torch.bool)
        zero = sr_mod.integer_zero(sr, vals.dtype)
        rows = torch.where(mask, rows, SENTINEL)
        cols = torch.where(mask, cols, SENTINEL)
        vals = torch.where(mask, vals, zero)
    return rows, cols, vals


def from_coo(rows: Tensor, cols: Tensor, vals: Tensor, capacity: int,
             sr: Semiring = sr_mod.PLUS_TIMES,
             mask: Tensor | None = None) -> Tuple[AssocSegment, Tensor]:
    """Build a canonical segment from an (unsorted, possibly duplicated) block."""
    rows, cols, vals = mask_coo(rows, cols, vals, mask, sr)
    return _canonicalize(rows, cols, vals, capacity, sr)


def merge(a: AssocSegment, b: AssocSegment, out_capacity: int,
          sr: Semiring = sr_mod.PLUS_TIMES) -> Tuple[AssocSegment, Tensor]:
    """a (+) b under the semiring, into a segment of out_capacity."""
    hi = torch.cat([a.hi, b.hi])
    lo = torch.cat([a.lo, b.lo])
    val = torch.cat([a.val, b.val.to(a.val.dtype)])
    return _canonicalize(hi, lo, val, out_capacity, sr)


def merge_kernel(a: AssocSegment, b: AssocSegment, out_capacity: int,
                 sr: Semiring = sr_mod.PLUS_TIMES
                 ) -> Tuple[AssocSegment, Tensor]:
    """Kernel-backed merge: the pairwise merge kernel (CUDA on the card,
    its plain version on the CPU).  Takes the sort route above the
    kernel capacity ceiling."""
    from repro_torch.kernels.hier_merge import ops as hm_ops

    total = a.capacity + b.capacity
    if total > hm_ops.MAX_KERNEL_CAPACITY:
        return merge(a, b, out_capacity, sr)
    hi, lo, val, nnz, ovf = hm_ops.merge(
        a.hi, a.lo, a.val, b.hi, b.lo, b.val.to(a.val.dtype),
        out_capacity=out_capacity, sr_name=sr.name)
    return AssocSegment(hi, lo, val, nnz), ovf


def merge_many(segments, hi: Tensor, lo: Tensor, val: Tensor, *,
               out_capacity: int, sr: Semiring = sr_mod.PLUS_TIMES,
               use_kernel: bool = False,
               debug: bool = False) -> Tuple[AssocSegment, Tensor]:
    """Semiring-merge k canonical segments plus one RAW (unsorted, possibly
    duplicated, sentinel-masked) COO buffer in a SINGLE canonicalization.

    This is the fused spill cascade's data plane: instead of one sort per
    hierarchy level, every spilling layer's buffer and the incoming block
    are combined in one pass.  With ``use_kernel`` the multi-way merge
    kernel is used below its capacity ceiling (only the block is sorted;
    the sorted runs are merged, not re-sorted); otherwise one sort does
    everything.

    ``debug`` (or a call inside ``contracts.activate()``, as the checked
    front doors make under ``REPRO_CHECK=1``) checks that every input run
    really is canonical — the precondition this whole fusion trades on —
    and that the merged output is too.
    """
    segments = tuple(segments)
    if debug or contracts.deep_checks_active():
        for i, s in enumerate(segments):
            contracts.check_canonical(s, sr,
                                      name=f"merge_many input run {i}")
        out, ovf = _merge_many_impl(segments, hi, lo, val,
                                    out_capacity=out_capacity, sr=sr,
                                    use_kernel=use_kernel)
        contracts.check_canonical(out, sr, name="merge_many output")
        return out, ovf
    return _merge_many_impl(segments, hi, lo, val,
                            out_capacity=out_capacity, sr=sr,
                            use_kernel=use_kernel)


def _merge_many_impl(segments, hi: Tensor, lo: Tensor, val: Tensor, *,
                     out_capacity: int, sr: Semiring,
                     use_kernel: bool) -> Tuple[AssocSegment, Tensor]:
    with obs_trace.span("assoc.merge", out_capacity=out_capacity) as sp:
        if use_kernel:
            from repro_torch.kernels.hier_merge import ops as hm_ops

            run_caps = tuple(s.capacity for s in segments)
            if hm_ops.multi_padded_capacity(hi.shape[-1], run_caps) \
                    <= hm_ops.MAX_KERNEL_CAPACITY:
                if sp.on:
                    sp.set(route="kernel",
                           width=hi.shape[-1] + sum(run_caps))
                run_arrays = []
                for s in segments:
                    run_arrays += [s.hi, s.lo, s.val.to(val.dtype)]
                o_hi, o_lo, o_val, nnz, ovf = hm_ops.merge_multi(
                    hi, lo, val, *run_arrays,
                    out_capacity=out_capacity, sr_name=sr.name)
                return AssocSegment(o_hi, o_lo, o_val, nnz), ovf
        cat_hi = torch.cat([hi] + [s.hi for s in segments])
        cat_lo = torch.cat([lo] + [s.lo for s in segments])
        cat_val = torch.cat([val] + [s.val.to(val.dtype) for s in segments])
        if sp.on:
            sp.set(route="sort", width=cat_hi.shape[-1])
        return _canonicalize(cat_hi, cat_lo, cat_val, out_capacity, sr,
                             span=sp)


def gate_segment(seg: AssocSegment, keep,
                 sr: Semiring = sr_mod.PLUS_TIMES) -> AssocSegment:
    """All-or-nothing participation gate for a canonical run.

    With ``keep`` False the segment is blanked to the all-SENTINEL empty run
    — which is itself canonical, so the kernel path may still treat it as a
    sorted run; with ``keep`` True it is returned unchanged.  ``keep`` may be
    a Python bool or a bool tensor (per instance).
    """
    zero = sr_mod.integer_zero(sr, seg.dtype)
    if isinstance(keep, bool):
        if keep:
            return seg
        return AssocSegment(hi=torch.full_like(seg.hi, SENTINEL),
                            lo=torch.full_like(seg.lo, SENTINEL),
                            val=torch.full_like(seg.val, zero),
                            nnz=torch.zeros_like(seg.nnz))
    keep_c = keep.unsqueeze(-1)
    return AssocSegment(
        hi=torch.where(keep_c, seg.hi, SENTINEL),
        lo=torch.where(keep_c, seg.lo, SENTINEL),
        val=torch.where(keep_c, seg.val, zero),
        nnz=torch.where(keep, seg.nnz, 0).to(torch.int32))


def clear(seg: AssocSegment, sr: Semiring = sr_mod.PLUS_TIMES) -> AssocSegment:
    return empty(seg.capacity, seg.dtype, sr, device=seg.device)


# ---------------------------------------------------------------- queries ---

def lookup(seg: AssocSegment, row, col,
           sr: Semiring = sr_mod.PLUS_TIMES, sorted: bool = True) -> Tensor:
    """Point query A(row, col); semiring zero when absent.

    ``sorted=False`` admits a RAW buffer (lazy layer-0 append buffer, or any
    segment of unknown provenance): matches are additionally gated by the
    ``nnz`` live-slot mask, so stale keys beyond the live prefix can never
    alias a real (row, col) — the raw-buffer contract, see CONTRACTS.
    """
    match = (seg.hi == row) & (seg.lo == col) & _live_slots(seg, sorted)
    zero = sr_mod.integer_zero(sr, seg.dtype)
    if sr.name == "plus.times":
        hit = torch.sum(torch.where(match, seg.val, zero), dtype=seg.dtype)
    else:
        hit = seg.val[torch.argmax(match.to(torch.int32))]
    return torch.where(torch.any(match), hit,
                       torch.tensor(zero, dtype=seg.dtype, device=seg.device))


def _live_slots(seg: AssocSegment, sorted: bool) -> Tensor:
    """Validity mask for a reduction input.

    Canonical segments (``sorted=True``) are fully described by the
    sentinel invariant: slots [nnz, C) hold SENTINEL / semiring zero.  A
    RAW buffer (``sorted=False``) only promises that slots [0, nnz) are
    meaningful, so raw reductions must ALSO gate on ``arange(C) < nnz``.
    """
    valid = seg.hi != SENTINEL
    if not sorted:
        valid &= torch.arange(seg.capacity, device=seg.device) \
            < seg.nnz.unsqueeze(-1)
    return valid


def extract_row(seg: AssocSegment, row) -> Tuple[Tensor, Tensor, Tensor]:
    """All (col, val) pairs of one row plus a validity mask (Fig 1's
    nearest-neighbor query)."""
    return seg.lo, seg.val, seg.hi == row


# tracekit: allow(J005) entry=* scatter/gather take int64 ids (never keys)
def _segment_reduce(sr: Semiring, vals: Tensor, ids: Tensor, n: int
                    ) -> Tensor:
    """``sr.add`` of ``vals`` per id in ``[0, n)`` along the last axis,
    separately for every leading index: ``[..., C] -> [..., n]``.  Ids
    outside ``[0, n)`` are dropped, as ``jax.ops.segment_*`` drops them.
    A batch is one scatter: instance i's ids are offset by ``i * (n + 1)``
    into a flat output whose spare slot per instance takes the dropped
    ids."""
    lead = ids.shape[:-1]
    if not lead:
        return sr.segment_add(vals, ids, n)
    b = math.prod(lead)
    ids = ids.reshape(b, -1).long()
    ids = torch.where((ids >= 0) & (ids < n), ids, n)
    ids = ids + torch.arange(b, device=ids.device).unsqueeze(-1) * (n + 1)
    out = sr.segment_add(vals.reshape(-1), ids.reshape(-1), b * (n + 1))
    return out.reshape(lead + (n + 1,))[..., :n]


def _gather_x(x: Tensor, idx: Tensor) -> Tensor:
    """``x`` at ``idx`` clipped into ``[0, len(x))``; a batched ``x``
    ([..., N], the leading axes of ``idx``) is read per instance."""
    idx = torch.clamp(idx.long(), 0, x.shape[-1] - 1)
    return x[idx] if x.dim() == 1 else torch.gather(x, -1, idx)


def reduce_rows(seg: AssocSegment, num_rows: int,
                sr: Semiring = sr_mod.PLUS_TIMES,
                sorted: bool = True) -> Tensor:
    """Dense per-row reduction (e.g. out-degrees under plus.times).

    ``sorted=False`` lifts the canonical-form assumption so the same
    reduction runs over a RAW buffer (the lazy layer-0 append buffer, with
    unsorted and duplicated keys), gating live slots by ``nnz`` instead of
    trusting the sentinel tail.  Keys outside ``[0, num_rows)`` are
    dropped.
    """
    ids = torch.where(_live_slots(seg, sorted), seg.hi, num_rows)
    return _segment_reduce(sr, seg.val, ids, num_rows)


def reduce_cols(seg: AssocSegment, num_cols: int,
                sr: Semiring = sr_mod.PLUS_TIMES,
                sorted: bool = True) -> Tensor:
    """Dense per-column reduction (in-degrees under plus.times);
    ``sorted=False`` adds the raw-buffer live-slot gate by ``nnz``."""
    ids = torch.where(_live_slots(seg, sorted), seg.lo, num_cols)
    return _segment_reduce(sr, seg.val, ids, num_cols)


def spmv(seg: AssocSegment, x: Tensor, num_rows: int,
         sr: Semiring = sr_mod.PLUS_TIMES, sorted: bool = True) -> Tensor:
    """y = A (.) x under the semiring: y[r] = add_c mul(A[r,c], x[c]).

    The gather into ``x`` is clipped into range, as in the reference.
    ``sorted=False`` admits a RAW buffer, live slots gated by ``nnz``.
    """
    zero = sr_mod.integer_zero(sr, seg.dtype)
    valid = _live_slots(seg, sorted)
    gathered = _gather_x(x, seg.lo)
    prod = torch.where(valid, sr.mul(seg.val, gathered.to(seg.dtype)), zero)
    ids = torch.where(valid, seg.hi, num_rows)
    return _segment_reduce(sr, prod, ids, num_rows)


def spmv_t(seg: AssocSegment, x: Tensor, num_cols: int,
           sr: Semiring = sr_mod.PLUS_TIMES, sorted: bool = True) -> Tensor:
    """y = A' (.) x under the semiring: y[c] = add_r mul(A[r,c], x[r]) —
    with ``spmv`` the A'(Ax) correlation step, never forming A'A.
    ``sorted=False`` marks a RAW buffer and gates live slots by ``nnz``."""
    zero = sr_mod.integer_zero(sr, seg.dtype)
    valid = _live_slots(seg, sorted)
    gathered = _gather_x(x, seg.hi)
    prod = torch.where(valid, sr.mul(seg.val, gathered.to(seg.dtype)), zero)
    ids = torch.where(valid, seg.lo, num_cols)
    return _segment_reduce(sr, prod, ids, num_cols)


def to_dense(seg: AssocSegment, num_rows: int, num_cols: int,
             sr: Semiring = sr_mod.PLUS_TIMES, sorted: bool = True) -> Tensor:
    """Materialize the segment densely ([..., num_rows, num_cols]).

    Indexing follows the reference's scatter: a key in ``[-n, 0)`` wraps
    to ``key + n`` and a key outside ``[-n, n)`` is dropped.
    ``sorted=False`` marks a RAW buffer and gates live slots by ``nnz``."""
    r, c = seg.hi.long(), seg.lo.long()
    r = torch.where(r < 0, r + num_rows, r)
    c = torch.where(c < 0, c + num_cols, c)
    valid = _live_slots(seg, sorted) & (r >= 0) & (r < num_rows) \
        & (c >= 0) & (c < num_cols)
    flat = _segment_reduce(sr, seg.val, torch.where(valid, r * num_cols + c,
                                                    -1),
                           num_rows * num_cols)
    return flat.reshape(seg.hi.shape[:-1] + (num_rows, num_cols))


def total(seg: AssocSegment, sr: Semiring = sr_mod.PLUS_TIMES,
          sorted: bool = True) -> Tensor:
    """Reduce every live value with ``sr.add`` (per instance for a batch).
    ``sorted=False`` marks a RAW buffer and gates live slots by ``nnz``."""
    zero = sr_mod.integer_zero(sr, seg.dtype)
    vals = torch.where(_live_slots(seg, sorted), seg.val, zero)
    kind = sr_mod.reduce_kind(sr)
    if kind == "sum":
        return torch.sum(vals, dim=-1, dtype=seg.dtype)
    return torch.amax(vals, dim=-1) if kind == "max" \
        else torch.amin(vals, dim=-1)
