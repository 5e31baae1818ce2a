"""Batched point queries over the LIVE hierarchy — the read side of D4M.

This module serves point queries against a single-instance
``hier.HierAssoc`` WITHOUT flushing or merging it:

  * every canonical layer (1..L-1, and layer 0 when it is canonical) is a
    sorted run, so a Q-vector of point queries is answered with one
    vectorized lexicographic binary search per layer — O(L * Q * log C)
    instead of ``query_all``'s full-width merge;
  * layer 0 may be a lazy APPEND buffer (unsorted, duplicated keys); it is
    served by a masked raw scan for small query batches and by ONE
    canonicalization of just that buffer (the multi-way merge kernel with
    ``use_kernel``) for large ones (``_l0_runs`` picks; ``l0_mode``
    overrides);
  * per-layer hits are combined with the semiring, which is exact without
    any dedup: ``add`` across layers is exactly how a merge would have
    combined a key's duplicates.

State is never mutated — queries interleave freely with ingest steps.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch import stages
from repro_torch.core import assoc
from repro_torch.core import semiring as sr_mod
from repro_torch.core.assoc import AssocSegment
from repro_torch.core.semiring import Semiring

Tensor = torch.Tensor

# Raw-scan vs canonicalize-first crossover for the layer-0 buffer: the
# masked scan costs O(Q * C0), one canonicalization + searchsorted costs
# O(C0 log C0 + Q log C0).  The factor absorbs the scan's cheaper per-element
# constant (compare+select vs sort compare-exchange).
_L0_SCAN_FACTOR = 4


def reduce_axis(sr: Semiring, vals: Tensor, axis: int) -> Tensor:
    """Reduce a tensor of semiring values along ``axis`` with ``sr.add``."""
    kind = sr_mod.reduce_kind(sr)
    if kind == "sum":
        return torch.sum(vals, dim=axis)
    return torch.amax(vals, dim=axis) if kind == "max" \
        else torch.amin(vals, dim=axis)


def searchsorted_pair(seg_hi: Tensor, seg_lo: Tensor, q_hi: Tensor,
                      q_lo: Tensor) -> Tensor:
    """Leftmost index p with (seg_hi[p], seg_lo[p]) >= (q_hi, q_lo), per query.

    Vectorized lexicographic lower-bound binary search over one canonical
    run: the (hi, lo) int32 key pair is compared directly.  O(log C) steps,
    each a [Q]-wide gather + compare.
    """
    C = seg_hi.shape[-1]
    n_iter = max(int(math.ceil(math.log2(C + 1))), 1)
    lo_b = torch.zeros(q_hi.shape, dtype=torch.int64, device=q_hi.device)
    hi_b = torch.full(q_hi.shape, C, dtype=torch.int64, device=q_hi.device)
    for _ in range(n_iter):
        mid = (lo_b + hi_b) // 2
        mid_c = torch.clamp(mid, max=C - 1)
        mh = seg_hi[mid_c]
        ml = seg_lo[mid_c]
        less = (mh < q_hi) | ((mh == q_hi) & (ml < q_lo))
        # A converged search (lo == hi) must be a fixed point of the loop:
        # the iteration count is fixed, so without this guard a query above
        # every key re-reads slot C-1 after converging at C and overshoots
        # to C+1 (any power-of-two C).  Guarding keeps the result <= C.
        less = less & (lo_b < hi_b)
        lo_b, hi_b = torch.where(less, mid + 1, lo_b), \
            torch.where(less, hi_b, mid)
    return lo_b.to(torch.int32)


def segment_point_lookup(seg: AssocSegment, rows: Tensor, cols: Tensor,
                         sr: Semiring = sr_mod.PLUS_TIMES) -> Tensor:
    """Point hits against one canonical run via binary search."""
    zero = sr_mod.integer_zero(sr, seg.dtype)
    p = searchsorted_pair(seg.hi, seg.lo, rows, cols).long()
    p_c = torch.clamp(p, max=seg.capacity - 1)
    hit = (seg.hi[p_c] == rows) & (seg.lo[p_c] == cols)
    return torch.where(hit, seg.val[p_c], zero)


def _raw_point(seg: AssocSegment, rows: Tensor, cols: Tensor, sr: Semiring
               ) -> Tensor:
    """Point hits against a RAW buffer: [Q, C] masked scan; duplicate keys
    combine under ``sr.add`` (sum for the lazy plus.times buffer)."""
    zero = sr_mod.integer_zero(sr, seg.dtype)
    live = torch.arange(seg.capacity, device=seg.device) < seg.nnz
    m = (seg.hi[None, :] == rows[:, None]) \
        & (seg.lo[None, :] == cols[:, None]) & live[None, :]
    vals = torch.where(m, seg.val[None, :], zero)
    return reduce_axis(sr, vals, axis=1)


def _l0_runs(h, q: int, sr: Semiring, use_kernel: bool, l0_mode: str
             ) -> Tuple[Tuple[AssocSegment, ...], AssocSegment | None]:
    """Split the hierarchy into (sorted runs, raw layer-0 buffer or None).

    Layer 0 is ALWAYS treated as potentially raw (a canonical layer 0 is a
    valid raw buffer).  ``l0_mode``:

      * ``"scan"``  — serve layer 0 by masked raw scan (O(Q * C0));
      * ``"canon"`` — canonicalize JUST the layer-0 buffer (one merge, no
        cross-layer merge) and serve it as a sorted run like the others;
      * ``"auto"``  — pick by static cost: scan for small Q, canon once
        the scan's Q * C0 work passes the sort's C0 log C0.
    """
    l0 = h.layers[0]
    if l0_mode == "auto":
        c0 = l0.capacity
        l0_mode = "scan" if q <= _L0_SCAN_FACTOR * math.log2(c0 + 1) \
            else "canon"
    if l0_mode == "scan":
        return tuple(h.layers[1:]), l0
    canon, _ = assoc.merge_many((), l0.hi, l0.lo, l0.val,
                                out_capacity=l0.capacity, sr=sr,
                                use_kernel=use_kernel)
    return (canon,) + tuple(h.layers[1:]), None


def point_lookup(h, rows, cols, sr: Semiring = sr_mod.PLUS_TIMES,
                 use_kernel: bool = False, l0_mode: str = "auto") -> Tensor:
    """Q-vector point queries against the live hierarchy.

    ``rows``/``cols`` may be scalars or [Q] vectors; returns the semiring
    value of each key combined across every layer (exactly what
    ``assoc.lookup(query_all(h), r, c)`` returns, without the merge).
    """
    sig = stages.signature_for_state(h, sr=sr, use_kernel=use_kernel,
                                     l0_mode=l0_mode)
    sr = sr_mod.get(sig.sr)
    rows = torch.atleast_1d(torch.as_tensor(rows, device=h.device)
                            .to(torch.int32))
    cols = torch.atleast_1d(torch.as_tensor(cols, device=h.device)
                            .to(torch.int32))
    rows, cols = torch.broadcast_tensors(rows, cols)
    runs, raw = _l0_runs(h, rows.shape[0], sr, use_kernel,
                         sig.l0_mode or "auto")
    zero = sr_mod.integer_zero(sr, h.layers[0].dtype)
    out = torch.full(rows.shape, zero, dtype=h.layers[0].dtype,
                     device=h.device)
    for seg in runs:
        out = sr.add(out, segment_point_lookup(seg, rows, cols, sr))
    if raw is not None:
        out = sr.add(out, _raw_point(raw, rows, cols, sr))
    return out


def lookup(h, row, col, sr: Semiring = sr_mod.PLUS_TIMES,
           use_kernel: bool = False, l0_mode: str = "auto") -> Tensor:
    """Scalar-or-vector point lookup; scalar inputs return a scalar."""
    scalar = torch.as_tensor(row).dim() == 0 and torch.as_tensor(col).dim() == 0
    out = point_lookup(h, row, col, sr=sr, use_kernel=use_kernel,
                       l0_mode=l0_mode)
    return out[0] if scalar else out
