"""Batched query engine over the LIVE hierarchy — the read side of D4M.

This module serves point, row and row-range queries against a
``hier.HierAssoc`` WITHOUT flushing or merging it:

  * every canonical layer (1..L-1, and layer 0 when it is canonical) is a
    sorted run, so a Q-vector of point queries is answered with one
    vectorized lexicographic lower-bound search per layer —
    O(L * Q * log C) instead of ``query_all``'s full-width merge;
  * layer 0 may be a lazy APPEND buffer (unsorted, duplicated keys); it is
    served by a masked raw scan for small query batches and by ONE
    canonicalization of just that buffer (the multi-way merge kernel with
    ``use_kernel``) for large ones (``_l0_runs`` picks; ``l0_mode``
    overrides);
  * per-layer hits are combined with the semiring, which is exact without
    any dedup: ``add`` across layers is exactly how a merge would have
    combined a key's duplicates.

Every query takes a single instance (layers [C], queries [Q], results [Q]
or [Q, num_cols]) or an instance batch (layers [I, C], queries [Q] shared
by every instance or [I, Q], results [I, Q] or [I, Q, num_cols]): the
port's counterpart of ``jax.vmap`` over the instance axis.  The searches
read every instance at once; only the canon-mode canonicalization of
layer 0 runs once per instance (the merge wrapper takes one block).

State is never mutated — queries interleave freely with ingest steps.
``point_lookup``, ``extract_rows`` and ``range_total`` dispatch through
``stages`` under the reference's entry names (eager; the service's
instance-batched point query, ``query/service.py``, is the captured one).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch import stages
from repro_torch.analysis import contracts
from repro_torch.core import assoc
from repro_torch.core import semiring as sr_mod
from repro_torch.core.assoc import SENTINEL, AssocSegment
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
        return torch.sum(vals, dim=axis, dtype=vals.dtype)
    return torch.amax(vals, dim=axis) if kind == "max" \
        else torch.amin(vals, dim=axis)


def _per_instance(q: Tensor, lead: torch.Size) -> Tensor:
    """Queries [Q] shared by every instance, as [..., Q] over ``lead``."""
    if q.dim() == len(lead) + 1:
        return q
    return q.expand(lead + q.shape[-1:])


def _lower_bound(keys: Tensor, q: Tensor) -> Tensor:
    """Leftmost int64 index p with keys[..., p] >= q[..., j] over sorted
    packed keys [..., C]; never above C."""
    return torch.searchsorted(keys, _per_instance(q, keys.shape[:-1])
                              .contiguous())


def searchsorted_pair(seg_hi: Tensor, seg_lo: Tensor, q_hi: Tensor,
                      q_lo: Tensor) -> Tensor:
    """Leftmost index p with (seg_hi[p], seg_lo[p]) >= (q_hi, q_lo), per query.

    Lexicographic lower bound over one canonical run (or one per instance:
    [..., C] runs, [Q] or [..., Q] queries).  The (hi, lo) int32 pair is
    packed into one order-preserving int64 (``assoc.pack_key``) and
    searched with ``torch.searchsorted`` — one launch where the reference's
    fixed-count binary search takes ~15 steps of gathers and compares.
    The result stays <= C by construction when nnz == C, which the span and
    prefix gathers of ``extract_rows`` and ``range_total`` rely on.
    """
    return _lower_bound(assoc.pack_key(seg_hi, seg_lo),
                        assoc.pack_key(q_hi, q_lo)).to(torch.int32)


def _take(x: Tensor, idx: Tensor) -> Tensor:
    """``x[..., idx]`` per leading index (idx [..., K] or [..., Q, K])."""
    lead = x.shape[:-1]
    flat = idx.reshape(lead + (-1,))
    return torch.gather(x, -1, flat).reshape(idx.shape)


def segment_point_lookup(seg: AssocSegment, rows: Tensor, cols: Tensor,
                         sr: Semiring = sr_mod.PLUS_TIMES) -> Tensor:
    """Point hits against one canonical run via binary search."""
    zero = sr_mod.integer_zero(sr, seg.dtype)
    keys = assoc.pack_key(seg.hi, seg.lo)
    q = _per_instance(assoc.pack_key(rows, cols), keys.shape[:-1])
    p_c = torch.clamp(_lower_bound(keys, q), max=seg.capacity - 1)
    hit = _take(keys, p_c) == q
    return torch.where(hit, _take(seg.val, p_c), zero)


def _live(seg: AssocSegment) -> Tensor:
    """The raw-buffer live-slot gate ``arange(C) < nnz`` ([..., C])."""
    return torch.arange(seg.capacity, device=seg.device) \
        < seg.nnz.unsqueeze(-1)


def _raw_point(seg: AssocSegment, rows: Tensor, cols: Tensor, sr: Semiring
               ) -> Tensor:
    """Point hits against a RAW buffer: [..., Q, C] masked scan; duplicate
    keys combine under ``sr.add`` (sum for the lazy plus.times buffer)."""
    zero = sr_mod.integer_zero(sr, seg.dtype)
    keys = assoc.pack_key(seg.hi, seg.lo)
    q = _per_instance(assoc.pack_key(rows, cols), keys.shape[:-1])
    m = (keys.unsqueeze(-2) == q.unsqueeze(-1)) & _live(seg).unsqueeze(-2)
    vals = torch.where(m, seg.val.unsqueeze(-2), zero)
    return reduce_axis(sr, vals, axis=-1)


def _canonical_l0(l0: AssocSegment, sr: Semiring, use_kernel: bool
                  ) -> AssocSegment:
    """The layer-0 buffer canonicalized: one ``assoc.merge_many`` (the
    ``merge_multi`` kernel with ``use_kernel``) per instance."""
    lead = l0.hi.shape[:-1]
    if not lead:
        return assoc.merge_many((), l0.hi, l0.lo, l0.val,
                                out_capacity=l0.capacity, sr=sr,
                                use_kernel=use_kernel)[0]
    flat = [x.reshape((-1,) + x.shape[len(lead):])
            for x in (l0.hi, l0.lo, l0.val)]
    segs = [assoc.merge_many((), flat[0][i], flat[1][i], flat[2][i],
                             out_capacity=l0.capacity, sr=sr,
                             use_kernel=use_kernel)[0]
            for i in range(math.prod(lead))]
    return AssocSegment(*(torch.stack([getattr(s, f) for s in segs])
                          .reshape(lead + getattr(segs[0], f).shape)
                          for f in ("hi", "lo", "val", "nnz")))


def _l0_runs(h, q: int, sr: Semiring, use_kernel: bool, l0_mode: str
             ) -> Tuple[Tuple[AssocSegment, ...], AssocSegment | None]:
    """Split the hierarchy into (sorted runs, raw layer-0 buffer or None).

    Layer 0 is ALWAYS treated as potentially raw (a canonical layer 0 is a
    valid raw buffer).  ``l0_mode``:

      * ``"scan"``  — serve layer 0 by masked raw scan (O(Q * C0));
      * ``"canon"`` — canonicalize JUST the layer-0 buffer (one merge per
        instance, no cross-layer merge) and serve it as a sorted run like
        the others;
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
    return (_canonical_l0(l0, sr, use_kernel),) + tuple(h.layers[1:]), None


def _queries(h, *qs) -> Tuple[Tensor, ...]:
    """int32 query vectors on the state's device, broadcast together, at
    least 1-D."""
    qs = [torch.atleast_1d(torch.as_tensor(x, device=h.device)
                           .to(torch.int32)) for x in qs]
    return tuple(torch.broadcast_tensors(*qs))


def _lead(h) -> torch.Size:
    """The instance axes of a state: () for one instance, (I,) for a
    batch."""
    return h.layers[0].hi.shape[:-1]


def point_lookup(h, rows, cols, sr: Semiring = sr_mod.PLUS_TIMES,
                 use_kernel: bool = False, l0_mode: str = "auto") -> Tensor:
    """Q-vector point queries against the live hierarchy.

    ``rows``/``cols`` may be scalars or [Q] vectors ([I, Q] per instance of
    a batch); returns the semiring value of each key combined across every
    layer (exactly what ``assoc.lookup(query_all(h), r, c)`` returns,
    without the merge): [Q], or [I, Q] for a batch.

    Under ``REPRO_CHECK=1`` the hierarchy is checked before serving —
    layer 0 on the raw-buffer contract only, since the engine never trusts
    its order — and the layer-0 canonicalization is deep-checked.
    """
    sig = stages.signature_for_state(h, sr=sr, use_kernel=use_kernel,
                                     l0_mode=l0_mode)
    rows, cols = _queries(h, rows, cols)
    return point_lookup_wrapped(contracts.front_door_signature(sig))(
        h, rows, cols)


def _checked_query(run, sr: Semiring, name: str):
    """The checked build of a query program: the input hierarchy checked
    (layer 0 on the raw-buffer contract only — the engine never trusts its
    order) and every canonicalization inside deep-checked."""
    def checked(h, *args):
        return contracts.checked(f"query.engine.{name}", h, sr,
                                 lambda: run(h, *args), l0_sorted=False)
    return checked


def point_lookup_wrapped(sig: stages.Signature) -> stages.Wrapped:
    """Keyed Q-vector point-query program for one config signature
    (eager).  A signature carrying ``contracts.DEBUG_EXTRA`` keys the
    checked build."""
    sr = sr_mod.get(sig.sr)

    def run(h, rows, cols):
        return _point_lookup(h, rows, cols, sr, sig.use_kernel, sig.l0_mode)

    if contracts.sig_debug(sig):
        return stages.wrap(_checked_query(run, sr, "point_lookup"),
                           "query.engine.point_lookup", sig)
    return stages.wrap(run, "query.engine.point_lookup", sig)


def _point_lookup(h, rows, cols, sr: Semiring, use_kernel: bool,
                  l0_mode) -> Tensor:
    rows, cols = _queries(h, rows, cols)
    lead = _lead(h)
    rows, cols = _per_instance(rows, lead), _per_instance(cols, lead)
    runs, raw = _l0_runs(h, rows.shape[-1], sr, use_kernel,
                         l0_mode or "auto")
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
    """Scalar-or-vector point lookup; scalar inputs return a scalar (one
    per instance for a batch)."""
    scalar = torch.as_tensor(row).dim() == 0 and torch.as_tensor(col).dim() == 0
    out = point_lookup(h, row, col, sr=sr, use_kernel=use_kernel,
                       l0_mode=l0_mode)
    return out[..., 0] if scalar else out


def _row_span(seg: AssocSegment, rows: Tensor,
              num_cols: int | None = None) -> Tuple[Tensor, Tensor]:
    """[start, end) int64 index span of each query row inside one
    canonical run.

    With ``num_cols`` the end bounds only the IN-VIEW entries (col <
    num_cols) — cols are the minor sort key, so a row's in-view entries
    are the contiguous prefix of its span."""
    keys = assoc.pack_key(seg.hi, seg.lo)
    zeros = torch.zeros_like(rows)
    s = _lower_bound(keys, assoc.pack_key(rows, zeros))
    if num_cols is None:
        e = _lower_bound(keys, assoc.pack_key(rows + 1, zeros))
    else:
        e = _lower_bound(keys, assoc.pack_key(rows, zeros + num_cols))
    return s, e


def extract_rows(h, rows, num_cols: int, *,
                 sr: Semiring = sr_mod.PLUS_TIMES,
                 width: int | None = None,
                 use_kernel: bool = False,
                 l0_mode: str = "auto") -> Tuple[Tensor, Tensor]:
    """Dense row extraction: values[q, c] = merged A[rows[q], c].

    Per canonical layer the row's entries are a CONTIGUOUS span (hi is the
    major sort key): two searches bound it and a fixed ``width`` window is
    gathered and semiring-scattered into the dense output —
    O(L * Q * (log C + W)) with W = ``width``.  The default width
    ``min(C, num_cols)`` can never truncate; a smaller width trades
    exactness for speed and reports dropped in-view entries in the returned
    ``truncated`` count per query.  Entries whose column key is >=
    ``num_cols`` fall outside the dense view and are EXCLUDED (never
    counted as truncated).

    Returns ``(dense [Q, num_cols], truncated int32[Q])``, with a leading
    instance axis for a batch.
    """
    sig = stages.signature_for_state(
        h, sr=sr, use_kernel=use_kernel, l0_mode=l0_mode,
        extra=(("num_cols", int(num_cols)),
               ("width", None if width is None else int(width))))
    rows = _queries(h, rows)[0]
    return extract_rows_wrapped(contracts.front_door_signature(sig))(h, rows)


def extract_rows_wrapped(sig: stages.Signature) -> stages.Wrapped:
    """Keyed dense-row-extraction program for one config signature
    (``num_cols``/``width`` ride in ``sig.extra``; eager)."""
    sr = sr_mod.get(sig.sr)
    statics = dict(sig.extra)

    def run(h, rows):
        return _extract_rows(h, rows, statics["num_cols"], sr,
                             statics["width"], sig.use_kernel,
                             sig.l0_mode)

    if contracts.sig_debug(sig):
        return stages.wrap(_checked_query(run, sr, "extract_rows"),
                           "query.engine.extract_rows", sig)
    return stages.wrap(run, "query.engine.extract_rows", sig)


def _extract_rows(h, rows, num_cols: int, sr: Semiring, width,
                  use_kernel: bool, l0_mode) -> Tuple[Tensor, Tensor]:
    lead = _lead(h)
    rows = _per_instance(rows, lead)
    q = rows.shape[-1]
    dev = h.device
    # flat index of each query row's first column in the [..., Q, num_cols]
    # output
    base = (torch.arange(math.prod(lead) * q, device=dev)
            .reshape(lead + (q, 1)) * num_cols)
    ids, vals = [], []
    truncated = torch.zeros(rows.shape, dtype=torch.int32, device=dev)

    def add(cc, vv, in_view):
        # the reference's scatter wraps a column in [-num_cols, 0) and
        # drops anything outside [-num_cols, num_cols)
        cc = cc.long()
        cc = torch.where(cc < 0, cc + num_cols, cc)
        in_view = in_view & (cc >= 0)
        ids.append(torch.where(in_view, base + cc, -1).reshape(-1))
        vals.append(vv.reshape(-1))

    runs, raw = _l0_runs(h, q, sr, use_kernel, l0_mode or "auto")
    for seg in runs:
        C = seg.capacity
        w = min(C, num_cols) if width is None else min(width, C)
        # the span end bounds only in-view entries (col < num_cols): the
        # excluded-by-design out-of-view tail must not count as truncation
        s, e = _row_span(seg, rows, num_cols)
        idx = s.unsqueeze(-1) + torch.arange(w, device=dev)
        valid = idx < e.unsqueeze(-1)
        idx_c = torch.clamp(idx, max=C - 1)
        cc = _take(seg.lo, idx_c)
        add(cc, _take(seg.val, idx_c), valid & (cc < num_cols))
        truncated += torch.clamp(e - s - w, min=0).to(torch.int32)
    if raw is not None:
        m = (raw.hi.unsqueeze(-2) == rows.unsqueeze(-1)) \
            & _live(raw).unsqueeze(-2)
        cc = raw.lo.unsqueeze(-2).expand(m.shape)
        add(cc, raw.val.unsqueeze(-2).expand(m.shape), m & (cc < num_cols))
    dense = sr.segment_add(torch.cat(vals), torch.cat(ids),
                           base.numel() * num_cols)
    return dense.reshape(lead + (q, num_cols)), truncated


def range_total(h, row_lo, row_hi, sr: Semiring = sr_mod.PLUS_TIMES,
                use_kernel: bool = False, l0_mode: str = "auto") -> Tensor:
    """Semiring total of every entry with row key in [row_lo, row_hi).

    Exact without dedup for the same reason as ``point_lookup``.
    plus.times takes a difference of prefix sums per layer (a [..., C + 1]
    ``cumsum`` once, O(1) per query after the search), as the reference
    does, so float rounding follows it; the idempotent semirings reduce a
    masked [..., Q, C] (max/min have no subtractive prefix trick).
    Returns [Q], or [I, Q] for a batch.
    """
    sig = stages.signature_for_state(h, sr=sr, use_kernel=use_kernel,
                                     l0_mode=l0_mode)
    row_lo, row_hi = _queries(h, row_lo, row_hi)
    return range_total_wrapped(contracts.front_door_signature(sig))(
        h, row_lo, row_hi)


def range_total_wrapped(sig: stages.Signature) -> stages.Wrapped:
    """Keyed row-range reduction program for one config signature
    (eager)."""
    sr = sr_mod.get(sig.sr)

    def run(h, row_lo, row_hi):
        return _range_total(h, row_lo, row_hi, sr, sig.use_kernel,
                            sig.l0_mode)

    if contracts.sig_debug(sig):
        return stages.wrap(_checked_query(run, sr, "range_total"),
                           "query.engine.range_total", sig)
    return stages.wrap(run, "query.engine.range_total", sig)


def _range_total(h, row_lo, row_hi, sr: Semiring, use_kernel: bool,
                 l0_mode) -> Tensor:
    lead = _lead(h)
    row_lo, row_hi = _per_instance(row_lo, lead), _per_instance(row_hi, lead)
    vdtype = h.layers[0].dtype
    zero = sr_mod.integer_zero(sr, vdtype)
    out = torch.full(row_lo.shape, zero, dtype=vdtype, device=h.device)
    runs, raw = _l0_runs(h, row_lo.shape[-1], sr, use_kernel,
                         l0_mode or "auto")

    def masked(seg, gate):
        hi = seg.hi.unsqueeze(-2)
        m = (hi >= row_lo.unsqueeze(-1)) & (hi < row_hi.unsqueeze(-1)) \
            & (hi != SENTINEL) & gate
        return reduce_axis(sr, torch.where(m, seg.val.unsqueeze(-2), zero),
                           axis=-1)

    for seg in runs:
        if sr.name == "plus.times":
            # canonical sentinel slots hold the zero value: cumsum is safe
            prefix = torch.cat([torch.zeros(lead + (1,), dtype=seg.dtype,
                                            device=h.device),
                                torch.cumsum(seg.val, -1, dtype=seg.dtype)],
                               -1)
            keys = assoc.pack_key(seg.hi, seg.lo)
            zeros = torch.zeros_like(row_lo)
            s = _lower_bound(keys, assoc.pack_key(row_lo, zeros))
            e = _lower_bound(keys, assoc.pack_key(row_hi, zeros))
            out = out + (_take(prefix, e) - _take(prefix, s))
        else:
            out = sr.add(out, masked(seg, True))
    if raw is not None:
        out = sr.add(out, masked(raw, _live(raw).unsqueeze(-2)))
    return out
