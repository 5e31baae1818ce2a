"""Streaming network analytics over the live hierarchy.

Traffic-matrix statistics (degrees, heavy hitters) computed WHILE the
fleet ingests, composed from per-layer reductions so the merged array is
never materialized:

    stat(merge(layers)) == sr-combine_i stat(layer_i)

which holds for every reduction here because ``sr.add`` across a key's
per-layer copies is exactly the merge's combine (sum under plus.times;
max/min are idempotent), and every contraction used (``reduce_rows``,
``reduce_cols``, ``spmv``, ``spmv_t``) is linear in that sense.  The lazy
layer-0 append buffer IS a raw buffer, so layer 0 always reduces with
``sorted=False``, which gates live slots by ``nnz`` (``assoc._live_slots``)
instead of trusting slots past ``nnz`` to hold sentinel keys / zero values.

Every function takes a single instance or an instance batch ([I, C]
layers; results gain a leading [I] axis): a batched reduction is one
scatter per layer, instance i's ids offset by ``i * (n + 1)`` into a flat
output (``assoc._segment_reduce``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import assoc
from repro_torch.core import semiring as sr_mod
from repro_torch.core.semiring import Semiring

Tensor = torch.Tensor


def _layer_combine(sr: Semiring, parts) -> Tensor:
    out = parts[0]
    for p in parts[1:]:
        out = sr.add(out, p)
    return out


def out_degrees(h, num_rows: int, sr: Semiring = sr_mod.PLUS_TIMES) -> Tensor:
    """Per-row totals (weighted out-degrees under plus.times) without
    merging: layer-wise ``assoc.reduce_rows`` + semiring combine, layer 0
    reduced as a RAW buffer (sorted=False)."""
    parts = [assoc.reduce_rows(h.layers[0], num_rows, sr, sorted=False)]
    parts += [assoc.reduce_rows(l, num_rows, sr) for l in h.layers[1:]]
    return _layer_combine(sr, parts)


def in_degrees(h, num_cols: int, sr: Semiring = sr_mod.PLUS_TIMES) -> Tensor:
    """Per-column totals (weighted in-degrees under plus.times); layer 0
    reduces as a RAW buffer (sorted=False) for the ``nnz`` live-slot
    gate."""
    parts = [assoc.reduce_cols(h.layers[0], num_cols, sr, sorted=False)]
    parts += [assoc.reduce_cols(l, num_cols, sr) for l in h.layers[1:]]
    return _layer_combine(sr, parts)


def degree_vectors(h, num_rows: int, num_cols: int,
                   sr: Semiring = sr_mod.PLUS_TIMES) -> Tuple[Tensor, Tensor]:
    """(out_degrees, in_degrees) — the traffic-matrix row/col statistics,
    no merge."""
    return out_degrees(h, num_rows, sr), in_degrees(h, num_cols, sr)


def row_occupancy(h, num_rows: int) -> Tensor:
    """Number of live stored entries per row across every layer (layer 0
    counted as a raw buffer, so duplicate keys count per slot), int32.
    Zero means the row was never touched — the mask ``top_k_rows`` needs,
    because a row's semiring TOTAL cannot distinguish "never updated" from
    "updates summing to the add identity"."""
    total = None
    for i, l in enumerate(h.layers):
        valid = assoc._live_slots(l, sorted=i > 0)
        ids = torch.where(valid, l.hi, num_rows)
        part = assoc._segment_reduce(sr_mod.PLUS_TIMES,
                                     valid.to(torch.int32), ids, num_rows)
        total = part if total is None else total + part
    return total


# tracekit: allow(J005) entry=service.analytics the rank key: score, index
def _order_key(score: Tensor) -> Tensor:
    """int64 key whose order is the total order of ``score`` (float32 by
    its bits, so -0.0 < 0.0 as in ``lax.top_k``; int32 as is) in the high
    word and the complemented index in the low word: among equal scores
    the lower index ranks first, as ``lax.top_k`` returns them.  float16
    and bfloat16 rank by their exact float32 values, 8- and 16-bit
    integers by their int32 values: both widenings preserve order."""
    if score.dtype in (torch.float16, torch.bfloat16):
        score = score.to(torch.float32)
    elif score.dtype in (torch.int8, torch.int16, torch.uint8):
        score = score.to(torch.int32)
    if score.dtype == torch.float32:
        bits = score.view(torch.int32)
        bits = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    elif score.dtype == torch.int32:
        bits = score
    else:
        raise TypeError(f"top_k_rows ranks float32, float16, bfloat16 or "
                        f"integer totals of at most 32 bits, got "
                        f"{score.dtype}")
    n = score.shape[-1]
    rank = (n - 1) - torch.arange(n, device=score.device)
    return (bits.to(torch.int64) << 32) + rank


def _top_k(score: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """``lax.top_k`` over the last axis: the k largest, ties in ascending
    index order; ids int32."""
    key = torch.topk(_order_key(score), k, dim=-1).values
    ids = (score.shape[-1] - 1) - (key & 0xFFFFFFFF)
    return torch.gather(score, -1, ids), ids.to(torch.int32)


def top_k_rows(h, num_rows: int, k: int,
               sr: Semiring = sr_mod.PLUS_TIMES) -> Tuple[Tensor, Tensor]:
    """Heavy hitters: the k EXTREMAL live rows by semiring row total (top
    talkers of the network traffic matrix).  Returns (totals, row ids),
    both [k] ([I, k] for a batch); ids int32.

    Untouched rows hold the semiring's add identity and are masked out via
    ``row_occupancy``.  Ordering follows the semiring's notion of extremal:
    descending totals for sum/max reductions, ASCENDING for min reductions.
    Equal totals come in ascending row order, as from ``lax.top_k``.  When
    fewer than ``k`` rows are live, the tail is padded with the dtype's
    worst-ranked value (``-inf``/``+inf`` for floats, the iinfo extremes
    for integer hierarchies — no float inf reaches an int tensor) and the
    lowest dead row ids.
    """
    deg = out_degrees(h, num_rows, sr)
    live = row_occupancy(h, num_rows) > 0
    if deg.dtype.is_floating_point:
        worst_max, worst_min = -float("inf"), float("inf")
    else:
        info = torch.iinfo(deg.dtype)
        worst_max, worst_min = info.min, info.max
    if sr_mod.reduce_kind(sr) == "min":
        score = torch.where(live, deg, worst_min)
        neg, ids = _top_k(-score, k)
        return -neg, ids
    return _top_k(torch.where(live, deg, worst_max), k)


def spmv(h, x: Tensor, num_rows: int,
         sr: Semiring = sr_mod.PLUS_TIMES) -> Tensor:
    """y = A (.) x against the live hierarchy: per-layer ``assoc.spmv``
    combined with the semiring (exact — ``mul`` distributes over the layer
    combine)."""
    parts = [assoc.spmv(h.layers[0], x, num_rows, sr, sorted=False)]
    parts += [assoc.spmv(l, x, num_rows, sr) for l in h.layers[1:]]
    return _layer_combine(sr, parts)


def spmv_t(h, x: Tensor, num_cols: int,
           sr: Semiring = sr_mod.PLUS_TIMES) -> Tensor:
    """y = A' (.) x against the live hierarchy (transpose contraction);
    layer 0 contracts as a RAW buffer (sorted=False)."""
    parts = [assoc.spmv_t(h.layers[0], x, num_cols, sr, sorted=False)]
    parts += [assoc.spmv_t(l, x, num_cols, sr) for l in h.layers[1:]]
    return _layer_combine(sr, parts)


def ata_correlation(h, x: Tensor, num_rows: int, num_cols: int,
                    sr: Semiring = sr_mod.PLUS_TIMES) -> Tensor:
    """One A'A correlation step applied to a vector: y = A'(A x), through
    the two-step contraction (never forming A'A or the merged A).  ``x``
    is [num_cols] (shared) or per instance; ``A x`` is per instance."""
    return spmv_t(h, spmv(h, x, num_rows, sr), num_cols, sr)
