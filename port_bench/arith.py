"""The benchmark's arithmetic: exact percentiles, the chip's peaks, the
bytes an ingest needs, and interval unions of a device trace.  Plain
Python and NumPy; nothing of the program."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"
ENTRY_BYTES = 12          # int32 row, int32 col, float32 value


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0..100) of all ``values``, by linear
    interpolation between the two nearest ranks."""
    x = np.sort(np.asarray(values, dtype=np.float64))
    if x.size == 0:
        raise ValueError("percentile of no values")
    pos = (x.size - 1) * q / 100.0
    lo = int(np.floor(pos))
    hi = min(lo + 1, x.size - 1)
    return float(x[lo] + (x[hi] - x[lo]) * (pos - lo))


def peaks(device_name: str):
    """The chip's published peaks (``bytes_per_s``, ...) by its name, or
    None for a chip the table does not hold."""
    table = json.loads(PEAKS_FILE.read_text())
    return table.get(device_name)


def merge_traffic(nnz_start, nnz_end, nnz0, depth, block: int):
    """Entries one ingest call's merges and appends need to move, from
    counters the program keeps: the layers' ``nnz`` before and after the
    call (``[I, L]``), and per step the layer-0 slots after it
    (``nnz0``, ``[I, T]``) and its spill depth (``[I, T]``, 0 = append).

    Returns ``(appended, read, written)`` entry counts.  An append reads
    and writes its block.  A merge at depth ``d`` reads the block, layer
    0's slots and layers 1..d, and writes its unique result into layer d.
    A layer's size between two merges of one call is not observable: the
    last one seen stands in for it (a merge never shrinks a layer, so it
    is a lower bound), and a merge's result counts as layer d's size at
    the call's end where no later step of the call merged into or cleared
    layer d, else as that lower bound."""
    nnz_start = np.asarray(nnz_start, dtype=np.int64)
    nnz_end = np.asarray(nnz_end, dtype=np.int64)
    nnz0 = np.asarray(nnz0, dtype=np.int64)
    depth = np.asarray(depth, dtype=np.int64)
    n_inst, steps = depth.shape
    appended = read = written = 0
    for i in range(n_inst):
        known = nnz_start[i].copy()
        for t in range(steps):
            d = int(depth[i, t])
            if d == 0:
                appended += block
                continue
            l0 = nnz0[i, t - 1] if t else nnz_start[i, 0]
            read += block + int(l0) + int(known[1:d + 1].sum())
            later = bool((depth[i, t + 1:] >= d).any())
            out = int(known[d]) if later else int(nnz_end[i, d])
            written += out
            known[1:d] = 0
            known[d] = out
    return appended, read, written


def union_length(starts, ends, lo: float, hi: float) -> float:
    """Length of the union of intervals ``[starts, ends)`` clipped to
    ``[lo, hi)``."""
    merged = merged_intervals(starts, ends, lo, hi)
    return float(sum(e - s for s, e in merged))


def merged_intervals(starts, ends, lo: float, hi: float):
    """The union of intervals clipped to ``[lo, hi)``, as sorted disjoint
    (start, end) pairs."""
    s = np.clip(np.asarray(starts, dtype=np.float64), lo, hi)
    e = np.clip(np.asarray(ends, dtype=np.float64), lo, hi)
    keep = e > s
    s, e = s[keep], e[keep]
    if s.size == 0:
        return []
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(s.size, dtype=bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, s.size - 1)
    return list(zip(s[first].tolist(), reach[last].tolist()))
