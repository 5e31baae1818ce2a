"""The program's own spans and host-read counts in a traced run, set on
the device trace's clock.

``repro_torch.obs.trace.spans()`` holds the session the harness opened
around its traced window (``obs.enable`` before it, ``obs.disable``
after, before the readers run): every span with its start and end in
Unix-epoch ns, the clock ``torch.profiler``'s events carry, and the
host-read counts at both ends.  The program is imported lazily, as the
harness does; a program without spans reads None.

- **Alignment.**  The trace's ranges of the ``stream.ingest_instances``
  and ``service.point_query`` dispatches (``Trace.ranges``, seconds from
  the window's start) and the program's dispatch spans of the same names
  mark the same instants.  Their counts must agree; the offset is the
  median difference of their matched starts, and the median residual
  about it at most ``MAX_RESIDUAL_S``.
- **Scoping.**  Only the spans under ``stream.ingest_instances``
  dispatches count, the dispatch span itself included.
- **Idle attribution.**  Each gap between the trace's merged device
  intervals goes to the innermost scoped span open on the host when the
  gap began: the host work during which the queue ran dry.

Every function returns None where the spans are missing, dropped or
unaligned.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from port_bench import arith

MAX_RESIDUAL_S = 50e-6
INGEST = "stream.ingest_instances"
QUERY = "service.point_query"
DISPATCHES = (INGEST, QUERY)
PLAN = "stream.plan"
COHORT = ("stream.append", "stream.member", "assoc.merge")


def _collected():
    try:
        from repro_torch.obs import trace
    except ImportError:
        return None
    get = getattr(trace, "spans", None)
    return None if get is None else get()


def session(run) -> Optional[dict]:
    """The run's span session aligned with its trace: ``spans`` (each
    record with ``start`` and ``end`` in seconds from the window's
    start), ``host_reads``, ``offset_s`` and ``residual_s``."""
    if run.trace is None:
        return None
    got = _collected()
    if not got or got["dropped"]:
        return None
    records = got["spans"]
    if not records:
        return None
    base = min(r["start_ns"] for r in records)
    diffs = []
    for name in DISPATCHES:
        mine = np.sort(np.array([r["start_ns"] - base for r in records
                                 if r["name"] == name], dtype=np.float64))
        theirs = run.trace.ranges.get(name, (np.zeros(0),))[0]
        if mine.size != theirs.size:
            return None
        diffs.append(mine * 1e-9 - theirs)
    diffs = np.concatenate(diffs)
    if diffs.size == 0:
        return None
    offset = float(np.median(diffs))
    residual = float(np.median(np.abs(diffs - offset)))
    if residual > MAX_RESIDUAL_S:
        return None
    spans = [dict(r, start=(r["start_ns"] - base) * 1e-9 - offset,
                  end=(r["end_ns"] - base) * 1e-9 - offset)
             for r in records]
    return dict(spans=spans, host_reads=got["host_reads"],
                offset_s=offset, residual_s=residual)


def under_ingest(sess: dict) -> list:
    """The spans of ``stream.ingest_instances`` dispatches."""
    ids = {r["id"] for r in sess["spans"] if r["name"] == INGEST}
    return [r for r in sess["spans"] if r["dispatch"] in ids]


def idle_by_span(run) -> Optional[dict]:
    """Seconds of device idle in the traced window by the name of the
    innermost ingest-dispatch span open when each gap began (gaps begun
    outside every such span are left out)."""
    sess = session(run)
    if sess is None:
        return None
    _, s, e = run.trace.kernels
    busy = arith.merged_intervals(s, e, run.trace.t0, run.trace.t1)
    edges = [run.trace.t0] + [x for iv in busy for x in iv] \
        + [run.trace.t1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    return attribute(gaps, under_ingest(sess))


def attribute(gaps, spans) -> dict:
    """``{name: seconds}``: each gap ``(start, end)`` to the innermost of
    ``spans`` (records with ``start``, ``end``, ``name``, nested as one
    thread opens them) open at its start."""
    order = sorted(spans, key=lambda r: (r["start"], -r["end"]))
    out: dict = {}
    stack: list = []
    j = 0
    for a, b in sorted(gaps):
        while j < len(order) and order[j]["start"] <= a:
            while stack and stack[-1]["end"] <= order[j]["start"]:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and stack[-1]["end"] <= a:
            stack.pop()
        if stack:
            name = stack[-1]["name"]
            out[name] = out.get(name, 0.0) + (b - a)
    return out


def steps(run) -> int:
    """Fleet block-steps of the traced calls."""
    return sum(c["blocks"] for c in run.calls)


def sort_merges(run) -> Optional[list]:
    """The sort-route ``assoc.merge`` spans under ingest dispatches."""
    sess = session(run)
    if sess is None:
        return None
    return [r for r in under_ingest(sess) if r["name"] == "assoc.merge"
            and r["attrs"].get("route") == "sort"]
