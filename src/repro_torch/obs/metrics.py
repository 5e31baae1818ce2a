"""Process-wide metrics: counters, gauges, and mergeable log-bucket
histograms — plus the device-side fleet snapshot path.

The paper's headline number IS observability: a measured, sustained
aggregate update rate over a long run across many nodes.  Reproducing
that needs percentiles and rates that can be merged across instances and
processes after the fact, which rules out sorted-list percentiles.
``Histogram`` therefore uses FIXED log-spaced buckets
(``BUCKETS_PER_DECADE`` per factor of 10, anchored at ``HIST_MIN``): every
process bins into the identical edges, so merging is exact integer
addition and any percentile of the merged population is reproducible to
within one bucket's relative width, independent of merge order.  The
geometry and the payload schema are the JAX package's, so histograms of
either package merge, and the same histogram backs ``query.service``
latency reporting and ``obs.slo``.

The device side is ``fleet_sample(states)`` → ``hier.metrics_snapshot``:
the whole ``[I, ...]`` fleet reduced on the device, the host transfer
here, at the sampling boundary.  ``export_stages_gauges`` mirrors the
``stages`` front door's counters into gauges.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Optional

# Fixed bucket geometry — part of the on-disk schema (obs.jsonl carries
# it per histogram payload); changing these constants is a schema bump.
HIST_MIN = 1e-9
BUCKETS_PER_DECADE = 20
DECADES = 12
NUM_BUCKETS = BUCKETS_PER_DECADE * DECADES
_LOG10_MIN = math.log10(HIST_MIN)


def bucket_index(x: float) -> int:
    """Bucket for value ``x``: -1 underflow, ``NUM_BUCKETS`` overflow,
    else ``i`` covering ``[HIST_MIN * 10**(i/BPD), HIST_MIN * 10**((i+1)/BPD))``."""
    if x < HIST_MIN:
        return -1
    i = int(math.floor((math.log10(x) - _LOG10_MIN) * BUCKETS_PER_DECADE))
    # float roundoff at exact edges: nudge into the bucket that contains x
    if i < NUM_BUCKETS and x < bucket_edge(i):
        i -= 1
    elif i + 1 <= NUM_BUCKETS and x >= bucket_edge(i + 1):
        i += 1
    return min(i, NUM_BUCKETS)


def bucket_edge(i: int) -> float:
    """Lower edge of bucket ``i`` (so ``bucket_edge(NUM_BUCKETS)`` is the
    overflow threshold)."""
    return 10.0 ** (_LOG10_MIN + i / BUCKETS_PER_DECADE)


class Histogram:
    """Mergeable fixed-bucket log histogram.

    Sparse storage (``{bucket_index: count}``) keeps empty histograms and
    JSONL payloads tiny; exact ``count``/``total``/``min``/``max`` ride
    alongside so rates and extremes stay exact even though in-bucket
    positions are quantized.
    """

    SCHEMA = dict(v=1, min=HIST_MIN, bpd=BUCKETS_PER_DECADE,
                  decades=DECADES)

    def __init__(self):
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._lock = threading.Lock()

    def observe(self, x: float, n: int = 1) -> None:
        i = bucket_index(x)
        with self._lock:
            self.buckets[i] = self.buckets.get(i, 0) + n
            self.count += n
            self.total += x * n
            self.vmin = min(self.vmin, x)
            self.vmax = max(self.vmax, x)

    def merge(self, other: "Histogram") -> "Histogram":
        with other._lock:
            buckets = dict(other.buckets)
            count, total = other.count, other.total
            vmin, vmax = other.vmin, other.vmax
        with self._lock:
            for i, n in buckets.items():
                self.buckets[i] = self.buckets.get(i, 0) + n
            self.count += count
            self.total += total
            self.vmin = min(self.vmin, vmin)
            self.vmax = max(self.vmax, vmax)
        return self

    def percentile(self, q: float) -> float:
        """q-th percentile (0..100) by cumulative bucket walk + geometric
        in-bucket interpolation, clamped to the exact observed [min, max].
        Merge-order independent: depends only on the bucket counts."""
        with self._lock:
            if self.count == 0:
                return math.nan
            target = q / 100.0 * self.count
            seen = 0
            for i in sorted(self.buckets):
                n = self.buckets[i]
                if seen + n >= target:
                    if i < 0:
                        return self.vmin
                    if i >= NUM_BUCKETS:
                        return self.vmax
                    frac = (target - seen) / n
                    lo, hi = bucket_edge(i), bucket_edge(i + 1)
                    val = lo * (hi / lo) ** frac
                    return min(max(val, self.vmin), self.vmax)
                seen += n
            return self.vmax

    def mean(self) -> float:
        with self._lock:
            return self.total / self.count if self.count else math.nan

    def summary(self) -> dict:
        return dict(count=self.count, mean=self.mean(),
                    p50=self.percentile(50), p95=self.percentile(95),
                    p99=self.percentile(99),
                    min=self.vmin if self.count else math.nan,
                    max=self.vmax if self.count else math.nan)

    def to_dict(self) -> dict:
        """JSON-ready payload: sparse buckets + schema meta, so a monitor
        aggregating N processes can verify the bucket geometry matches
        before merging."""
        with self._lock:
            return dict(schema=dict(self.SCHEMA),
                        buckets={str(i): n for i, n in self.buckets.items()},
                        count=self.count, total=self.total,
                        min=None if self.count == 0 else self.vmin,
                        max=None if self.count == 0 else self.vmax)

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        if dict(d.get("schema", {})) != cls.SCHEMA:
            raise ValueError(f"histogram schema mismatch: {d.get('schema')}"
                             f" != {cls.SCHEMA}")
        h = cls()
        h.buckets = {int(i): int(n) for i, n in d.get("buckets", {}).items()}
        h.count = int(d.get("count", 0))
        h.total = float(d.get("total", 0.0))
        if h.count:
            h.vmin = float(d["min"])
            h.vmax = float(d["max"])
        return h


class Registry:
    """Process-wide named metrics: monotonically increasing counters,
    last-write-wins gauges, shared ``Histogram`` instances.  Thread-safe;
    ``snapshot()`` is what ``obs.trace`` emits at sampling boundaries."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}

    def inc(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            return h

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
        return dict(counters=counters, gauges=gauges,
                    histograms={k: h.summary() for k, h in hists.items()})

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


REGISTRY = Registry()


def export_stages_gauges(registry: Optional[Registry] = None) -> dict:
    """Mirror ``stages.stats()`` — including the per-entry dispatch counts
    and cumulative dispatch wall — into obs gauges
    (``stages.<counter>`` / ``stages.entry.<name>.{dispatches,wall_s}``).
    Returns the stats dict it exported."""
    from repro_torch import stages
    reg = registry or REGISTRY
    s = stages.stats()
    for k, v in s.items():
        if isinstance(v, (int, float)):
            reg.gauge(f"stages.{k}", v)
    for entry, es in s.get("per_entry", {}).items():
        reg.gauge(f"stages.entry.{entry}.dispatches", es["dispatches"])
        reg.gauge(f"stages.entry.{entry}.wall_s", es["wall_s"])
    return s


def fleet_sample(states) -> dict:
    """ONE ``hier.metrics_snapshot`` over the fleet state, host transfer at
    this sampling boundary only.  Returns plain python: per-layer
    ``nnz``/``occupancy``/``spills`` lists, ``depth_hist``, ``overflow``,
    and the exact 64-bit ``updates`` reassembled from the (hi, lo) words."""
    from repro_torch.core import hier
    snap = {k: v.tolist() for k, v in hier.metrics_snapshot(states).items()}
    return dict(
        nnz=[int(x) for x in snap["nnz"]],
        occupancy=[float(x) for x in snap["occupancy"]],
        spills=[int(x) for x in snap["spills"]],
        depth_hist=[int(x) for x in snap["depth_hist"]],
        overflow=int(snap["overflow"]),
        updates=int(snap["updates_lo"]) + (int(snap["updates_hi"]) << 32),
    )
