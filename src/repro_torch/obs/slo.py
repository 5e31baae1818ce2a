"""SLO instrumentation: rolling rates, latency objectives, stall detection.

- ``SLOTracker``: latency tracking through the shared mergeable
  ``obs.metrics.Histogram`` (percentiles stay exact under cross-process
  merge), per-observation threshold checks, breach counting, and
  ``slo_breach`` JSONL events through ``obs.trace``.
- ``RollingRate``: a bounded-window event-rate tracker for "sustained
  updates/s over the last W seconds".
- ``StallDetector``: EMA stall flagging for a serving loop (warmup-seeded,
  clamped update so one stall does not poison the baseline); it *reports*
  (obs event + counter) instead of raising, because a monitoring layer
  must never kill the loop it watches.

Wired into ``query.service.run_service`` (ingest-round stalls + query
latency SLO).  A copy of the JAX package's module, event for event.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Optional

from repro_torch.obs import trace
from repro_torch.obs.metrics import Histogram


class SLOTracker:
    """Latency objective over a mergeable histogram.

    ``observe(latency_s)`` returns True when that observation breached the
    target (and emits an ``slo_breach`` event when tracing is on).
    ``attainment()`` is the fraction of observations within target —
    1.0 when no target is configured.
    """

    def __init__(self, *, target_p99_ms: Optional[float] = None,
                 name: str = "query", hist: Optional[Histogram] = None):
        self.name = name
        self.target_s = None if target_p99_ms is None \
            else float(target_p99_ms) / 1e3
        self.hist = hist if hist is not None else Histogram()
        self.n = 0
        self.ok = 0
        self.breaches = 0

    def observe(self, latency_s: float) -> bool:
        self.hist.observe(latency_s)
        self.n += 1
        if self.target_s is None or latency_s <= self.target_s:
            self.ok += 1
            return False
        self.breaches += 1
        trace.emit("slo_breach", slo=self.name,
                   latency_ms=round(latency_s * 1e3, 6),
                   target_ms=self.target_s * 1e3)
        return True

    def attainment(self) -> float:
        return self.ok / self.n if self.n else 1.0

    def percentile(self, q: float) -> float:
        return self.hist.percentile(q)

    def summary(self) -> dict:
        """JSON-ready: percentiles in seconds + the raw histogram payload
        so a monitor can re-merge across processes."""
        s = self.hist.summary()
        return dict(name=self.name, count=self.n,
                    p50_s=s["p50"], p95_s=s["p95"], p99_s=s["p99"],
                    max_s=s["max"], attainment=self.attainment(),
                    breaches=self.breaches,
                    target_p99_ms=None if self.target_s is None
                    else self.target_s * 1e3,
                    hist=self.hist.to_dict())


class RollingRate:
    """Events/second over a sliding ``window_s`` window.  ``add(n, t)``
    records ``n`` events at time ``t`` (defaults to now); ``rate(t)``
    divides the in-window event count by the observed span."""

    def __init__(self, window_s: float = 60.0):
        self.window_s = float(window_s)
        self._events: deque = deque()      # (t, n)
        self._total = 0

    def add(self, n: int, t: Optional[float] = None) -> None:
        t = time.monotonic() if t is None else t
        self._events.append((t, n))
        self._total += n
        self._evict(t)

    def _evict(self, now: float) -> None:
        while self._events and self._events[0][0] < now - self.window_s:
            _, n = self._events.popleft()
            self._total -= n

    def rate(self, t: Optional[float] = None) -> float:
        t = time.monotonic() if t is None else t
        self._evict(t)
        if not self._events:
            return 0.0
        span = t - self._events[0][0]
        return self._total / span if span > 0 else 0.0

    def total(self) -> int:
        return self._total


class StallDetector:
    """EMA stall flagging for a serving loop (non-raising).

    The first ``warmup_steps`` observations seed the baseline, a step slower than
    ``threshold`` x the EMA is a stall, and the EMA update is clamped so a
    stalled step cannot poison the baseline it is measured against.
    Stalls emit a ``stall`` obs event and count in ``.stalls``.
    """

    def __init__(self, *, threshold: float = 3.0, decay: float = 0.9,
                 warmup_steps: int = 2, name: str = "ingest"):
        self.threshold = threshold
        self.decay = decay
        self.warmup_steps = warmup_steps
        self.name = name
        self.ema_s: Optional[float] = None
        self.steps = 0
        self.stalls = 0

    def observe(self, wall_s: float) -> bool:
        self.steps += 1
        if self.ema_s is None:
            self.ema_s = wall_s
            return False
        stalled = self.steps > self.warmup_steps \
            and wall_s > self.threshold * self.ema_s
        if stalled:
            self.stalls += 1
            trace.emit("stall", loop=self.name, step=self.steps,
                       wall_s=round(wall_s, 6),
                       ema_s=round(self.ema_s, 6),
                       threshold=self.threshold)
        clamped = min(wall_s, self.threshold * self.ema_s)
        self.ema_s = self.decay * self.ema_s + (1 - self.decay) * clamped
        return stalled
