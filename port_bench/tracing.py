"""The device trace of a ``--trace 1`` run, read into interval arrays.

``torch.profiler`` records the window with host and device activity.  The
benchmark opens ranges of its own around what it drives (``bench.window``
around the traced window, ``bench.ingest``, ``bench.query``,
``bench.reset`` around each call, each ended by a synchronize, so every
kernel a call launched ran inside its range), and the program's
``stages`` entries open theirs (``obs.enable(annotate=True)``).  Nothing is
written to disk: the events are read from the profiler's results in
memory, without the per-event objects ``key_averages`` builds.
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench import arith

WINDOW = "bench.window"


def _is_annotation(ev, names) -> bool:
    fn = getattr(ev, "is_user_annotation", None)
    if fn is not None:
        return bool(fn())
    return ev.name() in names


class Trace:
    """A profiler over the traced window; ``stop()`` reads it."""

    def __init__(self, entries=()):
        self.entries = set(entries)
        self.prof = None
        self.kernels = None      # (names, starts, ends), seconds
        self.ranges = {}         # name -> (starts, ends), seconds
        self.t0 = self.t1 = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self) -> None:
        self.prof.stop()
        self._read(self.prof.profiler.kineto_results.events())
        self.prof = None

    def _read(self, events) -> None:
        cuda = torch.autograd.DeviceType.CUDA
        names, starts, ends = [], [], []
        ranges = {}
        for ev in events:
            name = ev.name()
            wanted = name.startswith("bench.") or name in self.entries
            if ev.device_type() == cuda:
                if wanted and _is_annotation(ev, self.entries):
                    continue
                names.append(name)
                starts.append(ev.start_ns())
                ends.append(ev.end_ns())
            elif wanted:
                ranges.setdefault(name, []).append(
                    (ev.start_ns(), ev.end_ns()))
        if WINDOW not in ranges:
            raise RuntimeError("the trace holds no bench.window range")
        (w0, w1), = ranges[WINDOW]
        scale = 1e-9
        self.t0, self.t1 = 0.0, (w1 - w0) * scale
        self.kernels = (np.array(names, dtype=object),
                        (np.array(starts, dtype=np.float64) - w0) * scale,
                        (np.array(ends, dtype=np.float64) - w0) * scale)
        self.ranges = {}
        for name, spans in ranges.items():
            spans.sort()
            a = np.array(spans, dtype=np.float64)
            self.ranges[name] = ((a[:, 0] - w0) * scale,
                                 (a[:, 1] - w0) * scale)

    # ------------------------------------------------------------ reads --

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        _, s, e = self.kernels
        return arith.union_length(s, e, self.t0, self.t1)

    def inside(self, range_name: str) -> np.ndarray:
        """Mask of the kernels that started inside a range of that
        name."""
        _, s, _ = self.kernels
        if range_name not in self.ranges:
            return np.zeros(s.size, dtype=bool)
        rs, re_ = self.ranges[range_name]
        k = np.searchsorted(rs, s, side="right") - 1
        ok = k >= 0
        ok[ok] = s[ok] < re_[k[ok]]
        return ok

    def device_s(self, range_name: str, name_has=()) -> float:
        """Device time (interval union) of the kernels launched inside the
        ranges named ``range_name``; with ``name_has``, only kernels whose
        name holds one of those strings."""
        names, s, e = self.kernels
        m = self.inside(range_name)
        if name_has:
            m &= np.array([any(h in n for h in name_has) for n in names],
                          dtype=bool)
        return arith.union_length(s[m], e[m], self.t0, self.t1)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the innermost range the host had open."""
        names, s, e = self.kernels
        by_op = {}
        for n, d in zip(names, np.clip(e, self.t0, self.t1)
                        - np.clip(s, self.t0, self.t1)):
            if d > 0:
                by_op[n] = by_op.get(n, 0.0) + float(d)
        busy = arith.merged_intervals(s, e, self.t0, self.t1)
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        by_gap = {}
        if gaps:
            g = np.array(gaps)
            labels = self._innermost((g[:, 0] + g[:, 1]) / 2)
            for lab, (a, b) in zip(labels, gaps):
                by_gap[lab] = by_gap.get(lab, 0.0) + (b - a)

        def top_of(d):
            return [[k[:120], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": top_of(by_op), "idle_gaps": top_of(by_gap)}

    def _innermost(self, points: np.ndarray) -> list:
        best = np.full(points.size, -np.inf)
        label = np.array(["host outside any range"] * points.size,
                         dtype=object)
        for name, (rs, re_) in self.ranges.items():
            if name == WINDOW:
                continue
            k = np.searchsorted(rs, points, side="right") - 1
            ok = k >= 0
            kk = np.where(ok, k, 0)
            ok &= points < re_[kk]
            newer = ok & (rs[kk] > best)
            best[newer] = rs[kk][newer]
            label[newer] = name
        return label.tolist()
