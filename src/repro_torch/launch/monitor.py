"""Fleet observability monitor: aggregate obs.jsonl into a dashboard.

The port's copy of ``repro/launch/monitor.py``.  The single-node
analogue of the paper's 1,100-node aggregate-rate plot (arXiv 1902.00846
Fig. 4): N launch processes (``launch/ingest --obs``, ``launch/query
--obs``) append span/sample events to ``obs.jsonl`` files under one
directory; this CLI tails them, groups records by (run, pid) source, and
renders a live terminal dashboard plus a final ``OBS_SUMMARY.json`` with
fleet updates/s, queries/s, per-layer pressure, and SLO attainment.

Stdlib-only on purpose — no torch import — so it can watch a fleet from
any shell (the only repro_torch imports are ``obs.metrics``, which is
pure python, for the shared histogram merge, and ``obs.trace``'s schema).
The records are the JAX package's schema, so it reads either package's
files, and its summary of a directory is the reference monitor's.

Rate definitions match the producers exactly: a source's update rate is
its exact device-counter delta (``fleet`` events) divided by its summed
ingest wall (``ingest_round`` events) — the same
``hier.exact_update_count / wall`` number ``launch/ingest`` prints.
Fleet updates/s is the sum of source rates, which is how the paper
aggregates share-nothing instances.

Spans (``span`` records, which ``obs.trace.disable()`` writes): count,
total seconds and self seconds by name, a span's self time being its
duration less what its child spans cover.  A span's children end before
it does, so ``disable`` writes them first; the reference's monitor counts
these records and does not aggregate them, so its summary lacks the
``spans`` key, which the port's has only when there were spans.

Schema checking: every record must carry ``obs.trace.SCHEMA_FIELDS`` and
``seq`` must be monotonic per source; ``--strict`` exits non-zero on any
malformed or out-of-order record (the CI gate).

Usage::

    python -m repro_torch.launch.monitor --obs-dir obs --once \
        --summary-out OBS_SUMMARY.json
    python -m repro_torch.launch.monitor --obs-dir obs --follow
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
import sys
import time

from repro_torch.obs.metrics import Histogram
from repro_torch.obs.trace import SCHEMA_FIELDS


class Aggregator:
    """Incremental reducer over obs.jsonl records, grouped by
    (run, pid) source."""

    def __init__(self):
        self.sources: dict = {}      # (run, pid) -> per-source state
        self.dispatch: dict = {}     # entry -> count/wall_s/compiles/...
        self.spans: dict = {}        # name -> count/total_s/self_s
        self._covered: dict = {}     # (source, span id) -> children's s
        self.events: dict = {}       # ev -> count
        self.records = 0
        self.malformed = 0
        self.out_of_order = 0
        self.slo_hist = Histogram()
        self.slo_n = 0
        self.slo_ok = 0
        self.slo_breaches = 0
        self.slo_target_ms = None
        self.stalls = 0
        self.stragglers = 0

    # ------------------------------------------------------------ feeding --

    def add_line(self, line: str) -> bool:
        line = line.strip()
        if not line:
            return True
        try:
            rec = json.loads(line)
        except ValueError:
            self.malformed += 1
            return False
        if not isinstance(rec, dict) \
                or any(f not in rec for f in SCHEMA_FIELDS):
            self.malformed += 1
            return False
        self.add_record(rec)
        return True

    def add_record(self, rec: dict) -> None:
        self.records += 1
        ev = rec["ev"]
        self.events[ev] = self.events.get(ev, 0) + 1
        src = self._source(rec)
        seq = rec["seq"]
        if src["last_seq"] is not None and seq <= src["last_seq"]:
            self.out_of_order += 1
        src["last_seq"] = seq
        src["last_t"] = rec["t"]
        handler = getattr(self, f"_ev_{ev}", None)
        if handler is not None:
            handler(rec, src)

    def _source(self, rec: dict) -> dict:
        key = (rec["run"], rec["pid"])
        src = self.sources.get(key)
        if src is None:
            src = self.sources[key] = dict(
                last_seq=None, first_t=rec["t"], last_t=rec["t"],
                ingest_updates=0, ingest_wall_s=0.0, rounds=0,
                fleet_first=None, fleet_last=None,
                queries=0, query_wall_s=0.0,
                service_updates=0, service_wall_s=0.0)
        return src

    # ------------------------------------------------------- per-event ----

    def _ev_ingest_round(self, rec, src):
        src["ingest_updates"] += rec.get("updates", 0)
        src["ingest_wall_s"] += rec.get("wall_s", 0.0)
        src["rounds"] += 1

    def _ev_fleet(self, rec, src):
        if src["fleet_first"] is None:
            src["fleet_first"] = rec
        src["fleet_last"] = rec

    def _ev_service_summary(self, rec, src):
        src["service_updates"] += rec.get("n_updates", 0)
        src["service_wall_s"] += rec.get("ingest_wall_s", 0.0)
        src["queries"] += rec.get("n_queries", 0)
        src["query_wall_s"] += rec.get("query_wall_s", 0.0)
        slo = rec.get("slo")
        if slo:
            try:
                self.slo_hist.merge(Histogram.from_dict(slo["hist"]))
            except (KeyError, ValueError):
                self.malformed += 1
                return
            self.slo_n += slo.get("count", 0)
            self.slo_breaches += slo.get("breaches", 0)
            self.slo_ok += slo.get("count", 0) - slo.get("breaches", 0)
            if slo.get("target_p99_ms") is not None:
                self.slo_target_ms = slo["target_p99_ms"]

    def _ev_dispatch(self, rec, src):
        d = self.dispatch.setdefault(
            rec.get("entry", "?"),
            dict(count=0, wall_s=0.0, compiles=0, compile_s=0.0,
                 disk=0, memory=0))
        d["count"] += 1
        d["wall_s"] += rec.get("wall_s", 0.0)
        prov = rec.get("prov")
        if prov == "compile":
            d["compiles"] += 1
            d["compile_s"] += rec.get("compile_s", 0.0)
        elif prov in ("disk", "memory"):
            d[prov] += 1

    def _ev_span(self, rec, src):
        key = (rec["run"], rec["pid"])
        dur = max(rec.get("end_ns", 0) - rec.get("start_ns", 0), 0) / 1e9
        covered = self._covered.pop((key, rec.get("id")), 0.0)
        parent = rec.get("parent")
        if parent is not None:
            self._covered[(key, parent)] = \
                self._covered.get((key, parent), 0.0) + dur
        d = self.spans.setdefault(rec.get("name", "?"),
                                  dict(count=0, total_s=0.0, self_s=0.0))
        d["count"] += 1
        d["total_s"] += dur
        d["self_s"] += dur - covered

    def _ev_slo_breach(self, rec, src):
        pass                        # counted via events; totals ride summary

    def _ev_stall(self, rec, src):
        self.stalls += 1

    def _ev_straggler(self, rec, src):
        self.stragglers += 1

    # -------------------------------------------------------- reduction ---

    def source_rates(self) -> list:
        """Per-source (updates, wall_s, rate): exact counter deltas from
        ``fleet`` events over summed ``ingest_round`` wall when both exist
        (launch/ingest), else round sums, else the service-loop numbers."""
        rows = []
        for key, src in sorted(self.sources.items()):
            wall = src["ingest_wall_s"] or src["service_wall_s"]
            if src["fleet_first"] is not None and src["ingest_wall_s"]:
                updates = src["fleet_last"].get("updates", 0) \
                    - src["fleet_first"].get("updates", 0)
            else:
                updates = src["ingest_updates"] or src["service_updates"]
            rate = updates / wall if wall else 0.0
            rows.append(dict(run=key[0], pid=key[1], updates=updates,
                             wall_s=wall, updates_per_s=rate,
                             queries=src["queries"],
                             query_wall_s=src["query_wall_s"]))
        return rows

    def per_layer(self) -> dict:
        nnz = spills = depth = None
        occ = None
        overflow = 0
        n = 0
        for src in self.sources.values():
            f = src["fleet_last"]
            if f is None:
                continue
            n += 1
            overflow += f.get("overflow", 0)

            def acc(tot, cur):
                return cur if tot is None \
                    else [a + b for a, b in zip(tot, cur)]
            nnz = acc(nnz, f.get("nnz", []))
            spills = acc(spills, f.get("spills", []))
            depth = acc(depth, f.get("depth_hist", []))
            occ = acc(occ, f.get("occupancy", []))
        return dict(nnz=nnz or [], spills=spills or [],
                    depth_hist=depth or [],
                    occupancy=[o / n for o in occ] if occ else [],
                    overflow=overflow)

    def summary(self) -> dict:
        rows = self.source_rates()
        updates = sum(r["updates"] for r in rows)
        upd_rate = sum(r["updates_per_s"] for r in rows)
        queries = sum(r["queries"] for r in rows)
        q_rate = sum(r["queries"] / r["query_wall_s"] for r in rows
                     if r["query_wall_s"])
        slo = None
        if self.slo_n:
            def ms(x):
                return None if x is None or math.isnan(x) else x * 1e3
            slo = dict(count=self.slo_n,
                       p50_ms=ms(self.slo_hist.percentile(50)),
                       p95_ms=ms(self.slo_hist.percentile(95)),
                       p99_ms=ms(self.slo_hist.percentile(99)),
                       attainment=self.slo_ok / self.slo_n,
                       breaches=self.slo_breaches,
                       target_ms=self.slo_target_ms)
        out = dict(
            sources=len(self.sources),
            records=self.records,
            malformed_records=self.malformed,
            out_of_order_records=self.out_of_order,
            events=dict(sorted(self.events.items())),
            fleet=dict(updates_total=updates, updates_per_s=upd_rate,
                       queries_total=queries, queries_per_s=q_rate,
                       stalls=self.stalls, stragglers=self.stragglers),
            per_layer=self.per_layer(),
            slo=slo,
            dispatch={e: dict(d) for e, d in sorted(self.dispatch.items())},
            source_rates=rows,
        )
        if self.spans:
            out["spans"] = {n: dict(d) for n, d in sorted(self.spans.items())}
        return out


class Tailer:
    """Byte-offset file tailer over every ``*.jsonl`` in a directory —
    re-reads only appended data, carries partial trailing lines across
    polls."""

    def __init__(self, obs_dir: str):
        self.obs_dir = obs_dir
        self.offsets: dict = {}
        self.partials: dict = {}

    def poll(self, agg: Aggregator) -> int:
        n = 0
        pattern = os.path.join(self.obs_dir, "*.jsonl")
        for path in sorted(glob.glob(pattern)):
            try:
                with open(path, "rb") as f:
                    f.seek(self.offsets.get(path, 0))
                    data = f.read()
                    self.offsets[path] = f.tell()
            except OSError:
                continue
            if not data:
                continue
            data = self.partials.pop(path, b"") + data
            lines = data.split(b"\n")
            if lines and lines[-1]:
                self.partials[path] = lines.pop()
            for line in lines:
                if line:
                    agg.add_line(line.decode("utf-8", "replace"))
                    n += 1
        return n


# ---------------------------------------------------------------- render ----


def _fmt_rate(x: float) -> str:
    return f"{x:,.0f}"


def render(summary: dict) -> str:
    out = []
    f = summary["fleet"]
    out.append("== d4m fleet monitor ==")
    out.append(f"sources {summary['sources']}  records "
               f"{summary['records']}  malformed "
               f"{summary['malformed_records']}")
    out.append(f"updates  {_fmt_rate(f['updates_per_s'])}/s   "
               f"(total {f['updates_total']:,})")
    out.append(f"queries  {_fmt_rate(f['queries_per_s'])}/s   "
               f"(total {f['queries_total']:,})   "
               f"stalls {f['stalls']}  stragglers {f['stragglers']}")
    pl = summary["per_layer"]
    if pl["nnz"]:
        out.append("layer  nnz        occ     spills")
        for i, nnz in enumerate(pl["nnz"]):
            occ = pl["occupancy"][i] if i < len(pl["occupancy"]) else 0.0
            sp = pl["spills"][i] if i < len(pl["spills"]) else ""
            out.append(f"  L{i}   {nnz:<10,} {occ:6.1%}  {sp}")
        out.append(f"depth_hist {pl['depth_hist']}  "
                   f"overflow {pl['overflow']}")
    slo = summary.get("slo")
    if slo:
        tgt = slo["target_ms"]
        out.append(f"SLO p50 {slo['p50_ms']:.3f}ms  p95 "
                   f"{slo['p95_ms']:.3f}ms  p99 {slo['p99_ms']:.3f}ms  "
                   f"attainment {slo['attainment']:.2%}"
                   + (f"  (target p99 {tgt:g}ms, "
                      f"{slo['breaches']} breaches)"
                      if tgt is not None else ""))
    if summary["dispatch"]:
        out.append("entry                              n      wall_s  "
                   "compiles")
        for entry, d in summary["dispatch"].items():
            out.append(f"  {entry:<32} {d['count']:<6} "
                       f"{d['wall_s']:<8.3f}{d['compiles']}")
    if summary.get("spans"):
        out.append("span                               n      total_s  "
                   "self_s")
        for name, d in summary["spans"].items():
            out.append(f"  {name:<32} {d['count']:<6} "
                       f"{d['total_s']:<8.3f} {d['self_s']:.3f}")
    return "\n".join(out)


# ------------------------------------------------------------------- CLI ----


def run(args) -> dict:
    agg = Aggregator()
    tailer = Tailer(args.obs_dir)
    if not glob.glob(os.path.join(args.obs_dir, "*.jsonl")):
        print(f"monitor: no *.jsonl under {args.obs_dir!r}",
              file=sys.stderr)
    if args.once:
        tailer.poll(agg)
    else:
        try:
            while True:
                tailer.poll(agg)
                s = agg.summary()
                sys.stdout.write("\x1b[2J\x1b[H" + render(s) + "\n")
                sys.stdout.flush()
                time.sleep(args.refresh)
        except KeyboardInterrupt:
            pass
    summary = agg.summary()
    print(render(summary))
    out_path = args.summary_out \
        or os.path.join(args.obs_dir, "OBS_SUMMARY.json")
    tmp = f"{out_path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(summary, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, out_path)
    print(f"wrote {out_path}")
    if args.strict and (agg.malformed or agg.out_of_order):
        print(f"monitor: STRICT failure — {agg.malformed} malformed, "
              f"{agg.out_of_order} out-of-order records",
              file=sys.stderr)
        raise SystemExit(1)
    return summary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--obs-dir", default=os.environ.get("REPRO_OBS_DIR",
                                                        "obs"),
                    help="directory the producers write obs.jsonl into")
    ap.add_argument("--once", action="store_true",
                    help="aggregate what exists, print, write the summary "
                    "and exit (CI mode)")
    ap.add_argument("--follow", action="store_true",
                    help="live dashboard: keep tailing until interrupted")
    ap.add_argument("--refresh", type=float, default=2.0,
                    help="dashboard refresh period in seconds")
    ap.add_argument("--summary-out", default="",
                    help="OBS_SUMMARY.json path "
                    "(default <obs-dir>/OBS_SUMMARY.json)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on malformed or out-of-order records "
                    "(the CI schema gate)")
    args = ap.parse_args(argv)
    if not args.follow:
        args.once = True
    return run(args)


if __name__ == "__main__":
    main()
