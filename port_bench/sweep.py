"""The query-rate sweep of an open-loop cell: the highest rate whose query
backlog does not grow over the window (the knee).

    python3 port_bench/sweep.py --workload paper-ingest-query \\
        --seed 7 --seconds 51 --rates 12,16,20,24,28

Runs the cell once a rate, in one process, with the traffic's
``rate_per_s`` replaced, and prints one JSON line a rate: batches due in
the window and answered by its end, the backlog (due but not answered)
at the end of each ingest call, its mean and its growth over the window,
the median and 95th-percentile waits of the first and second halves of
the window, and updates/s.

The backlog grows where its least-squares line over the window's ingest
calls rises by more than half its mean from the window's start to its
end: a backlog that grows steadily from empty rises by twice its mean, a
steady one by nothing.  The knee is the highest rate at which it does not
grow; the cell's file takes about four fifths of it.  Not part of a
benchmark run.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def backlog_growth(ends, backlog, seconds: float):
    """(mean backlog, rise of its least-squares line over ``seconds``,
    whether that rise is more than half the mean)."""
    t = np.asarray(ends, dtype=np.float64)
    y = np.asarray(backlog, dtype=np.float64)
    mean = float(y.mean()) if y.size else 0.0
    rise = float(np.polyfit(t, y, 1)[0] * seconds) if y.size > 1 else 0.0
    return mean, rise, rise > 0.5 * mean


def backlog_row(rate: float, rec) -> dict:
    from port_bench import arith
    due = np.array([b["due"] for b in rec.batches])
    done = np.array([b["answer"] for b in rec.batches])
    in_win = due < rec.seconds
    ends = [c["end"] for c in rec.calls]
    backlog = [int(((due <= t) & (done > t)).sum()) for t in ends]
    mean, rise, grows = backlog_growth(ends, backlog, rec.seconds)
    half = due < rec.seconds / 2
    wait = np.array([b["dispatch"] - b["due"] for b in rec.batches])

    def q(x, p):
        return 1e3 * arith.percentile(x, p) if x.size else None
    return dict(
        rate=rate, due=int(in_win.sum()),
        answered_in_window=int((in_win & (done < rec.seconds)).sum()),
        backlog_mean=mean, backlog_rise=rise, backlog_grows=grows,
        backlog=backlog,
        wait_p50_ms=(q(wait[half], 50), q(wait[~half], 50)),
        wait_p95_ms=(q(wait[half], 95), q(wait[~half], 95)),
        batch_p50_ms=q(done - np.array([b["dispatch"]
                                        for b in rec.batches]), 50),
        updates_per_s=rec.updates / rec.window_s,
        calls=len(rec.calls))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    from port_bench import harness, spec
    bench = spec.benchmark(REPO)
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(cell["config"])
    base = spec.traffic(cell["traffic"])
    for rate in (float(r) for r in args.rates.split(",")):
        traffic = copy.deepcopy(base)
        traffic["queries"]["rate_per_s"] = rate
        rows = []
        out = harness.run_cell(args.workload, cfg, traffic, [],
                               seed=args.seed, seconds=args.seconds,
                               trace=False, device="cuda",
                               on_record=lambda r: rows.append(
                                   backlog_row(rate, r)))
        rows[0]["correct"] = out["correct"]
        print(json.dumps(rows[0]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
