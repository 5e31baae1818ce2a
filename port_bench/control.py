"""Readings of the numbers that decide ``correct``, over many seeds in one
process: the program as the configuration states it (the lower readings),
and the control (the upper readings): the program's own lower-precision
path, its values held in bfloat16 instead of the float32 the
configuration states.

    python3 port_bench/control.py --workload paper-ingest \\
        --seeds 101,102,103 --seconds 5 --control 1

Prints one JSON line a seed: its checks, ``correct`` and the cell's
end-to-end numbers.  The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    import torch
    from port_bench import harness, spec
    bench = spec.benchmark(REPO)
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(
            args.workload, cfg, traffic,
            spec.metrics_for(bench, args.workload, False), seed=seed,
            seconds=args.seconds, trace=False, device="cuda",
            value_dtype=torch.bfloat16 if args.control else None)
        print(json.dumps(dict(
            seed=seed, control=bool(args.control), correct=out["correct"],
            checks={k: v["value"] for k, v in out["checks"].items()},
            metrics={k: v["value"] for k, v in out["metrics"].items()})),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
