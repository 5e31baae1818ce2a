"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 port_bench/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

Loads the cell's configuration and traffic by name, makes the inputs from
the seed on the CUDA card, warms up, measures for ``--seconds``, compares
what the program produced with the plain reference, and prints one JSON
line last on standard output (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, then
``checks``: each number compared with its limit, also the last lines on
standard error).  With ``--trace 0`` the metrics are the cell's end-to-end
ones, with ``--trace 1`` its per-layer ones, read from a profiler trace.

Exits non-zero and prints no result when there is no CUDA card (or fewer
than the cell asks for), when the program (``src/repro_torch``) is not in
the checkout, or when JAX or the JAX package was loaded.  The kernels the
program builds stay in its fixed ``build/`` directory in the checkout.
"""
from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock, from its start
    time in ``/proc`` (the module's import time where that is absent)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
        return min(time.perf_counter() - age, _T_IMPORT)
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def loaded_forbidden(modules=None) -> list:
    """Top-level names of JAX or the JAX package among ``modules`` (this
    process's ``sys.modules``), compared whole: ``repro_torch`` is not
    ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


def main(argv=None) -> int:
    t_start = process_start()
    args = parser().parse_args(argv)
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    from port_bench import spec
    try:
        bench = spec.benchmark(REPO)
        cell = spec.cell(bench, args.workload)
        cfg = spec.config(cell["config"])
        traffic = spec.traffic(cell["traffic"])
    except (OSError, KeyError, ValueError) as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"port_bench: the cell needs {cell['chips']} CUDA card(s), "
              f"this machine has {have}", file=sys.stderr)
        return 2
    try:
        import repro_torch.core.stream  # noqa: F401
    except ImportError as e:
        print(f"port_bench: the program is not in this checkout ({e})",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    from port_bench import harness
    result = harness.run_cell(
        args.workload, cfg, traffic,
        spec.metrics_for(bench, args.workload, bool(args.trace)),
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device="cuda", t_start=t_start)
    found = loaded_forbidden()
    if found:
        print(f"port_bench: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
