"""Finds the pieces of a cell by their names in ``BENCHMARK.json``.

- ``configs/<config>.json``: a deployment's sizes and knobs, with the
  name of its plain reference's module beside them;
- ``workloads/<traffic>.json``: a traffic mix's parameters;
- ``metrics/<metric>.py``: the reader of one metric, a ``read(run)``
  that returns a number, or None when the run holds nothing to read.  A
  metric ``<quantity>.<part>`` (one quantity split by the end-to-end
  metric it moves) without a file of its own is read by
  ``metrics/<quantity>.py``.

Adding a configuration, a traffic mix or a metric is adding its file and
its entry; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
REPO = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return name


def benchmark(repo: Path = REPO) -> dict:
    return json.loads((Path(repo) / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(name: str, root: Path = BENCH_DIR) -> dict:
    return json.loads((Path(root) / "configs"
                       / f"{_name('config', name)}.json").read_text())


def traffic(name: str, root: Path = BENCH_DIR) -> dict:
    return json.loads((Path(root) / "workloads"
                       / f"{_name('traffic', name)}.json").read_text())


def module(kind: str, name: str, root: Path = BENCH_DIR):
    """The Python file ``<root>/<kind>/<name>.py`` as a module (its name
    may hold dots, so it is loaded by path); for a name ``<quantity>.<part>``
    without a file of its own, ``<root>/<kind>/<quantity>.py``."""
    path = Path(root) / kind / f"{_name(kind, name)}.py"
    if not path.exists() and "." in name:
        path = path.with_name(name.split(".")[0] + ".py")
    mod_name = "port_bench_" + kind + "_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(bench: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a run of the cell reports: the end-to-end ones
    with ``trace`` off, the per-layer ones with it on; a metric with a
    ``workloads`` list only in those cells."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]
