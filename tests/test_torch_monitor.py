"""The port's monitor (``repro_torch.launch.monitor``) against the
reference's (``repro.launch.monitor``), each run as its own command on the
same ``obs.jsonl`` files: the same ``OBS_SUMMARY.json`` key for key (the
monitor reads no clock in ``--once`` mode: every field, the rates and
walls too, comes from the records), ``--strict`` exiting 1 on the same
malformed or out-of-order record in both, the same CLI, and no torch
imported by the port's.  The summaries of real runs (the query CLI, the
ingest CLI, the ``stages`` dispatch records) are compared in
``test_torch_obs.py``, ``test_torch_checkpoint.py`` and
``test_torch_stages.py``.
"""
import json
import os
import subprocess
import sys

import pytest

import torch_parity as tp

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


def _rec(ev, seq, t, **kw):
    return dict(ev=ev, run="r1", seq=seq, t=t, pid=7, **kw)


def _hist(samples):
    from repro_torch.obs.metrics import Histogram
    h = Histogram()
    for x in samples:
        h.observe(x)
    return h.to_dict()


def _records():
    """Two sources: an ingest run (fleet samples around two rounds) and a
    service run with an SLO histogram, stalls, a straggler and dispatch
    records."""
    nnz, occ = [10, 20, 0], [0.25, 0.5, 0.0]
    ingest = [
        _rec("fleet", 1, 1.0, updates=0, nnz=nnz, spills=[0, 0, 0],
             depth_hist=[1, 0, 0], occupancy=occ, overflow=0),
        _rec("ingest_round", 2, 1.5, round=0, updates=4096, wall_s=0.25),
        _rec("fleet", 3, 1.6, updates=4096, nnz=nnz, spills=[2, 0, 0],
             depth_hist=[1, 1, 0], occupancy=occ, overflow=0),
        _rec("ingest_round", 4, 2.0, round=1, updates=4096, wall_s=0.5),
        _rec("fleet", 5, 2.1, updates=8192, nnz=[30, 40, 5],
             spills=[3, 1, 0], depth_hist=[1, 1, 1],
             occupancy=[0.5, 0.75, 0.125], overflow=1),
        _rec("dispatch", 6, 2.2, entry="stream.ingest_instances",
             wall_s=0.125, compile_s=0.5, prov="compile"),
        _rec("dispatch", 7, 2.3, entry="stream.ingest_instances",
             wall_s=0.0625, prov="memory"),
    ]
    service = [dict(r, run="r2", pid=8) for r in (
        _rec("service_summary", 1, 3.0, n_updates=2048, ingest_wall_s=0.5,
             n_queries=256, query_wall_s=0.125,
             slo=dict(hist=_hist([1e-3, 2e-3, 4e-3, 3e-2]), count=4,
                      breaches=1, target_p99_ms=10.0)),
        _rec("slo_breach", 2, 3.1, latency_ms=30.0),
        _rec("stall", 3, 3.2), _rec("straggler", 4, 3.3),
        _rec("dispatch", 5, 3.4, entry="service.point_query",
             wall_s=0.001, prov="disk"))]
    return ingest, service


def _write(d, name, lines):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, name), "w") as f:
        f.write("".join(line + "\n" for line in lines))


def test_summaries_equal_key_for_key(tmp_path):
    ingest, service = _records()
    d = str(tmp_path / "obs")
    _write(d, "a.jsonl", [json.dumps(r) for r in ingest])
    _write(d, "b.jsonl", [json.dumps(r) for r in service])
    ref, port = tp.monitor_summaries(d, tmp_path)
    assert port == ref
    assert ref["sources"] == 2 and ref["records"] == 12
    assert ref["fleet"]["updates_total"] == 8192 + 2048
    assert ref["fleet"]["stalls"] == ref["fleet"]["stragglers"] == 1
    assert ref["per_layer"]["overflow"] == 1
    assert ref["slo"]["count"] == 4 and ref["slo"]["breaches"] == 1
    assert ref["dispatch"]["stream.ingest_instances"]["compiles"] == 1


BAD = {
    "missing_field": lambda recs: [json.dumps(
        {k: v for k, v in recs[1].items() if k != "pid"})],
    "not_json": lambda recs: ["{not json"],
    "out_of_order": lambda recs: [json.dumps(dict(recs[1], seq=1))],
    "bad_histogram": lambda recs: [json.dumps(dict(
        recs[0], run="r3", slo=dict(hist={"counts": "x"}, count=1)))],
}


@pytest.mark.parametrize("kind", sorted(BAD))
def test_strict_exits_1_on_the_same_bad_record_in_both(tmp_path, kind):
    ingest, service = _records()
    bad = BAD[kind](service if kind == "bad_histogram" else ingest)
    d = str(tmp_path / "obs")
    _write(d, "a.jsonl", [json.dumps(r) for r in ingest] + bad)
    summaries = []
    for module in tp.MONITORS:
        res, path = tp.run_monitor(module, d, tmp_path, "--strict")
        assert res.returncode == 1, (module, res.stderr)
        assert "STRICT failure" in res.stderr
        with open(path) as f:
            summaries.append(json.load(f))
        ok, _ = tp.run_monitor(module, d, tmp_path)
        assert ok.returncode == 0, (module, ok.stderr)
    ref, port = summaries
    assert port == ref
    assert ref["malformed_records"] + ref["out_of_order_records"] == 1


def _help(module: str) -> str:
    res = subprocess.run([sys.executable, "-m", module, "--help"],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_same_cli_and_no_torch_at_import():
    ref, port = (_help(m) for m in tp.MONITORS)
    assert port.replace("repro_torch", "repro") == ref
    for flag in ("--once", "--follow", "--strict", "--obs-dir",
                 "--summary-out", "--refresh"):
        assert flag in port
    code = ("import sys; import repro_torch.launch.monitor; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('torch', 'jax', 'numpy', 'repro')))")
    res = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_an_empty_directory_is_reported_and_summarised(tmp_path):
    d = str(tmp_path / "empty")
    os.makedirs(d)
    outs = []
    for module in tp.MONITORS:
        res, path = tp.run_monitor(module, d, tmp_path)
        assert res.returncode == 0 and "no *.jsonl" in res.stderr
        with open(path) as f:
            outs.append(json.load(f))
    assert outs[0] == outs[1] and outs[0]["records"] == 0
