"""The span readers: alignment with the trace, idle attribution on a
synthetic trace, None wherever the spans are missing, dropped or
unaligned (a program without spans included), and a tiny traced run on
the CPU that reads them from the program."""
import dataclasses

import numpy as np
import pytest

from port_bench import harness, spans, spec
from port_bench.conftest import TINY, TINY_TRAFFIC

NAMES = ("plan_idle_ms_per_step", "cohort_idle_ms_per_step",
         "host_reads_per_step", "sorted_slots_per_update", "sort_live_pct",
         "query_copy_gb_per_batch")
BASE = 1_700_000_000_000_000_000       # ns on the profiler's clock
OFFSET = 0.25                          # s from the window's start to BASE
COLLECTED = spans._collected


@dataclasses.dataclass
class FakeTrace:
    ranges: dict
    kernels: tuple
    t0: float = 0.0
    t1: float = 1.0


@dataclasses.dataclass
class FakeRun:
    trace: object
    calls: list
    batches: list = dataclasses.field(default_factory=list)


def _rec(i, name, t0, t1, parent=None, dispatch=None, **attrs):
    ns = (lambda t: BASE + int(round((t - OFFSET) * 1e9)))
    return dict(id=i, name=name, parent=parent, dispatch=dispatch,
                start_ns=ns(t0), end_ns=ns(t1), attrs=attrs)


def _synthetic():
    """One ingest dispatch over [0.30, 0.70) s of the window: a step with
    its plan, an append, a member and its sort-route merge; one query
    dispatch after it.  The device runs [0.0, 0.35), [0.40, 0.50),
    [0.55, 0.60) and [0.80, 1.0)."""
    records = [
        _rec(1, "stream.ingest_instances", 0.30, 0.70, dispatch=1),
        _rec(2, "stream.step", 0.31, 0.69, 1, 1, t=0),
        _rec(3, "stream.plan", 0.34, 0.38, 2, 1),
        _rec(4, "stream.append", 0.38, 0.45, 2, 1, members=2),
        _rec(5, "stream.member", 0.45, 0.65, 2, 1, depth=1, width=40),
        _rec(6, "assoc.merge", 0.52, 0.64, 5, 1, route="sort", width=40,
             live=10, out_capacity=40),
        _rec(7, "service.point_query", 0.75, 0.78, dispatch=7,
             copied_bytes=3_000_000_000),
    ]
    kernels = (np.array(["k"] * 4, dtype=object),
               np.array([0.0, 0.40, 0.55, 0.80]),
               np.array([0.35, 0.50, 0.60, 1.0]))
    ranges = {"stream.ingest_instances": (np.array([0.30]),
                                          np.array([0.70])),
              "service.point_query": (np.array([0.75]), np.array([0.78]))}
    run = FakeRun(FakeTrace(ranges, kernels),
                  calls=[dict(blocks=2, updates=100)],
                  batches=[dict(), dict()])
    session = dict(spans=records, dropped=0,
                   host_reads=dict(enable={"stream.plan": 5},
                                   disable={"stream.plan": 7, "vassoc": 1}))
    return run, session


@pytest.fixture
def synthetic(monkeypatch):
    run, session = _synthetic()
    monkeypatch.setattr(spans, "_collected", lambda: session)
    return run, session


def _read(name, run):
    return spec.module("metrics", name).read(run)


def test_alignment_finds_the_offset(synthetic):
    run, _ = synthetic
    s = spans.session(run)
    assert s["residual_s"] == pytest.approx(0.0, abs=1e-9)
    start = {r["name"]: r["start"] for r in s["spans"]}
    assert start["stream.plan"] == pytest.approx(0.34, abs=1e-9)
    assert start["service.point_query"] == pytest.approx(0.75, abs=1e-9)


def test_gaps_go_to_the_span_open_when_they_began(synthetic):
    run, _ = synthetic
    idle = spans.idle_by_span(run)
    # [0.35, 0.40) began in the plan, [0.50, 0.55) in the member,
    # [0.60, 0.80) in the merge; [0.80, ...) is busy to the end
    assert idle == pytest.approx({"stream.plan": 0.05,
                                  "stream.member": 0.05,
                                  "assoc.merge": 0.20})
    assert _read("plan_idle_ms_per_step", run) == pytest.approx(25.0)
    assert _read("cohort_idle_ms_per_step", run) == pytest.approx(125.0)
    assert _read("host_reads_per_step", run) == pytest.approx(1.5)
    assert _read("sorted_slots_per_update", run) == pytest.approx(0.4)
    assert _read("sort_live_pct", run) == pytest.approx(25.0)
    assert _read("query_copy_gb_per_batch", run) == pytest.approx(1.5)


def test_attribute_nests_and_skips_gaps_outside_every_span():
    recs = [dict(name="a", start=0.0, end=1.0),
            dict(name="b", start=0.2, end=0.4),
            dict(name="c", start=0.2, end=0.3),
            dict(name="d", start=2.0, end=3.0)]
    gaps = [(0.1, 0.15), (0.25, 0.5), (0.35, 0.36), (0.6, 0.7),
            (1.5, 1.6), (2.5, 2.75)]
    assert spans.attribute(gaps, recs) == pytest.approx(
        {"a": 0.15, "c": 0.25, "b": 0.01, "d": 0.25})


@pytest.mark.parametrize("fault", ["dropped", "count", "residual",
                                   "missing", "no_program_spans"])
def test_every_reader_is_none_without_sound_spans(synthetic, monkeypatch,
                                                  fault):
    run, session = synthetic
    if fault == "dropped":
        session["dropped"] = 1
    elif fault == "count":
        session["spans"] = [r for r in session["spans"]
                            if r["name"] != "service.point_query"]
    elif fault == "residual":
        session["spans"][0]["start_ns"] += 200_000    # 200 µs off
    elif fault == "missing":
        monkeypatch.setattr(spans, "_collected", lambda: None)
    else:
        # a program whose obs.trace has no spans(), as before they existed
        from repro_torch.obs import trace
        monkeypatch.setattr(spans, "_collected", COLLECTED)
        monkeypatch.delattr(trace, "spans")
    for name in NAMES:
        assert _read(name, run) is None, name


METRICS = [m for m in spec.benchmark()["per_layer"] if m["name"] in NAMES]


def _tiny(kind, cfg):
    out = harness.run_cell(kind, cfg, TINY_TRAFFIC[kind], METRICS,
                           seed=2**31 + 17, seconds=0.3, trace=True,
                           device="cpu")
    assert out["correct"], out["checks"]
    return {k: v["value"] for k, v in out["metrics"].items()}


def test_tiny_traced_run_reads_the_program_spans():
    m = _tiny("ingest", dict(TINY, use_kernel=False))
    assert m["host_reads_per_step"] == 1.0
    assert m["sorted_slots_per_update"] > 0
    assert 0 < m["sort_live_pct"] <= 100
    # no kernel on the CPU: the window is one gap, begun before any span
    assert m["plan_idle_ms_per_step"] == m["cohort_idle_ms_per_step"] == 0
    # conftest.TINY's merges all take the kernel route
    m = _tiny("ingest", TINY)
    assert m["sorted_slots_per_update"] == 0 and "sort_live_pct" not in m
    m = _tiny("mixed", TINY)
    assert m["query_copy_gb_per_batch"] == 0    # eager on the CPU: no copy
