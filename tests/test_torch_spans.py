"""``obs.trace``'s spans and host-read counter on the port's ingest path
(CPU): the off path keeps nothing, spans nest under their dispatch and
share its id, a dispatch span lines up with its profiler range and no
span below a dispatch leaves one, device-scalar attributes are read once
at collection, a session keeps at most ``MAX_SPANS``, the plan's host
read is counted once a step, and the monitor aggregates span records by
name with their self time."""
import json
import os

import pytest
import torch

from repro_torch import stages
from repro_torch.core import distributed, stream
from repro_torch.launch import monitor
from repro_torch.obs import trace

I, T, B, CUTS = 3, 6, 16, (32, 128, 512)


@pytest.fixture
def obs_dir(tmp_path):
    d = str(tmp_path / "obs")
    yield d
    trace.disable()


def _ingest(steps=T, **kw):
    states = distributed.create_instances(I, CUTS, B, device="cpu")
    g = torch.Generator().manual_seed(3)
    rows = torch.randint(0, 256, (I, steps, B), generator=g)
    cols = torch.randint(0, 256, (I, steps, B), generator=g)
    vals = torch.ones(I, steps, B)
    knobs = dict(lazy_l0=True, batch_mode="grouped", use_kernel=False)
    knobs.update(kw)
    return stream.ingest_instances(states, rows, cols, vals, **knobs)


def _traced(obs_dir, **kw):
    trace.enable(obs_dir, **kw)
    try:
        _ingest()
    finally:
        trace.disable()
    return trace.spans()


def test_off_keeps_nothing_and_returns_the_shared_no_op(obs_dir):
    assert not trace.enabled()
    sp = trace.span("stream.step", t=0)
    assert sp is trace.NO_SPAN and not sp.on
    with sp as inner:
        inner.set(width=1)
    assert stages._TRACE_SPAN is None
    _ingest(steps=2)                       # untraced: no session opens
    trace.enable(obs_dir)
    assert trace.spans() is None           # cleared by enable
    trace.disable()
    assert trace.spans() == dict(spans=[], dropped=0,
                                 host_reads=trace.spans()["host_reads"])


def test_spans_nest_under_their_dispatch_and_share_its_id(obs_dir):
    got = _traced(obs_dir)
    assert got["dropped"] == 0
    by_id = {r["id"]: r for r in got["spans"]}
    (disp,) = [r for r in got["spans"]
               if r["name"] == "stream.ingest_instances"]
    assert disp["parent"] is None and disp["dispatch"] == disp["id"]
    assert disp["attrs"]["kind"] == "eager"
    assert disp["attrs"]["copied_bytes"] == 0
    assert {"provenance", "compile_s"} <= set(disp["attrs"])
    steps = [r for r in got["spans"] if r["name"] == "stream.step"]
    assert [r["attrs"]["t"] for r in steps] == list(range(T))
    parent_of = {"stream.step": "stream.ingest_instances",
                 "stream.plan": "stream.step",
                 "stream.append": "stream.step",
                 "stream.member": "stream.step",
                 "assoc.merge": "stream.member"}
    for r in got["spans"]:
        assert r["dispatch"] == disp["id"]
        assert disp["start_ns"] <= r["start_ns"] <= r["end_ns"] \
            <= disp["end_ns"]
        if r is not disp:
            parent = by_id[r["parent"]]
            assert parent["name"] == parent_of[r["name"]]
            assert parent["start_ns"] <= r["start_ns"] \
                and r["end_ns"] <= parent["end_ns"]
    for s in steps:
        assert sum(s["attrs"]["cohorts"]) == I
        kids = [r for r in got["spans"] if r["parent"] == s["id"]]
        members = [r for r in kids if r["name"] == "stream.member"]
        depth0 = s["attrs"]["cohorts"][0]
        assert len(members) == I - depth0
        appends = [r for r in kids if r["name"] == "stream.append"]
        assert [a["attrs"]["members"] for a in appends] \
            == ([depth0] if depth0 else [])
    merges = [r for r in got["spans"] if r["name"] == "assoc.merge"]
    assert merges
    for m in merges:
        member = by_id[m["parent"]]
        assert m["attrs"]["route"] == "sort"
        assert m["attrs"]["width"] == member["attrs"]["width"]
        assert 0 < m["attrs"]["live"] <= m["attrs"]["width"]


def test_dispatch_span_meets_its_profiler_range_and_no_other_does(obs_dir):
    from torch.profiler import ProfilerActivity, profile
    trace.enable(obs_dir, annotate=True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _ingest(steps=3)
            _ingest(steps=3)
    finally:
        trace.disable()
    events = list(prof.profiler.kineto_results.events())
    names = {ev.name() for ev in events}
    for below in ("stream.step", "stream.plan", "stream.append",
                  "stream.member", "assoc.merge"):
        assert below not in names
    ranges = sorted(ev.start_ns() for ev in events
                    if ev.name() == "stream.ingest_instances")
    mine = sorted(r["start_ns"] for r in trace.spans()["spans"]
                  if r["name"] == "stream.ingest_instances")
    assert len(ranges) == len(mine) == 2
    for a, b in zip(mine, ranges):
        assert abs(a - b) <= 2_000_000
    assert mine[0] < ranges[1] and ranges[0] < mine[1]


def test_device_scalars_are_read_once_at_collection(obs_dir, monkeypatch):
    reads = []
    real = trace._to_host

    def counted(t):
        reads.append(t.numel())
        return real(t)
    monkeypatch.setattr(trace, "_to_host", counted)
    trace.enable(obs_dir)
    try:
        _ingest()
        live = [s[6]["live"] for s in trace._SESSION["spans"]
                if s[3] == "assoc.merge"]
        assert live and all(isinstance(x, torch.Tensor) for x in live)
        assert reads == []
    finally:
        trace.disable()
    assert reads == [len(live)]
    got = [r["attrs"]["live"] for r in trace.spans()["spans"]
           if r["name"] == "assoc.merge"]
    assert got == [int(x) for x in live]
    assert all(type(x) is int for x in got)


def test_a_session_keeps_at_most_max_spans(obs_dir, monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 5)
    got = _traced(obs_dir)
    assert len(got["spans"]) == 5 and got["dropped"] > 0


def test_spans_opened_during_a_graph_capture_are_not_kept(obs_dir):
    trace.enable(obs_dir)
    try:
        trace._SESSION["capturing"] = lambda: True
        assert trace.span("assoc.merge") is trace.NO_SPAN
        assert trace.dispatch_span("service.point_query") is trace.NO_SPAN
        trace._SESSION["capturing"] = None
        with trace.span("assoc.merge") as sp:
            assert sp.on
    finally:
        trace.disable()
    assert [r["name"] for r in trace.spans()["spans"]] == ["assoc.merge"]


def test_the_plan_is_read_once_a_step(obs_dir):
    before = trace.host_reads()
    _ingest()
    after = trace.host_reads()
    assert after["stream.plan"] - before.get("stream.plan", 0) == T
    assert {k: v for k, v in after.items() if k != "stream.plan"} \
        == {k: v for k, v in before.items() if k != "stream.plan"}
    got = _traced(obs_dir)
    at = got["host_reads"]
    assert at["disable"]["stream.plan"] - at["enable"]["stream.plan"] == T


def test_the_monitor_aggregates_spans_with_their_self_time(obs_dir,
                                                           tmp_path):
    got = _traced(obs_dir)
    summary = monitor.main(["--once", "--obs-dir", obs_dir,
                            "--summary-out", str(tmp_path / "s.json")])
    with open(os.path.join(obs_dir, "obs.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert sum(r["ev"] == "span" for r in recs) == len(got["spans"])
    spans = summary["spans"]
    for name in ("stream.ingest_instances", "stream.step", "stream.plan",
                 "stream.member", "assoc.merge"):
        mine = [r for r in got["spans"] if r["name"] == name]
        total = sum(r["end_ns"] - r["start_ns"] for r in mine) / 1e9
        kids = sum(k["end_ns"] - k["start_ns"] for r in mine
                   for k in got["spans"] if k["parent"] == r["id"]) / 1e9
        assert spans[name]["count"] == len(mine)
        assert spans[name]["total_s"] == pytest.approx(total)
        assert spans[name]["self_s"] == pytest.approx(total - kids)
        assert 0 <= spans[name]["self_s"] <= spans[name]["total_s"]
    assert spans["stream.plan"]["self_s"] == pytest.approx(
        spans["stream.plan"]["total_s"])
