"""Port parity: ``repro_torch.obs`` (metrics, slo, trace) and
``hier.metrics_snapshot`` against ``repro.obs`` and ``repro.core.hier``.

The histogram's buckets and percentiles equal the reference's bit for bit
on the same samples, payloads cross between the packages, the SLO tracker,
stall detector and rolling rate make the same decisions on the same
sequences, ``metrics_snapshot`` equals the reference's on the same fleet
(also past the uint32 wrap of the counter's low word), and the stdlib-only
``repro.launch.monitor``, run as a separate command, aggregates the
``obs.jsonl`` that the port's query CLI writes.
"""
import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import distributed as jdist
from repro.core import hier as jhier
from repro.core import stream as jstream
from repro.obs import metrics as jmetrics
from repro.obs import slo as jslo
from repro_torch import obs as tobs
from repro_torch.core import hier as thier
from repro_torch.launch import query as tquery
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import slo as tslo
from repro_torch.obs import trace as ttrace

import torch_parity as tp


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def _samples(seed=0, n=500):
    rng = np.random.default_rng(seed)
    x = np.exp(rng.normal(-7, 2, n)).tolist()
    # exact bucket edges, underflow, overflow and repeats
    x += [tmetrics.bucket_edge(i) for i in (0, 1, 57, 139, 239)]
    x += [0.0, 1e-12, 5e3, 1e4, 2e-3, 2e-3]
    return x


def test_bucket_geometry_matches():
    assert tmetrics.Histogram.SCHEMA == jmetrics.Histogram.SCHEMA
    for i in range(tmetrics.NUM_BUCKETS + 1):
        assert tmetrics.bucket_edge(i) == jmetrics.bucket_edge(i)
    for x in _samples():
        assert tmetrics.bucket_index(x) == jmetrics.bucket_index(x), x


def test_histogram_percentiles_bit_for_bit():
    th, jh = tmetrics.Histogram(), jmetrics.Histogram()
    for x in _samples():
        th.observe(x)
        jh.observe(x)
    for q in (0, 1, 25, 50, 90, 95, 99, 99.9, 100):
        assert th.percentile(q) == jh.percentile(q), q
    assert th.to_dict() == jh.to_dict()
    assert th.summary() == jh.summary()
    # payloads cross between the packages, and merge the same way
    other = [x * 3 for x in _samples(1, 100)]
    t2, j2 = tmetrics.Histogram(), jmetrics.Histogram()
    for x in other:
        t2.observe(x)
        j2.observe(x)
    th.merge(tmetrics.Histogram.from_dict(j2.to_dict()))
    jh.merge(jmetrics.Histogram.from_dict(t2.to_dict()))
    assert th.to_dict() == jh.to_dict()
    assert th.percentile(99) == jh.percentile(99)
    assert math.isnan(tmetrics.Histogram().percentile(50))
    bad = dict(th.to_dict(), schema=dict(v=2))
    with pytest.raises(ValueError, match="schema"):
        tmetrics.Histogram.from_dict(bad)


def test_registry_snapshot_matches():
    regs = (tmetrics.Registry(), jmetrics.Registry())
    for r in regs:
        r.inc("updates", 5)
        r.inc("updates", 3)
        r.gauge("occupancy", 0.5)
        for x in _samples(2, 50):
            r.histogram("lat").observe(x)
    a, b = (r.snapshot() for r in regs)
    assert a == b
    regs[0].reset()
    assert regs[0].snapshot() == dict(counters={}, gauges={}, histograms={})


def test_slo_tracker_stall_detector_rolling_rate_match():
    lat = [1e-3, 2e-3, 12e-3, 3e-3, 40e-3, 1e-3, 5e-3]
    for target in (None, 4.0):
        t = tslo.SLOTracker(target_p99_ms=target, name="q")
        j = jslo.SLOTracker(target_p99_ms=target, name="q")
        assert [t.observe(x) for x in lat] == [j.observe(x) for x in lat]
        assert t.summary() == j.summary()
        assert t.attainment() == j.attainment()
    walls = [1.0, 1.1, 0.9, 5.0, 1.0, 1.2, 30.0, 1.0]
    t, j = tslo.StallDetector(), jslo.StallDetector()
    assert [t.observe(w) for w in walls] == [j.observe(w) for w in walls]
    assert (t.stalls, t.ema_s, t.steps) == (j.stalls, j.ema_s, j.steps) \
        and t.stalls == 2
    t, j = tslo.RollingRate(window_s=10.0), jslo.RollingRate(window_s=10.0)
    for k, at in enumerate((0.0, 1.0, 4.0, 12.0, 13.5, 30.0)):
        t.add(100 * (k + 1), at)
        j.add(100 * (k + 1), at)
        assert t.rate(at + 0.5) == j.rate(at + 0.5)
        assert t.total() == j.total()


def _jax_fleet():
    rows, cols, vals = tp.stream(61, (3, 10, 16), 40)
    states = jdist.create_instances(3, (32, 128), 16)
    states, _ = jstream.ingest_instances(
        states, jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
        lazy_l0=True)
    return states


def _snap_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in got:
        if k == "occupancy":
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6)
        else:
            np.testing.assert_array_equal(
                got[k].numpy().astype(np.int64),
                np.asarray(want[k]).astype(np.int64), err_msg=k)


def test_metrics_snapshot_matches_reference():
    js = _jax_fleet()
    ts = tp.to_torch(js)
    _snap_equal(thier.metrics_snapshot(ts), jhier.metrics_snapshot(js))
    one_j = jax.tree.map(lambda x: x[1], js)
    _snap_equal(thier.metrics_snapshot(tp.to_torch(one_j)),
                jhier.metrics_snapshot(one_j))
    got, want = tmetrics.fleet_sample(ts), jmetrics.fleet_sample(js)
    # the mean occupancy is a float32 division taken in another order
    np.testing.assert_allclose(got.pop("occupancy"), want.pop("occupancy"),
                               rtol=1e-6)
    assert got == want
    empty = thier.create((16, 64), 4, device="cpu")
    s = tmetrics.fleet_sample(empty)
    assert s["nnz"] == [0, 0] and s["updates"] == 0
    assert s["depth_hist"] == [1, 0, 0]


def test_metrics_snapshot_exact_across_uint32_wrap():
    """Counter totals past 2**32 (and the fleet's sum wrapping the low
    word): the same (hi, lo) words as the reference's carry detection."""
    js = _jax_fleet()
    lo = np.array([2**32 - 5, 2**32 - 3, 7], np.uint32)
    hi = np.array([1, 2, 0], np.int32)
    js = dataclasses.replace(js, n_updates=jnp.asarray(lo),
                             n_updates_hi=jnp.asarray(hi))
    ts = tp.to_torch(js)
    _snap_equal(thier.metrics_snapshot(ts), jhier.metrics_snapshot(js))
    want = int(lo.astype(np.int64).sum()) + ((1 + 2) << 32)
    assert tmetrics.fleet_sample(ts)["updates"] == want \
        == jmetrics.fleet_sample(js)["updates"]


def test_trace_schema_and_disabled_noop(tmp_path):
    assert not ttrace.emit("x", a=1)
    path = ttrace.enable(str(tmp_path / "obs"))
    try:
        assert ttrace.enabled() and ttrace.out_path() == path
        assert ttrace.enable(str(tmp_path / "other")) == path   # idempotent
        run = ttrace.run_id()
        assert ttrace.emit("probe", n=3)
        assert not ttrace.emit("bad", obj=object())   # never raises
    finally:
        ttrace.disable()
    assert not ttrace.enabled() and ttrace.run_id() is None
    recs = [json.loads(line) for line in open(path)]
    assert [r["ev"] for r in recs] == ["obs_start", "probe"]
    for r in recs:
        assert all(f in r for f in ttrace.SCHEMA_FIELDS)
        assert r["run"] == run and r["pid"] == os.getpid()
    assert [r["seq"] for r in recs] == [1, 2]
    assert tobs.enabled is ttrace.enabled


def test_monitor_aggregates_the_port_query_run(tmp_path):
    """``launch/query.py --obs`` on the CPU writes obs.jsonl; the
    reference's stdlib-only monitor, as its own command, aggregates it:
    update and query totals, rates, SLO counts and the fleet sample; the
    port's monitor gives the same summary, key for key."""
    d = str(tmp_path / "obs")
    args = tquery.parser().parse_args([
        "--instances", "2", "--blocks", "8", "--block-size", "16",
        "--cuts", "32,128,512", "--scale", "8", "--rounds", "4",
        "--queries", "16", "--slo-p99-ms", "1e-6", "--obs", "--obs-dir", d,
        "--device", "cpu"])
    try:
        stats, _, states = tquery.run_with_states(args)
    finally:
        ttrace.disable()
    summary, port_summary = tp.monitor_summaries(d, tmp_path)
    assert port_summary == summary
    assert summary["sources"] == 1 and summary["malformed_records"] == 0
    assert summary["events"]["service_summary"] == 2
    assert summary["events"]["slo_breach"] == stats["slo_breaches"] == 3
    fleet = summary["fleet"]
    assert fleet["updates_total"] == 2 * stats["n_updates"]
    assert fleet["queries_total"] == stats["n_queries"]
    assert fleet["queries_per_s"] == pytest.approx(stats["queries_per_s"])
    assert summary["slo"]["breaches"] == 3
    assert summary["slo"]["attainment"] == 0.0
    sample = tmetrics.fleet_sample(states)
    assert summary["per_layer"]["nnz"] == sample["nnz"]
    assert sample["updates"] == thier.exact_update_count(states) == 2 * 8 * 16
