"""Port parity: ``repro_torch.query.engine`` (``extract_rows``,
``range_total`` and the instance-batched engine), ``query.service`` and
``launch/query.py`` against the JAX package.

A 3-instance fleet ingested by the JAX package (cuts (16, 64, 512),
block 8) is carried over; the port's batched engine is held against
``jax.vmap`` of the reference engine and against its own per-instance
calls, in every ``l0_mode`` with the merge kernel route on and off, under
the four semirings (lazy layer 0 under plus.times).  ``run_service`` keeps
the reference's errors, stats keys and schedule, leaves the same final
state as the reference's service and as a run without queries, and its
live answers at the end equal the flushed state's.  Tolerance: exact on
integer-valued streams, the registry rtol (1e-4) on the float one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import assoc as jassoc
from repro.core import distributed as jdist
from repro.core import hier as jhier
from repro.core import semiring as jsr
from repro.core import stream as jstream
from repro.launch import query as jquery
from repro.query import engine as jengine
from repro.query import service as jservice
from repro_torch.core import distributed as tdist
from repro_torch.core import hier as thier
from repro_torch.core import semiring as tsr
from repro_torch.core import stream as tstream
from repro_torch.kernels import registry as treg
from repro_torch.launch import query as tquery
from repro_torch.query import analytics as tanalytics
from repro_torch.query import engine as tengine
from repro_torch.query import service as tservice

import torch_parity as tp

CUTS = (16, 64, 512)
BLOCK = 8
NKEYS = 48
I = 3
_JAX = {}
_PORT = {}

KNOBS = [("plus.times", True, True), ("plus.times", True, False),
         ("plus.times", False, True), ("max.plus", False, True),
         ("min.plus", False, True), ("max.min", False, True)]
KNOB_IDS = [f"{s}-lazy{int(l)}-{'int' if i else 'float'}"
            for s, l, i in KNOBS]


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def _fleet(sr_name, lazy, integer):
    key = (sr_name, lazy, integer)
    if key not in _JAX:
        sr = jsr.get(sr_name)
        rows, cols, vals = tp.stream(51, (I, 25, BLOCK),
                                     16 if lazy else NKEYS, integer)
        states = jdist.create_instances(I, CUTS, BLOCK, sr=sr)
        states, _ = jstream.ingest_instances(
            states, jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
            sr=sr, lazy_l0=lazy)
        assert int(np.asarray(states.spills)[:, 0].min()) > 0
        assert int(np.asarray(states.layers[0].nnz).min()) > 0
        _JAX[key] = states
        # the same numpy stream through the port's ingest: the same state
        # (values within the registry rtol for the float stream)
        port, _ = tstream.ingest_instances(
            tdist.create_instances(I, CUTS, BLOCK, sr=tsr.get(sr_name),
                                   device="cpu"),
            *(torch.from_numpy(a) for a in (rows, cols, vals)), sr=sr_name,
            lazy_l0=lazy)
        tp.assert_states_equal(port, states, exact=integer)
        _PORT[key] = port
    return _JAX[key]


def _port(sr_name, lazy, integer):
    """The port's own state for the fleet of ``_fleet``."""
    _fleet(sr_name, lazy, integer)
    return _PORT[(sr_name, lazy, integer)]


ROWS_Q = np.array([0, 5, 11, 46, 3, 50, 7], np.int32)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("l0_mode", ["auto", "scan", "canon"])
@pytest.mark.parametrize("sr_name,lazy,integer", KNOBS, ids=KNOB_IDS)
def test_batched_engine_matches_vmap(sr_name, lazy, integer, l0_mode,
                                     use_kernel):
    """point_lookup, extract_rows (default width and width 2) and
    range_total on the [I, ...] fleet: equal to ``jax.vmap`` of the
    reference engine and to the port's per-instance calls."""
    js = _fleet(sr_name, lazy, integer)
    ts = _port(sr_name, lazy, integer)
    sr = jsr.get(sr_name)
    rng = np.random.default_rng(5)
    qr = rng.integers(0, NKEYS + 8, 40).astype(np.int32)
    qc = rng.integers(0, NKEYS + 8, 40).astype(np.int32)
    lo = np.array([0, 12, 30, 7, 40], np.int32)
    hi = np.array([12, 30, NKEYS, 9, 41], np.int32)
    (jqr, jqc, jrq, jlo, jhi), (tqr, tqc, trq, tlo, thi) = tp.both(
        qr, qc, ROWS_Q, lo, hi)

    def jax_calls(h):
        return dict(
            point=jengine.point_lookup(h, jqr, jqc, sr=sr, l0_mode=l0_mode),
            dense=jengine.extract_rows(h, jrq, NKEYS, sr=sr,
                                       l0_mode=l0_mode),
            dense_w2=jengine.extract_rows(h, jrq, NKEYS, sr=sr, width=2,
                                          l0_mode=l0_mode),
            range=jengine.range_total(h, jlo, jhi, sr=sr, l0_mode=l0_mode))

    def port_calls(h):
        kw = dict(sr=sr_name, use_kernel=use_kernel, l0_mode=l0_mode)
        return dict(
            point=tengine.point_lookup(h, tqr, tqc, **kw),
            dense=tengine.extract_rows(h, trq, NKEYS, **kw),
            dense_w2=tengine.extract_rows(h, trq, NKEYS, width=2, **kw),
            range=tengine.range_total(h, tlo, thi, **kw))

    key = ("engine", sr_name, lazy, integer, l0_mode)
    if key not in _JAX:                 # the same for both kernel routes
        _JAX[key] = jax.vmap(jax_calls)(js)
    want = _JAX[key]
    got = port_calls(ts)
    for k in ("point", "range"):
        assert got[k].shape == (I, len(want[k][0]))
        tp.assert_vals(got[k].numpy(), np.asarray(want[k]), exact=integer,
                       what=k)
    for k in ("dense", "dense_w2"):
        assert got[k][0].shape == (I, len(ROWS_Q), NKEYS)
        tp.assert_vals(got[k][0].numpy(), np.asarray(want[k][0]),
                       exact=integer, what=k)
        np.testing.assert_array_equal(got[k][1].numpy(),
                                      np.asarray(want[k][1]), err_msg=k)
    assert int(got["dense"][1].sum()) == 0      # default width never drops
    assert int(got["dense_w2"][1].sum()) > 0    # width 2 does, and says so
    for i in range(I):
        one = port_calls(tstream.instance(ts, i))
        for k in ("point", "range"):
            torch.testing.assert_close(one[k], got[k][i], rtol=0, atol=0)
        for k in ("dense", "dense_w2"):
            torch.testing.assert_close(one[k][0], got[k][0][i], rtol=0,
                                       atol=0)
            torch.testing.assert_close(one[k][1], got[k][1][i], rtol=0,
                                       atol=0)


@pytest.mark.parametrize("sr_name,lazy,integer", KNOBS, ids=KNOB_IDS)
def test_engine_matches_flushed_state(sr_name, lazy, integer):
    """Live extract_rows / range_total / point_lookup == the same queries
    on each instance's flushed hierarchy (the merge-then-read oracle)."""
    ts = _port(sr_name, lazy, integer)
    rows = torch.from_numpy(ROWS_Q)
    lo = torch.tensor([0, 9, 20], dtype=torch.int32)
    hi = torch.tensor([NKEYS, 10, 33], dtype=torch.int32)
    dense, trunc = tengine.extract_rows(ts, rows, NKEYS, sr=sr_name)
    total = tengine.range_total(ts, lo, hi, sr=sr_name)
    for i in range(I):
        flushed = thier.flush(tstream.instance(ts, i), sr_name, lazy_l0=lazy)
        want_dense, want_trunc = tengine.extract_rows(flushed, rows, NKEYS,
                                                      sr=sr_name)
        tp.assert_vals(dense[i].numpy(), want_dense.numpy(), exact=integer)
        assert int(trunc[i].sum()) == int(want_trunc.sum()) == 0
        tp.assert_vals(total[i].numpy(),
                       tengine.range_total(flushed, lo, hi,
                                           sr=sr_name).numpy(),
                       exact=integer)


def test_extract_rows_excludes_out_of_view_cols():
    """Column keys >= num_cols fall outside the dense view and are dropped
    (not clipped into the last column, and never counted as truncated),
    on both layer paths; as in the JAX package."""
    for lazy in (False, True):
        h = jhier.create((16, 64), block_size=4)
        h = jhier.update(h, jnp.array([1, 1, 1, 1], jnp.int32),
                         jnp.array([0, 3, 9, 600], jnp.int32),
                         jnp.ones((4,)), lazy_l0=lazy)
        dense, trunc = tengine.extract_rows(tp.to_torch(h),
                                            torch.tensor([1]), num_cols=8)
        want, want_trunc = jengine.extract_rows(h, jnp.array([1]), num_cols=8)
        tp.assert_vals(dense.numpy(), np.asarray(want), exact=True)
        assert float(dense.sum()) == 2.0 and int(trunc[0]) == 0
        assert int(want_trunc[0]) == 0
    h = jhier.create((32, 128), block_size=16)
    cols = jnp.concatenate([jnp.arange(8, dtype=jnp.int32),
                            jnp.arange(8, dtype=jnp.int32) + 100])
    h = jhier.update(h, jnp.ones((16,), jnp.int32), cols, jnp.ones((16,)))
    for mode in ("scan", "canon"):
        dense, trunc = tengine.extract_rows(tp.to_torch(h), torch.tensor([1]),
                                            num_cols=8, l0_mode=mode)
        assert float(dense.sum()) == 8.0
        assert int(trunc[0]) == 0, "out-of-view tail counted as truncation"


def test_extract_rows_truncation_is_counted():
    """A too-small window reports dropped entries, equal to the JAX
    package's count, and the default width drops none."""
    h = jhier.create((4, 16, 128), block_size=8)
    for i in range(6):
        cols = jnp.arange(8, dtype=jnp.int32) + 8 * (i % 2)
        h = jhier.update(h, jnp.zeros((8,), jnp.int32), cols, jnp.ones((8,)))
    th = tp.to_torch(h)
    for width in (2, 5, None):
        got, trunc = tengine.extract_rows(th, torch.tensor([0, 3]), 32,
                                          width=width)
        want, want_trunc = jengine.extract_rows(h, jnp.array([0, 3]), 32,
                                                width=width)
        tp.assert_vals(got.numpy(), np.asarray(want), exact=True)
        np.testing.assert_array_equal(trunc.numpy(), np.asarray(want_trunc))
        assert (int(trunc[0]) > 0) == (width is not None)
    assert float(got.sum()) == 48.0


def test_full_run_extract_and_range():
    """A full canonical layer-0 run (nnz == C == 8): the search for the
    last row's span end stays at C, so nothing is read twice."""
    h = jhier.create((4, 16), block_size=4)
    full = jassoc.AssocSegment(
        hi=jnp.asarray([0, 0, 1, 1, 2, 2, 3, 3], jnp.int32),
        lo=jnp.asarray([0, 1, 0, 1, 0, 1, 0, 1], jnp.int32),
        val=jnp.full((8,), 2.5, jnp.float32), nnz=jnp.int32(8))
    h = dataclasses.replace(h, layers=(full,) + h.layers[1:],
                            n_updates=jnp.uint32(8))
    th = tp.to_torch(h)
    seg = th.layers[0]
    p = tengine.searchsorted_pair(seg.hi, seg.lo, torch.tensor([3, 4]),
                                  torch.tensor([2, 0]))
    assert p.tolist() == [8, 8]
    for mode in ("scan", "canon"):
        dense, trunc = tengine.extract_rows(th, torch.tensor([3]), 8,
                                            l0_mode=mode)
        assert float(dense.sum()) == 5.0 and int(trunc[0]) == 0
        tot = tengine.range_total(th, torch.tensor([0]), torch.tensor([100]),
                                  l0_mode=mode)
        assert float(tot[0]) == 20.0


# ------------------------------------------------------------- service ----

def _service_stream(i=2, t=8, b=8, seed=11):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, NKEYS, (i, t, b)).astype(np.int32)
    cols = rng.integers(0, NKEYS, (i, t, b)).astype(np.int32)
    vals = np.ones((i, t, b), np.float32)
    q = rng.integers(0, NKEYS + 8, (2, 24)).astype(np.int32)
    return rows, cols, vals, q[0], q[1]


@pytest.mark.parametrize("rounds,t", [(1, 2), (0, 4), (3, 8)])
def test_run_service_rejects_bad_rounds(rounds, t):
    """rounds < 2 and a stream length not divisible by rounds raise the
    reference's ValueError, message for message."""
    r = np.zeros((1, t, 4), np.int32)
    v = np.ones((1, t, 4), np.float32)
    q = np.zeros((3,), np.int32)
    (jr, jv, jq), (tr, tv, tq) = tp.both(r, v, q)
    with pytest.raises(ValueError) as want:
        jservice.run_service(jdist.create_instances(1, (16, 64), 4),
                             jr, jr, jv, jq, jq, rounds=rounds)
    with pytest.raises(ValueError) as got:
        tservice.run_service(tdist.create_instances(1, (16, 64), 4,
                                                    device="cpu"),
                             tr, tr, tv, tq, tq, rounds=rounds)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_run_service_matches_reference(use_kernel):
    """The same schedule, counts and stats keys as the reference's
    ``run_service``; the final state equals the reference service's and
    the port's run without queries; the live answers at the end equal
    those of each instance's flushed state."""
    rows, cols, vals, qr, qc = _service_stream()
    (jrows, jcols, jvals, jqr, jqc), (trows, tcols, tvals, tqr, tqc) = \
        tp.both(rows, cols, vals, qr, qc)
    kw = dict(rounds=4, lazy_l0=True, analytics_num_rows=NKEYS,
              analytics_k=4, queries_per_round=2)
    jfinal, jstats = jservice.run_service(
        jdist.create_instances(2, CUTS, BLOCK), jrows, jcols, jvals, jqr,
        jqc, **kw)
    tfinal, tstats = tservice.run_service(
        tdist.create_instances(2, CUTS, BLOCK, device="cpu"), trows, tcols,
        tvals, tqr, tqc, use_kernel=use_kernel, **kw)
    assert tstats.keys() == jstats.keys()
    for k in ("n_updates", "n_queries", "rounds", "slo_breaches",
              "slo_p99_ms", "slo_attainment"):
        assert tstats[k] == jstats[k], k
    assert tstats["n_updates"] == 2 * 3 * 2 * BLOCK      # warm-up untimed
    assert tstats["n_queries"] == 2 * 3 * 2 * 24
    assert tstats["updates_per_s"] > 0 and tstats["queries_per_s"] > 0
    assert tstats["analytics_wall_s"] > 0
    assert tstats["latency_p50_s"] <= tstats["latency_p99_s"] \
        <= tstats["latency_max_s"]
    tp.assert_states_equal(tfinal, jfinal)
    base, bstats = tservice.run_service(
        tdist.create_instances(2, CUTS, BLOCK, device="cpu"), trows, tcols,
        tvals, tqr, tqc, use_kernel=use_kernel, with_queries=False, **kw)
    tp.assert_states_equal(base, jfinal)
    assert bstats["n_queries"] == 0 and bstats["queries_per_s"] == 0.0
    assert bstats["analytics_wall_s"] == 0.0
    live = tservice.make_point_query_fn(use_kernel=use_kernel)(tfinal, tqr,
                                                               tqc)
    totals, ids = tservice.make_analytics_fn(NKEYS, 4)(tfinal)
    for i in range(2):
        flushed = thier.flush(tstream.instance(tfinal, i), lazy_l0=True)
        torch.testing.assert_close(
            live[i], tengine.point_lookup(flushed, tqr, tqc), rtol=0, atol=0)
        ft, fi = tanalytics.top_k_rows(flushed, NKEYS, 4)
        torch.testing.assert_close(totals[i], ft, rtol=0, atol=0)
        torch.testing.assert_close(ids[i], fi, rtol=0, atol=0)


def test_run_service_slo_accounting():
    """A p99 target below any batch time breaches every batch; the
    attainment and breach count follow."""
    rows, cols, vals, qr, qc = _service_stream(seed=12)
    _, (trows, tcols, tvals, tqr, tqc) = tp.both(rows, cols, vals, qr, qc)
    _, stats = tservice.run_service(
        tdist.create_instances(2, CUTS, BLOCK, device="cpu"), trows, tcols,
        tvals, tqr, tqc, rounds=4, lazy_l0=True, slo_p99_ms=1e-9)
    assert stats["slo_breaches"] == 3 and stats["slo_attainment"] == 0.0


def _reference_defaults(monkeypatch) -> dict:
    """The reference CLI's parsed defaults (its parser is built inside
    ``main``: run it with ``run`` replaced)."""
    seen = {}

    def fake_run(args):
        seen.update(vars(args))
        return dict(updates_per_s=1.0, ingest_only_updates_per_s=1.0,
                    ingest_interference=0.0, queries_per_s=1.0, n_queries=1,
                    latency_p50_s=0.0, latency_p95_s=0.0, latency_p99_s=0.0,
                    latency_max_s=0.0)
    monkeypatch.setattr(jquery, "run", fake_run)
    monkeypatch.setattr("sys.argv", ["query"])
    jquery.main()
    return seen


def test_launch_query_flags_match_reference(monkeypatch):
    """The same flags and defaults as ``repro.launch.query``,
    ``--precompile``/``--stages-cache`` among them, plus ``--device``
    (default cuda)."""
    want = _reference_defaults(monkeypatch)
    got = vars(tquery.parser().parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want
    assert got["precompile"] is False and got["stages_cache"] == ""


def test_launch_query_run_on_cpu():
    """The CLI's run on the CPU: baseline then service on the same stream,
    equal final states, the interference figure and the launch deltas
    (the plain versions launch nothing)."""
    args = tquery.parser().parse_args([
        "--instances", "2", "--blocks", "8", "--block-size", "16",
        "--cuts", "32,128,512", "--scale", "8", "--rounds", "4",
        "--queries", "64", "--top-k", "4", "--use-kernel", "--device", "cpu"])
    stats, base, states = tquery.run_with_states(args)
    a, b = thier.state_to_numpy(base), thier.state_to_numpy(states)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
    assert thier.exact_update_count(states) == 2 * 8 * 16
    assert stats["ingest_only_updates_per_s"] > 0
    assert stats["ingest_interference"] == pytest.approx(
        1.0 - stats["updates_per_s"] / stats["ingest_only_updates_per_s"])
    assert stats["n_queries"] == 2 * 3 * 64
    assert set(stats["launches"]) == set(treg.LAUNCHES)
    assert stats["launches"] == stats["ingest_only_launches"] \
        == dict.fromkeys(treg.LAUNCHES, 0) | {
            "assoc.sort_route": stats["launches"]["assoc.sort_route"]}
