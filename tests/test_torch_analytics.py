"""Port parity: ``repro_torch.query.analytics`` against
``repro.query.analytics``.

Every analytics function (``out_degrees``, ``in_degrees``,
``degree_vectors``, ``row_occupancy``, ``top_k_rows``, ``spmv``,
``spmv_t``, ``ata_correlation``) on a 3-instance fleet ingested by the JAX
package (cuts (16, 64, 512), block 8, keys past layer-0 spills) and
carried over: the port's batched call against ``jax.vmap`` of the
reference, against the port's own per-instance calls, and against
reductions of the flushed state.  Under plus.times with lazy layer 0 on
and off, and under max.plus, min.plus and max.min (the reference allows
the lazy buffer under plus.times only).  ``top_k_rows`` with ties across
the k-th place returns ``lax.top_k``'s ids, also ascending under min.plus
and on an int32 hierarchy.  Tolerance: exact on integer-valued streams,
the registry rtol (1e-4) on the float one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hier as jhier
from repro.core import semiring as jsr
from repro.core import stream as jstream
from repro.query import analytics as janalytics
from repro_torch.core import assoc as tassoc
from repro_torch.core import distributed as tdist
from repro_torch.core import hier as thier
from repro_torch.core import stream as tstream
from repro_torch.query import analytics as tanalytics

import torch_parity as tp

CUTS = (16, 64, 512)
BLOCK = 8
NKEYS = 48
I = 3
_JAX = {}
_PORT = {}

CASES = [("plus.times", True, True), ("plus.times", False, True),
         ("plus.times", True, False), ("max.plus", False, True),
         ("min.plus", False, True), ("max.min", False, True)]
CASE_IDS = [f"{s}-lazy{int(l)}-{'int' if i else 'float'}"
            for s, l, i in CASES]


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def _fleet(sr_name, lazy, integer):
    """A JAX fleet of I instances past several spills; lazy runs draw from
    fewer keys, so the append buffer holds duplicates."""
    key = (sr_name, lazy, integer)
    if key not in _JAX:
        sr = jsr.get(sr_name)
        rows, cols, vals = tp.stream(41, (I, 25, BLOCK),
                                     12 if lazy else NKEYS, integer)
        states = jhier.create(CUTS, BLOCK, sr=sr)
        states = jax.tree.map(lambda x: jnp.stack([x] * I), states)
        states, _ = jstream.ingest_instances(
            states, jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
            sr=sr, lazy_l0=lazy)
        assert int(np.asarray(states.spills)[:, 0].min()) > 0
        assert int(np.asarray(states.layers[0].nnz).min()) > 0
        _JAX[key] = states
        _PORT[key] = _port_ingest(states, sr_name, lazy, integer, rows,
                                  cols, vals)
    return _JAX[key]


def _port_ingest(jstates, sr_name, lazy, integer, rows, cols, vals):
    """The same numpy stream through the port's ``ingest_instances``: the
    state equals the JAX package's (values within the registry rtol for
    the float stream)."""
    t, _ = tstream.ingest_instances(
        tdist.create_instances(I, CUTS, BLOCK,
                               sr=tanalytics.sr_mod.get(sr_name),
                               device="cpu"),
        *(torch.from_numpy(a) for a in (rows, cols, vals)), sr=sr_name,
        lazy_l0=lazy)
    tp.assert_states_equal(t, jstates, exact=integer)
    return t


def _port(sr_name, lazy, integer):
    """The port's own state for the fleet of ``_fleet``."""
    _fleet(sr_name, lazy, integer)
    return _PORT[(sr_name, lazy, integer)]


def _x(seed, n, integer):
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, n) if integer else rng.normal(size=n)
    return x.astype(np.float32)


def _calls(mod, h, x_cols, x_rows, sr):
    """Every analytics function of ``mod`` on one state, views of NKEYS."""
    deg = mod.degree_vectors(h, NKEYS, NKEYS, sr)
    return dict(
        out_degrees=mod.out_degrees(h, NKEYS, sr),
        in_degrees=mod.in_degrees(h, NKEYS, sr),
        degree_vectors_out=deg[0], degree_vectors_in=deg[1],
        row_occupancy=mod.row_occupancy(h, NKEYS),
        top_k_totals=mod.top_k_rows(h, NKEYS, 5, sr)[0],
        top_k_ids=mod.top_k_rows(h, NKEYS, 5, sr)[1],
        spmv=mod.spmv(h, x_cols, NKEYS, sr),
        spmv_t=mod.spmv_t(h, x_rows, NKEYS, sr),
        ata_correlation=mod.ata_correlation(h, x_cols, NKEYS, NKEYS, sr))


@pytest.mark.parametrize("sr_name,lazy,integer", CASES, ids=CASE_IDS)
def test_analytics_match_vmap_and_per_instance(sr_name, lazy, integer):
    js = _fleet(sr_name, lazy, integer)
    ts = _port(sr_name, lazy, integer)
    x_cols, x_rows = _x(1, NKEYS, integer), _x(2, NKEYS, integer)
    (jxc, jxr), (txc, txr) = tp.both(x_cols, x_rows)
    jsr_, tsr_ = jsr.get(sr_name), tanalytics.sr_mod.get(sr_name)
    got = _calls(tanalytics, ts, txc, txr, tsr_)
    want = jax.vmap(lambda h: _calls(janalytics, h, jxc, jxr, jsr_))(js)
    for k in got:
        assert got[k].shape[0] == I, k
        tp.assert_vals(got[k].numpy(), np.asarray(want[k]), exact=integer,
                       what=k)
    for i in range(I):
        one = _calls(tanalytics, tstream.instance(ts, i), txc, txr, tsr_)
        for k in one:
            torch.testing.assert_close(one[k], got[k][i], rtol=0, atol=0,
                                       msg=f"instance {i} {k}")


@pytest.mark.parametrize("sr_name,lazy,integer", CASES, ids=CASE_IDS)
def test_analytics_match_flushed_reductions(sr_name, lazy, integer):
    """The live, unflushed fleet against assoc reductions of each
    instance's flushed last layer (the merge-then-read oracle)."""
    ts = _port(sr_name, lazy, integer)
    sr = tanalytics.sr_mod.get(sr_name)
    x = torch.from_numpy(_x(3, NKEYS, integer))
    for i in range(I):
        h = tstream.instance(ts, i)
        merged = thier.flush(h, sr, lazy_l0=lazy).layers[-1]
        pairs = [
            (tanalytics.out_degrees(h, NKEYS, sr),
             tassoc.reduce_rows(merged, NKEYS, sr)),
            (tanalytics.in_degrees(h, NKEYS, sr),
             tassoc.reduce_cols(merged, NKEYS, sr)),
            (tanalytics.spmv(h, x, NKEYS, sr),
             tassoc.spmv(merged, x, NKEYS, sr)),
            (tanalytics.spmv_t(h, x, NKEYS, sr),
             tassoc.spmv_t(merged, x, NKEYS, sr)),
            (tanalytics.ata_correlation(h, x, NKEYS, NKEYS, sr),
             tassoc.spmv_t(merged, tassoc.spmv(merged, x, NKEYS, sr),
                           NKEYS, sr)),
            # a row is live iff the merge holds a key of it
            ((tanalytics.row_occupancy(h, NKEYS) > 0),
             torch.isin(torch.arange(NKEYS), merged.hi[:int(merged.nnz)])),
        ]
        for got, want in pairs:
            tp.assert_vals(got.numpy(), want.numpy(), exact=integer)


def test_analytics_ignore_dirty_raw_tail():
    """The raw-buffer contract is nnz, not the sentinel tail: garbage
    planted past the lazy buffer's nnz changes no analytics result, in
    either package."""
    js = _fleet("plus.times", True, True)
    l0 = js.layers[0]
    tail = jnp.arange(l0.capacity)[None, :] >= l0.nnz[:, None]
    assert bool(tail.any())
    dirty_l0 = dataclasses.replace(
        l0, hi=jnp.where(tail, 1, l0.hi), lo=jnp.where(tail, 2, l0.lo),
        val=jnp.where(tail, jnp.float32(1e6), l0.val))
    jdirty = dataclasses.replace(js, layers=(dirty_l0,) + js.layers[1:])
    x = _x(4, NKEYS, True)
    (jx,), (tx,) = tp.both(x)
    sr_t, sr_j = tanalytics.sr_mod.PLUS_TIMES, jsr.PLUS_TIMES
    clean = _calls(tanalytics, tp.to_torch(js), tx, tx, sr_t)
    dirty = _calls(tanalytics, tp.to_torch(jdirty), tx, tx, sr_t)
    want = jax.vmap(lambda h: _calls(janalytics, h, jx, jx, sr_j))(jdirty)
    for k in clean:
        torch.testing.assert_close(dirty[k], clean[k], rtol=0, atol=0, msg=k)
        tp.assert_vals(dirty[k].numpy(), np.asarray(want[k]), exact=True,
                       what=k)


def _tie_fleet(sr_name, dtype):
    """Three instances whose row totals tie across the k-th place: rows
    0..9 each total 2 (two entries of 1), rows 20 and 30 total 3, row 40
    totals 1, instance 1 shifts the ties by 5 rows and instance 2 holds one
    live row only (k past the live count)."""
    sr = jsr.get(sr_name)
    hs = []
    for shift, n_rows in ((0, 10), (5, 10), (0, 0)):
        rows = [r + shift for r in range(n_rows) for _ in range(2)]
        rows += [20] * 3 + [30] * 3 + [40]
        cols = list(range(len(rows)))
        n = len(rows)
        block = 32
        rows += [jnp.iinfo(jnp.int32).max] * (block - n)
        cols += [jnp.iinfo(jnp.int32).max] * (block - n)
        if n_rows == 0:
            rows = [7] + [jnp.iinfo(jnp.int32).max] * (block - 1)
            cols = [3] + [jnp.iinfo(jnp.int32).max] * (block - 1)
            n = 1
        vals = np.zeros(block, dtype)
        vals[:n] = 1
        h = jhier.create((32, 64), block, dtype=dtype, sr=sr)
        mask = np.arange(block) < n
        h = jhier.update(h, jnp.asarray(rows, jnp.int32),
                         jnp.asarray(cols, jnp.int32), jnp.asarray(vals),
                         mask=jnp.asarray(mask), sr=sr)
        hs.append(h)
    return jax.tree.map(lambda *xs: jnp.stack(xs), *hs)


@pytest.mark.parametrize("k", [4, 11, 16])
@pytest.mark.parametrize("sr_name,dtype", [
    ("plus.times", np.float32), ("plus.times", np.int32),
    ("max.plus", np.float32), ("min.plus", np.float32),
    ("min.plus", np.int32)])
def test_top_k_rows_ties_match_lax_top_k(sr_name, dtype, k):
    """Equal totals straddle the k-th place; the port returns the same ids
    as ``lax.top_k`` (ties in ascending row order), the same totals, and
    the same padding (worst value, lowest dead rows) past the live rows;
    integer totals stay int32."""
    js = _tie_fleet(sr_name, dtype)
    ts = tp.to_torch(js)
    sr_j, sr_t = jsr.get(sr_name), tanalytics.sr_mod.get(sr_name)
    totals, ids = tanalytics.top_k_rows(ts, 48, k, sr_t)
    jt, ji = jax.vmap(lambda h: janalytics.top_k_rows(h, 48, k, sr_j))(js)
    assert ids.dtype == torch.int32
    assert totals.dtype == (torch.int32 if dtype == np.int32
                            else torch.float32)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    tp.assert_vals(totals.numpy(), np.asarray(jt), exact=True)
    for i in range(3):
        t1, i1 = tanalytics.top_k_rows(tstream.instance(ts, i), 48, k, sr_t)
        torch.testing.assert_close(t1, totals[i], rtol=0, atol=0)
        torch.testing.assert_close(i1, ids[i], rtol=0, atol=0)


def test_top_k_rows_negative_totals_and_signed_zero():
    """plus.times with negative totals (dead rows' 0.0 must not outrank
    them) and a live row summing to -0.0 next to one summing to +0.0:
    ``lax.top_k``'s total order puts +0.0 first."""
    h = jhier.create((16, 64), 8)
    rows = jnp.asarray([2, 2, 4, 4, 6, 6, 8, 8], jnp.int32)
    cols = jnp.arange(8, dtype=jnp.int32)
    vals = jnp.asarray([-2., -1., -.5, -.25, -0., -0., 1., -1.], jnp.float32)
    h = jhier.update(h, rows, cols, vals)
    th = tp.to_torch(h)
    for k in (2, 4, 6):
        totals, ids = tanalytics.top_k_rows(th, 10, k)
        jt, ji = janalytics.top_k_rows(h, 10, k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(np.signbit(totals.numpy()),
                                      np.signbit(np.asarray(jt)))
        tp.assert_vals(totals.numpy(), np.asarray(jt), exact=True)


def _f32(x) -> np.ndarray:
    """A JAX array or port tensor of any float width as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("sr_name", ["plus.times", "max.plus", "min.plus",
                                     "max.min"])
def test_top_k_rows_16bit_totals_match_reference(sr_name, dtype):
    """bf16 and f16 hierarchies (one instance and a fleet of 2) rank their
    totals exactly as ``lax.top_k`` does, ties in ascending row order;
    ``run_service`` with analytics on, which ranked them in every batch,
    ends in the reference service's state."""
    from repro.core import distributed as jdist
    from repro.query import service as jservice
    from repro_torch.query import service as tservice
    rows, cols, vals = tp.stream(0, (4, 32), 40)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    sr_j, sr_t = jsr.get(sr_name), tanalytics.sr_mod.get(sr_name)
    cuts = (48, 96, 512)
    jh, _ = jstream.ingest(jhier.create(cuts, 32, dtype=jdt, sr=sr_j),
                           *map(jnp.asarray, (rows, cols, vals)), sr=sr_j)
    th, _ = tstream.ingest(thier.create(cuts, 32, dtype=tdt, sr=sr_t,
                                        device="cpu"),
                           *map(torch.from_numpy, (rows, cols, vals)),
                           sr=sr_t)
    for k in (5, 40):
        totals, ids = tanalytics.top_k_rows(th, 40, k, sr_t)
        jt, ji = janalytics.top_k_rows(jh, 40, k, sr_j)
        assert totals.dtype == tdt and ids.dtype == torch.int32
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(_f32(totals), _f32(jt))
    fleet = (np.stack([rows, rows[::-1]]), np.stack([cols, cols[::-1]]),
             np.stack([vals, vals[::-1]]))
    q = np.arange(24, dtype=np.int32)
    (jr, jc, jv, jq), (tr, tc, tv, tq) = tp.both(*fleet, q)
    kw = dict(rounds=2, analytics_num_rows=40, analytics_k=5, sr=sr_name)
    jfinal, _ = jservice.run_service(
        jdist.create_instances(2, cuts, 32, dtype=jdt, sr=sr_j), jr, jc, jv,
        jq, jq, **{**kw, "sr": sr_j})
    tfinal, stats = tservice.run_service(
        tdist.create_instances(2, cuts, 32, dtype=tdt, sr=sr_t,
                               device="cpu"), tr, tc, tv, tq, tq,
        **{**kw, "sr": sr_t})
    assert stats["analytics_wall_s"] > 0
    for tl, jl in zip(tfinal.layers, jfinal.layers):
        for f in ("hi", "lo", "nnz"):
            np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                          np.asarray(getattr(jl, f)))
        np.testing.assert_array_equal(_f32(tl.val), _f32(jl.val))
    totals, ids = tservice.make_analytics_fn(40, 5, sr_t)(tfinal)
    jt, ji = jax.vmap(lambda h: janalytics.top_k_rows(h, 40, 5, sr_j))(
        jfinal)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(_f32(totals), _f32(jt))
