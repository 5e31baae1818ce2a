"""Port parity of ``repro_torch.core.vassoc`` against ``repro.core.vassoc``
on the same numpy inputs: ``from_rows`` (with masks, and overflowing its
capacity), ``merge``, the ``update`` cascade, ``drain_to_table``,
``scatter_apply`` on a raw buffer (``sorted=False``) and ``query_all``.
Keys, nnz, spills, overflow and the int32 ``n_updates`` exact; values
exact on integer-valued payloads, within rtol 1e-4 otherwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import vassoc as jv
from repro_torch.core import vassoc as tv
from repro_torch.core.assoc import SENTINEL
from repro_torch.obs import trace as ttrace

RTOL = 1e-4


def _rows(rng, n, nkeys, dim, integer_vals=True):
    keys = rng.integers(0, nkeys, n).astype(np.int32)
    vals = (rng.integers(-4, 5, (n, dim)) if integer_vals
            else rng.normal(size=(n, dim))).astype(np.float32)
    return keys, vals


def _seg_equal(t, j, exact=True):
    np.testing.assert_array_equal(t.key.numpy(), np.asarray(j.key))
    np.testing.assert_array_equal(t.nnz.numpy(), np.asarray(j.nnz))
    assert t.key.dtype == torch.int32 and t.nnz.dtype == torch.int32
    if exact:
        np.testing.assert_array_equal(t.val.numpy(), np.asarray(j.val))
    else:
        np.testing.assert_allclose(t.val.numpy(), np.asarray(j.val),
                                   rtol=RTOL, atol=1e-6)


def _hier_equal(t, j, exact=True):
    assert t.cuts == tuple(j.cuts)
    for tl, jl in zip(t.layers, j.layers):
        _seg_equal(tl, jl, exact)
    for f in ("spills", "overflow", "n_updates"):
        got = getattr(t, f)
        assert got.dtype == torch.int32, f
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)


@pytest.mark.parametrize("integer_vals", [True, False])
@pytest.mark.parametrize("capacity", [64, 20, 5])
def test_from_rows_and_merge(capacity, integer_vals):
    """Capacities above, between and below the unique count (overflow)."""
    rng = np.random.default_rng(capacity)
    k, v = _rows(rng, 40, 25, 3, integer_vals)
    mask = rng.random(40) < 0.7
    for m in (None, mask):
        js, jo = jv.from_rows(jnp.asarray(k), jnp.asarray(v), capacity,
                              None if m is None else jnp.asarray(m))
        ts, to = tv.from_rows(torch.from_numpy(k), torch.from_numpy(v),
                              capacity, None if m is None
                              else torch.from_numpy(m))
        _seg_equal(ts, js, integer_vals)
        assert int(to) == int(jo) and to.dtype == torch.int32
    k2, v2 = _rows(rng, 30, 25, 3, integer_vals)
    ja, _ = jv.from_rows(jnp.asarray(k), jnp.asarray(v), 40)
    jb, _ = jv.from_rows(jnp.asarray(k2), jnp.asarray(v2), 30)
    ta, _ = tv.from_rows(torch.from_numpy(k), torch.from_numpy(v), 40)
    tb, _ = tv.from_rows(torch.from_numpy(k2), torch.from_numpy(v2), 30)
    jm, jo = jv.merge(ja, jb, capacity)
    tm, to = tv.merge(ta, tb, capacity)
    _seg_equal(tm, jm, integer_vals)
    assert int(to) == int(jo)


@pytest.mark.parametrize("integer_vals", [True, False])
def test_update_cascade_drain_and_query_all(integer_vals):
    """Twelve blocks (every other one masked) through cuts (8, 24, 60):
    every layer, spill and overflow count and the counter equal after each
    update; then ``query_all`` and ``drain_to_table`` (in place in the
    port) equal."""
    rng = np.random.default_rng(7)
    cuts, block, dim = (8, 24, 60), 16, 4
    jh = jv.create(cuts, block, dim)
    th = tv.create(cuts, block, dim, device="cpu")
    _hier_equal(th, jh)
    syncs = ttrace.host_reads().get("vassoc", 0)
    jupdate = jax.jit(jv.update)
    for i in range(12):
        k, v = _rows(rng, block, 90, dim, integer_vals)
        m = rng.random(block) < 0.6 if i % 2 else None
        jh = jupdate(jh, jnp.asarray(k), jnp.asarray(v),
                     None if m is None else jnp.asarray(m))
        th = tv.update(th, torch.from_numpy(k), torch.from_numpy(v),
                       None if m is None else torch.from_numpy(m))
        _hier_equal(th, jh, integer_vals)
    # one host read per layer boundary per update
    assert ttrace.host_reads()["vassoc"] - syncs == 12 * (len(cuts) - 1)
    assert int(th.spills[-2]) > 0
    _seg_equal(tv.query_all(th), jv.query_all(jh), integer_vals)
    table = rng.normal(size=(90, dim)).astype(np.float32)
    jh2, jt = jv.drain_to_table(jh, jnp.asarray(table), -0.25)
    tt = torch.from_numpy(table.copy())
    th2, tt2 = tv.drain_to_table(th, tt, -0.25)
    assert tt2 is tt                                 # in place
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=RTOL,
                               atol=1e-6)
    _hier_equal(th2, jh2)
    assert all(int(l.nnz) == 0 for l in th2.layers)


def test_n_updates_wraps_as_int32():
    """The counter is int32 in both packages (a quirk kept for parity)."""
    th = tv.create((4,), 4, 2, device="cpu")
    jh = jv.create((4,), 4, 2)
    near = 2**31 - 3
    th = tv.HierVec(th.layers, th.spills, th.overflow,
                    torch.tensor(near, dtype=torch.int32), th.cuts)
    jh = jv.HierVec(jh.layers, jh.spills, jh.overflow, jnp.int32(near),
                    jh.cuts)
    k, v = np.arange(4, dtype=np.int32), np.ones((4, 2), np.float32)
    th = tv.update(th, torch.from_numpy(k), torch.from_numpy(v))
    jh = jv.update(jh, jnp.asarray(k), jnp.asarray(v))
    assert int(th.n_updates) == int(jh.n_updates) < 0


@pytest.mark.parametrize("sorted_", [True, False])
def test_scatter_apply_raw_buffer(sorted_):
    """A raw buffer whose tail past ``nnz`` holds live-looking keys: with
    ``sorted=False`` the nnz gate drops them in both packages; with
    ``sorted=True`` both trust the keys.  Keys past the table are clipped,
    SENTINEL dropped."""
    key = np.array([3, 1, 7, SENTINEL, 2, 5, 99], np.int32)
    val = np.arange(14, dtype=np.float32).reshape(7, 2)
    nnz = np.int32(3)
    table = np.zeros((8, 2), np.float32)
    want = jv.scatter_apply(jnp.asarray(table),
                            jv.VecSegment(jnp.asarray(key), jnp.asarray(val),
                                          jnp.asarray(nnz)), 2.0,
                            sorted=sorted_)
    seg = tv.VecSegment(torch.from_numpy(key), torch.from_numpy(val),
                        torch.tensor(nnz))
    got = tv.scatter_apply(torch.from_numpy(table.copy()), seg, 2.0,
                           sorted=sorted_)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[2].abs().sum() == (0 if not sorted_ else 2 * (8 + 9))


def test_empty_and_clear():
    t = tv.empty(5, 3, device="cpu")
    j = jv.empty(5, 3)
    _seg_equal(t, j)
    k, v = _rows(np.random.default_rng(0), 6, 9, 3)
    ts, _ = tv.from_rows(torch.from_numpy(k), torch.from_numpy(v), 8)
    _seg_equal(tv.clear(ts), jv.empty(8, 3))
