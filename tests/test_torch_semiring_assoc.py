"""Port parity: ``repro_torch.core.semiring`` / ``assoc`` against
``repro.core.semiring`` / ``assoc`` on the same numpy inputs, across the
four semirings, masked and unmasked, with negative ``lo`` keys (the packed
sort key's lexicographic-order hazard), overflow at ``out_capacity < n``
and empty-segment zeros.  Keys and nnz exact; values exact on integer
inputs, within rtol 1e-4 on float ones (float sums taken in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import assoc as jassoc
from repro.core import semiring as jsr
from repro_torch.core import assoc as tassoc
from repro_torch.core import semiring as tsr

import torch_parity as tp

SRS = ["plus.times", "max.plus", "min.plus", "max.min"]


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def _block(seed, n, nkeys, dtype, neg_lo=True):
    rng = np.random.default_rng(seed)
    rows = rng.integers(-3, nkeys, n).astype(np.int32)
    cols = rng.integers(-nkeys if neg_lo else 0, nkeys, n).astype(np.int32)
    cols[::5] = rng.integers(-2**31, 2**31 - 1, len(cols[::5]))
    vals = (rng.integers(-50, 50, n) if dtype == np.int32
            else rng.normal(size=n)).astype(dtype)
    mask = rng.random(n) < 0.7
    return rows, cols, vals, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("name", SRS)
def test_semiring_zero_and_empty_segments(name, dtype):
    """integer_zero, reduce_kind and segment_add (empty segments hold the
    semiring zero, as jax.ops.segment_max/min leave them)."""
    t, j = tsr.get(name), jsr.get(name)
    np_dtype = np.float32 if dtype == torch.float32 else np.int32
    assert tsr.reduce_kind(t) == jsr.reduce_kind(j)
    assert np.asarray(tsr.integer_zero(t, dtype), np_dtype) == \
        np.asarray(jsr.integer_zero(j, np_dtype))
    vals = np.array([3, -1, 7, 2], np_dtype)
    ids = np.array([0, 0, 3, 3], np.int32)   # segments 1, 2 and 4 are empty
    got = t.segment_add(torch.from_numpy(vals), torch.from_numpy(ids), 5)
    want = j.segment_add(jnp.asarray(vals), jnp.asarray(ids), 5)
    tp.assert_vals(got.numpy(), np.asarray(want), exact=True)


def test_unknown_semiring_raises():
    with pytest.raises(ValueError, match="unknown semiring"):
        tsr.get("nope")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("name", SRS)
def test_from_coo_matches(name, dtype, masked):
    rows, cols, vals, mask = _block(1, 96, 12, dtype)
    t, j = tsr.get(name), jsr.get(name)
    m = mask if masked else None
    (jr, jc, jv), (tr, tc, tv) = tp.both(rows, cols, vals)
    for cap in (96, 128, 10):                     # exact, padded, overflow
        jseg, jovf = jassoc.from_coo(jr, jc, jv, cap, j,
                                     mask=None if m is None
                                     else jnp.asarray(m))
        tseg, tovf = tassoc.from_coo(tr, tc, tv, cap, t,
                                     mask=None if m is None
                                     else torch.from_numpy(m))
        tp.assert_segment_equal(tseg, jseg, exact=dtype == np.int32)
        assert int(tovf) == int(jovf)
    assert int(jovf) > 0                          # cap 10 overflowed


def test_negative_lo_sorts_lexicographically():
    """(hi, lo) orders as a signed pair: a naive hi << 32 | lo pack would
    put (0, -1) after (0, 5) and (1, 0) below (0, -1)."""
    rows = torch.tensor([0, 0, 1, 0, -1], dtype=torch.int32)
    cols = torch.tensor([5, -1, 0, -2**31, 7], dtype=torch.int32)
    seg, _ = tassoc.from_coo(rows, cols, torch.ones(5), 5)
    assert seg.hi.tolist() == [-1, 0, 0, 0, 1]
    assert seg.lo.tolist() == [7, -2**31, -1, 5, 0]


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", SRS)
def test_merge_and_merge_many_match(name, use_kernel):
    t, j = tsr.get(name), jsr.get(name)
    segs_t, segs_j = [], []
    for seed, cap in ((2, 64), (3, 40)):
        rows, cols, vals, _ = _block(seed, cap, 16, np.float32)
        (jr, jc, jv), (tr, tc, tv) = tp.both(rows, cols, vals)
        segs_j.append(jassoc.from_coo(jr, jc, jv, cap, j)[0])
        segs_t.append(tassoc.from_coo(tr, tc, tv, cap, t)[0])
    for cap in (104, 20):
        merge_t = tassoc.merge_kernel if use_kernel else tassoc.merge
        tseg, tovf = merge_t(segs_t[0], segs_t[1], cap, t)
        jseg, jovf = jassoc.merge(segs_j[0], segs_j[1], cap, j)
        tp.assert_segment_equal(tseg, jseg, exact=False)
        assert int(tovf) == int(jovf)
    rows, cols, vals, mask = _block(4, 24, 16, np.float32)
    (jr, jc, jv, jm), (tr, tc, tv, tm) = tp.both(rows, cols, vals, mask)
    jr, jc, jv = jassoc.mask_coo(jr, jc, jv, jm, j)
    tr, tc, tv = tassoc.mask_coo(tr, tc, tv, tm, t)
    for cap in (128, 30):
        tseg, tovf = tassoc.merge_many(segs_t, tr, tc, tv, out_capacity=cap,
                                       sr=t, use_kernel=use_kernel)
        jseg, jovf = jassoc.merge_many(segs_j, jr, jc, jv, out_capacity=cap,
                                       sr=j)
        tp.assert_segment_equal(tseg, jseg, exact=False)
        assert int(tovf) == int(jovf)


@pytest.mark.parametrize("name", SRS)
def test_gate_segment_and_lookup(name):
    t, j = tsr.get(name), jsr.get(name)
    rows, cols, vals, _ = _block(5, 32, 6, np.float32)
    (jr, jc, jv), (tr, tc, tv) = tp.both(rows, cols, vals)
    jseg = jassoc.from_coo(jr, jc, jv, 40, j)[0]
    tseg = tassoc.from_coo(tr, tc, tv, 40, t)[0]
    for keep in (True, False):
        tp.assert_segment_equal(tassoc.gate_segment(tseg, keep, t),
                                jassoc.gate_segment(jseg, keep, j))
        tp.assert_segment_equal(
            tassoc.gate_segment(tseg, torch.tensor(keep), t),
            jassoc.gate_segment(jseg, jnp.asarray(keep), j))
    for r, c in ((int(rows[0]), int(cols[0])), (999, 999)):
        for srt in (True, False):
            tp.assert_vals(tassoc.lookup(tseg, r, c, t, sorted=srt).numpy(),
                           np.asarray(jassoc.lookup(jseg, r, c, j,
                                                    sorted=srt)),
                           exact=False)


def test_clear_and_empty():
    seg = tassoc.empty(8, torch.int32, tsr.MAX_PLUS, device="cpu")
    want = jassoc.empty(8, jnp.int32, jsr.MAX_PLUS)
    tp.assert_segment_equal(seg, want)
    tp.assert_segment_equal(tassoc.clear(seg, tsr.MAX_PLUS), want)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("name", SRS)
def test_segment_add_drops_out_of_range_ids(name, dtype):
    """Ids below 0 and at or above ``num_segments`` are dropped, as
    ``jax.ops.segment_sum/max/min`` drop them (they used to raise, or trip
    a device assert on the card)."""
    t, j = tsr.get(name), jsr.get(name)
    rng = np.random.default_rng(6)
    vals = (rng.integers(-50, 50, 200) if dtype == np.int32
            else rng.normal(size=200)).astype(dtype)
    ids = rng.integers(-8, 20, 200).astype(np.int32)
    ids[:4] = [-2**31, 2**31 - 1, 12, -1]
    for n in (12, 1, 25):
        got = t.segment_add(torch.from_numpy(vals), torch.from_numpy(ids), n)
        want = j.segment_add(jnp.asarray(vals), jnp.asarray(ids), n)
        assert got.shape == (n,)
        tp.assert_vals(got.numpy(), np.asarray(want), exact=False,
                       what=f"n={n}")


def _segments(name, dtype):
    """(canonical, raw) segments of both packages: keys in [-3, 12) rows
    and signed cols (some far out of range); the raw one unsorted with
    duplicates and a dirty (non-sentinel) tail past nnz."""
    t, j = tsr.get(name), jsr.get(name)
    rows, cols, vals, mask = _block(7, 64, 12, dtype)
    (jr, jc, jv, jm), (tr, tc, tv, tm) = tp.both(rows, cols, vals, mask)
    canon = (tassoc.from_coo(tr, tc, tv, 80, t, mask=tm)[0],
             jassoc.from_coo(jr, jc, jv, 80, j, mask=jm)[0])
    nnz = np.int32(50)
    raw = (tassoc.AssocSegment(tr, tc, tv, torch.tensor(nnz)),
           jassoc.AssocSegment(jr, jc, jv, jnp.asarray(nnz)))
    return canon, raw


def _reductions(mod, seg, x_rows, x_cols, sr, srt):
    """Every reduction of ``mod`` (either package's assoc) with views of
    8 rows and 10 cols, narrower than the key space."""
    return dict(
        reduce_rows=mod.reduce_rows(seg, 8, sr, sorted=srt),
        reduce_cols=mod.reduce_cols(seg, 10, sr, sorted=srt),
        spmv=mod.spmv(seg, x_cols, 8, sr, sorted=srt),
        spmv_t=mod.spmv_t(seg, x_rows, 10, sr, sorted=srt),
        to_dense=mod.to_dense(seg, 8, 10, sr, sorted=srt),
        total=mod.total(seg, sr, sorted=srt))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("name", SRS)
def test_reductions_match(name, dtype):
    """reduce_rows/reduce_cols/spmv/spmv_t/to_dense/total on a canonical
    segment (sorted=True and False) and a raw one with a dirty tail
    (sorted=False), with keys below 0 and past the view; one segment and a
    stacked batch of three (against ``jax.vmap``).  Exact for int32 values,
    rtol 1e-4 for float32 (sums in another order)."""
    t, j = tsr.get(name), jsr.get(name)
    canon, raw = _segments(name, dtype)
    rng = np.random.default_rng(8)
    x_rows = rng.integers(-5, 5, 8).astype(np.float32)
    x_cols = rng.integers(-5, 5, 10).astype(np.float32)
    (jxr, jxc), (txr, txc) = tp.both(x_rows, x_cols)
    for (tseg, jseg), srts in ((canon, (True, False)), (raw, (False,))):
        for srt in srts:
            got = _reductions(tassoc, tseg, txr, txc, t, srt)
            want = _reductions(jassoc, jseg, jxr, jxc, j, srt)
            for k in got:
                tp.assert_vals(got[k].numpy(), np.asarray(want[k]),
                               exact=False, what=f"{k} sorted={srt}")
            tb = tassoc.AssocSegment(*(torch.stack([x] * 3) for x in (
                tseg.hi, tseg.lo, tseg.val, tseg.nnz)))
            tb = dataclasses.replace(
                tb, nnz=torch.tensor([int(tseg.nnz), 0, 5], dtype=torch.int32))
            jb = jassoc.AssocSegment(
                *(jnp.stack([x] * 3) for x in (jseg.hi, jseg.lo, jseg.val)),
                nnz=jnp.asarray(tb.nnz.numpy()))
            got = _reductions(tassoc, tb, txr, txc, t, srt)
            want = jax.vmap(lambda s: _reductions(jassoc, s, jxr, jxc, j,
                                                  srt))(jb)
            for k in got:
                tp.assert_vals(got[k].numpy(), np.asarray(want[k]),
                               exact=False, what=f"batched {k} sorted={srt}")
    tlo, tval, tm = tassoc.extract_row(canon[0], 3)
    jlo, jval, jm = jassoc.extract_row(canon[1], 3)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tlo.numpy()[tm.numpy()],
                                  np.asarray(jlo)[np.asarray(jm)])


def _sentinel_block(seed, n, share, np_dtype):
    """Raw COO of ``n`` slots, ``share`` of them masked to the SENTINEL key
    and the semiring zero; whole-number values in [-8, 8] and few keys, so
    every run's sum stays exact in bfloat16."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(-3, 6, n).astype(np.int32)
    cols = rng.integers(-4, 4, n).astype(np.int32)
    cols[::7] = rng.integers(-2**31, 2**31 - 1, len(cols[::7]))
    vals = rng.integers(-8, 9, n).astype(np_dtype)
    dead = rng.permutation(n)[:round(share * n)]
    mask = np.ones(n, bool)
    mask[dead] = False
    return rows, cols, vals, mask


_VAL_DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
               "bfloat16": (np.float32, torch.bfloat16, jnp.bfloat16),
               "int32": (np.int32, torch.int32, jnp.int32)}


def _assert_sort_route_equal(tseg, tovf, jseg, jovf, what):
    for f in ("hi", "lo", "nnz"):
        np.testing.assert_array_equal(getattr(tseg, f).numpy(),
                                      np.asarray(getattr(jseg, f)),
                                      err_msg=f"{what} {f}")
    if tseg.val.dtype == torch.bfloat16:
        assert jseg.val.dtype == jnp.bfloat16, what
        got = tseg.val.float().numpy()
        want = np.asarray(jseg.val.astype(jnp.float32))
    else:
        got, want = tseg.val.numpy(), np.asarray(jseg.val)
    tp.assert_vals(got, want, exact=True, what=f"{what} val")
    assert int(tovf) == int(jovf), what


@pytest.mark.parametrize("case", ["share0", "share60", "share100", "n1"])
@pytest.mark.parametrize("dtype", sorted(_VAL_DTYPES))
@pytest.mark.parametrize("name", SRS)
def test_sort_route_matches_at_sentinel_shares(name, dtype, case):
    """``from_coo`` and ``merge_many``'s sort route (``_canonicalize``,
    each sentinel slot on its own segment id) against the reference: keys,
    values, nnz and overflow exact, with no, ~60 % and only sentinel
    slots, and a single slot; ``out_capacity`` below, at and above the
    width (the overflow and pad paths)."""
    t, j = tsr.get(name), jsr.get(name)
    np_dtype, t_dtype, j_dtype = _VAL_DTYPES[dtype]
    n, share = (1, 0.0) if case == "n1" else (120, int(case[5:]) / 100)

    def both_masked(seed, width):
        rows, cols, vals, mask = _sentinel_block(seed, width, share, np_dtype)
        jr, jc, jv = jassoc.mask_coo(
            jnp.asarray(rows), jnp.asarray(cols),
            jnp.asarray(vals).astype(j_dtype), jnp.asarray(mask), j)
        tr, tc, tv = tassoc.mask_coo(
            torch.from_numpy(rows), torch.from_numpy(cols),
            torch.from_numpy(vals).to(t_dtype), torch.from_numpy(mask), t)
        return (jr, jc, jv), (tr, tc, tv)

    (jr, jc, jv), (tr, tc, tv) = both_masked(11, n)
    for cap in (n // 2, n, n + 16):
        tseg, tovf = tassoc.from_coo(tr, tc, tv, cap, t)
        jseg, jovf = jassoc.from_coo(jr, jc, jv, cap, j)
        _assert_sort_route_equal(tseg, tovf, jseg, jovf, f"from_coo {cap}")
    if share == 0.0 and n > 1:
        assert int(tseg.nnz) > 0
    segs_t, segs_j = [], []
    for seed, cap in ((12, n), (13, 2 * n)):
        (sjr, sjc, sjv), (str_, stc, stv) = both_masked(seed, cap)
        segs_j.append(jassoc.from_coo(sjr, sjc, sjv, cap, j)[0])
        segs_t.append(tassoc.from_coo(str_, stc, stv, cap, t)[0])
    width = 4 * n
    for cap in (width // 2, width, width + 16):
        tseg, tovf = tassoc.merge_many(segs_t, tr, tc, tv, out_capacity=cap,
                                       sr=t, use_kernel=False)
        jseg, jovf = jassoc.merge_many(segs_j, jr, jc, jv, out_capacity=cap,
                                       sr=j)
        _assert_sort_route_equal(tseg, tovf, jseg, jovf, f"merge_many {cap}")


def test_sort_route_sentinel_slots_take_their_own_ids():
    """On a sorted input with a sentinel tail, the ids ``_canonicalize``
    hands the segment sum keep each live run's index, and give every
    sentinel slot an id in [live runs, n) that no other slot has."""
    seen = []

    class Recording(tsr.Semiring):
        def segment_add(self, vals, segment_ids, num_segments):
            seen.append(segment_ids.clone())
            return super().segment_add(vals, segment_ids, num_segments)

    t = tsr.PLUS_TIMES
    sr = Recording(*(getattr(t, f.name) for f in dataclasses.fields(t)))
    rows, cols, vals, _ = _block(9, 64, 4, np.float32)
    seg, _ = tassoc.from_coo(torch.from_numpy(rows), torch.from_numpy(cols),
                             torch.from_numpy(vals), 100, t)
    live = int(seg.nnz)
    assert 0 < live < 64 and int(seg.hi[live]) == tassoc.SENTINEL
    dup = torch.arange(100) % 3 == 0             # repeat a third of the slots
    hi = torch.cat([seg.hi[:live], seg.hi[:live][dup[:live]], seg.hi[live:]])
    lo = torch.cat([seg.lo[:live], seg.lo[:live][dup[:live]], seg.lo[live:]])
    val = torch.cat([seg.val[:live], seg.val[:live][dup[:live]],
                     seg.val[live:]])
    order = torch.sort(tassoc.pack_key(hi, lo), stable=True).indices
    hi, lo, val = hi[order], lo[order], val[order]
    out, _ = tassoc._canonicalize(hi, lo, val, hi.shape[0], sr)
    (ids,) = seen
    n = hi.shape[0]
    valid = hi != tassoc.SENTINEL
    n_live = int(valid.sum())
    assert n_live > live and n - n_live == 100 - live
    run = torch.cumsum(torch.cat([torch.ones(1, dtype=torch.bool),
                                  (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])]),
                       0) - 1
    assert torch.equal(ids[valid], run[valid])
    assert int(ids[valid].max()) == live - 1
    sent = ids[~valid]
    assert len(set(sent.tolist())) == len(sent)
    assert not set(sent.tolist()) & set(ids[valid].tolist())
    assert int(sent.min()) >= live and int(sent.max()) < n
    tp.assert_vals(out.val.numpy()[:live], seg.val.numpy()[:live]
                   + np.where(dup[:live].numpy(), seg.val.numpy()[:live], 0),
                   exact=True)
    assert int(out.nnz) == live
