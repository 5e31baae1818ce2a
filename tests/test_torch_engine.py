"""Port parity: ``repro_torch.query.engine`` against ``repro.query.engine``.

Point lookups (``l0_mode`` auto, scan and canon; the multi-way merge kernel
on and off) on lazy, unflushed states carried over from the JAX package,
equal to the JAX engine's answers and to lookups after ``flush``; and the
full-run case (nnz == C, power-of-two C) where an unguarded binary search
overshoots to C + 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hier as jhier
from repro.query import engine as jengine
from repro_torch.core import hier as thier
from repro_torch.query import engine as tengine

import torch_parity as tp

CUTS = (64, 256)
BLOCK = 32
_JAX = {}


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def _state(sr_name):
    """An unflushed JAX state: lazy layer 0 under plus.times (the main
    path), canonical layer 0 under max.plus."""
    if sr_name not in _JAX:
        rows, cols, vals = tp.stream(31, (11, BLOCK), 60)
        h = jhier.create(CUTS, BLOCK)
        for t in range(11):
            h = jhier.update(h, *map(jnp.asarray, (rows[t], cols[t], vals[t])),
                             sr=jhier.sr_mod.get(sr_name),
                             lazy_l0=sr_name == "plus.times")
        _JAX[sr_name] = h
    return _JAX[sr_name]


def _queries(n):
    rows, cols, _ = tp.stream(31, (11, BLOCK), 60)
    rng = np.random.default_rng(32)
    qr = np.concatenate([rows.ravel()[-n // 2:],
                         rng.integers(0, 70, n - n // 2)]).astype(np.int32)
    qc = np.concatenate([cols.ravel()[-n // 2:],
                         rng.integers(0, 70, n - n // 2)]).astype(np.int32)
    return qr, qc


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("l0_mode", ["auto", "scan", "canon"])
@pytest.mark.parametrize("q", [8, 200])
@pytest.mark.parametrize("sr_name", ["plus.times", "max.plus"])
def test_point_lookup_matches(sr_name, q, l0_mode, use_kernel):
    jh = _state(sr_name)
    assert int(jh.layers[0].nnz) > 0 and int(jh.spills[0]) > 0
    th = tp.to_torch(jh)
    qr, qc = _queries(q)
    sr = jhier.sr_mod.get(sr_name)
    want = jengine.point_lookup(jh, jnp.asarray(qr), jnp.asarray(qc), sr=sr,
                                l0_mode=l0_mode)
    got = tengine.point_lookup(th, torch.from_numpy(qr), torch.from_numpy(qc),
                               sr=sr_name, use_kernel=use_kernel,
                               l0_mode=l0_mode)
    tp.assert_vals(got.numpy(), np.asarray(want), exact=True)
    flushed = thier.flush(th, sr=sr_name, lazy_l0=sr_name == "plus.times")
    after = tengine.point_lookup(flushed, torch.from_numpy(qr),
                                 torch.from_numpy(qc), sr=sr_name)
    tp.assert_vals(got.numpy(), after.numpy(), exact=True)


def test_scalar_lookup_returns_scalar():
    th = tp.to_torch(_state("plus.times"))
    qr, qc = _queries(4)
    out = thier.lookup(th, int(qr[0]), int(qc[0]))
    assert out.dim() == 0
    assert float(out) == float(tengine.point_lookup(th, qr[:1], qc[:1])[0])


def test_full_run_no_overshoot():
    """A canonical run with nnz == C (C a power of two): a query above every
    key must land at C, not C + 1, in both packages, and point lookups on a
    hierarchy holding such a run agree."""
    cuts, block = (32, 192), 32                   # C0 = 64, C1 = 256
    h = jhier.create(cuts, block)
    d = tp.jax_state_to_numpy(h)
    keys = np.sort(np.random.default_rng(4).choice(10**5, 256,
                                                   replace=False))
    d["layers[1].hi"] = (keys // 300).astype(np.int32)
    d["layers[1].lo"] = (keys % 300).astype(np.int32)
    d["layers[1].val"] = np.arange(1, 257, dtype=np.float32)
    d["layers[1].nnz"] = np.asarray(256, np.int32)
    d["n_updates"] = np.asarray(256, np.uint32)
    th = thier.state_from_numpy(d, device="cpu")
    seg = th.layers[1]
    q_hi = torch.tensor([2**30, int(seg.hi[-1]), 0, int(seg.hi[10])],
                        dtype=torch.int32)
    q_lo = torch.tensor([0, int(seg.lo[-1]) + 1, -5, int(seg.lo[10])],
                        dtype=torch.int32)
    got = tengine.searchsorted_pair(seg.hi, seg.lo, q_hi, q_lo)
    want = jengine.searchsorted_pair(jnp.asarray(d["layers[1].hi"]),
                                     jnp.asarray(d["layers[1].lo"]),
                                     jnp.asarray(q_hi.numpy()),
                                     jnp.asarray(q_lo.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [256, 256, 0, 10]
    for mode in ("scan", "canon"):
        tp.assert_vals(
            tengine.point_lookup(th, q_hi, q_lo, l0_mode=mode).numpy(),
            np.asarray([0.0, 0.0, 0.0, 11.0], np.float32), exact=True)
