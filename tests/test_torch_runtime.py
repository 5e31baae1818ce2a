"""Port parity: ``repro_torch.runtime`` (elastic fleet resize, straggler
monitor) and ``core.distributed.instance_assignment`` against the JAX
package.

``rebalance_instances`` shrinks and grows the same numpy-built fleet in
both packages, with lazy layer-0 buffers holding duplicates and counters
whose fold carries past 2**32: equal leaf for leaf (integer payloads, so
exactly), the per-key totals of every surviving instance's merge kept.
The rendezvous hash is bit-equal to the reference's, and the straggler
monitor flags and evicts as in the reference's test.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.core import stream as jstream
from repro.runtime.elastic import rebalance_instances as jrebalance
from repro_torch.core import assoc as tassoc
from repro_torch.core import distributed as tdist
from repro_torch.core import hier as thier
from repro_torch.core import stream as tstream
from repro_torch.runtime import (StragglerEvicted, StragglerMonitor,
                                 rebalance_instances)

import torch_parity as tp

CUTS = (16, 64)
BLOCK = 8
I = 4


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def _fleet(lazy: bool, counter_base: int = 0):
    """A JAX fleet of I instances over a numpy stream (lazy runs draw
    from fewer keys, so the append buffer holds duplicates), its counters
    offset so a fold crosses 2**32 when ``counter_base`` is near it."""
    rows, cols, vals = tp.stream(7, (I, 6, BLOCK), 30 if lazy else 100)
    states, _ = jstream.ingest_instances(
        jdist.create_instances(I, CUTS, BLOCK),
        *map(jnp.asarray, (rows, cols, vals)), lazy_l0=lazy)
    if counter_base:
        n = np.asarray(states.n_updates, np.int64) + counter_base
        states = states.__class__(
            layers=states.layers, spills=states.spills,
            overflow=states.overflow,
            n_updates=jnp.asarray((n & 0xFFFFFFFF).astype(np.uint32)),
            n_updates_hi=jnp.asarray((n >> 32).astype(np.int32)),
            cuts=states.cuts)
    return states


def _key_totals(states, n):
    """Per instance, {(row, col): total} of its ``query_all``."""
    out = []
    for i in range(n):
        m = thier.query_all(tstream.instance(states, i), lazy_l0=True)
        k = int(m.nnz)
        out.append(dict(zip(zip(m.hi[:k].tolist(), m.lo[:k].tolist()),
                            m.val[:k].tolist())))
    return out


@pytest.mark.parametrize("counter_base", [0, 2**32 - 100])
@pytest.mark.parametrize("lazy", [True, False])
@pytest.mark.parametrize("n_new", [1, 2, 3, 4, 6])
def test_rebalance_matches_reference(n_new, lazy, counter_base):
    """Shrink (fold the surplus into i % n_new through the deepest layer)
    and grow (cold instances appended): equal to the reference's result
    leaf for leaf; the counters add as int64 and equal the reference's
    carried words; every key's total survives in its new home."""
    js = _fleet(lazy, counter_base)
    ts = tp.to_torch(js)
    got = rebalance_instances(ts, n_new)
    tp.assert_states_equal(got, jrebalance(js, n_new))
    assert got.layers[0].hi.shape[0] == n_new
    assert thier.exact_update_count(got) == thier.exact_update_count(ts)
    assert int(got.overflow.sum()) == 0
    # the input fleet is untouched
    tp.assert_states_equal(ts, js)
    before, after = _key_totals(ts, I), _key_totals(got, n_new)
    want = [dict() for _ in range(n_new)]
    for i, kv in enumerate(before):
        for key, v in kv.items():
            want[i % n_new][key] = want[i % n_new].get(key, 0.0) + v
    assert after == want


def test_rebalance_grow_and_shrink_keep_the_device_and_mass():
    """The reference's mass test on the port: ``assoc.total`` of every
    instance's merge, summed, is unchanged by a shrink to 2 and a grow to
    6; the result lives on the fleet's device."""
    ts = tp.to_torch(_fleet(False))

    def mass(s, n):
        return sum(float(tassoc.total(thier.query_all(
            tstream.instance(s, i)))) for i in range(n))
    before = mass(ts, I)
    for n in (2, 6):
        out = rebalance_instances(ts, n)
        assert out.device == ts.device
        assert mass(out, n) == before
    assert rebalance_instances(ts, I) is ts


@pytest.mark.parametrize("n,d", [(1000, 16), (1000, 17), (37, 5), (64, 1)])
def test_instance_assignment_bit_equal_to_reference(n, d):
    got = tdist.instance_assignment(n, d)
    want = np.asarray(jdist.instance_assignment(n, d))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_instance_assignment_consistent_hash_stability():
    a16 = tdist.instance_assignment(1000, 16).numpy()
    a17 = tdist.instance_assignment(1000, 17).numpy()
    # rendezvous hashing: growing 16 -> 17 devices moves ~1/17 of instances
    assert (a16 != a17).mean() < 0.15
    assert set(a16) <= set(range(16))


def test_straggler_monitor_flags_and_evicts():
    mon = StragglerMonitor(threshold=5.0, evict_after=2, warmup_steps=0)
    for _ in range(3):
        mon.start()
        time.sleep(0.005)
        mon.stop()
    with pytest.raises(StragglerEvicted):
        for _ in range(3):
            mon.start()
            time.sleep(0.1)
            mon.stop()
    assert mon.flagged >= 2


def test_straggler_monitor_warmup_and_ema():
    """Warm-up steps are ignored, the first timed step seeds the EMA, and
    a normal step resets the consecutive count."""
    mon = StragglerMonitor(threshold=1e9, warmup_steps=2)
    for _ in range(2):
        mon.start()
        assert mon.stop() is False
    assert mon.ema_s is None
    mon.start()
    mon.stop()
    assert mon.ema_s is not None and mon.steps == 3
    mon.start()
    assert mon.stop() is False and mon.consecutive == 0
