"""Port parity: ``repro_torch.core.stream`` against ``repro.core.stream``.

``ingest_instances`` in all four batch modes on a desynchronized fleet
(instances pre-warmed to different occupancies, so one step plans depths
0, 1 and 2 at once), built by carrying a JAX fleet state through the numpy
converter: states and [I, T, ...] telemetry exactly equal to the JAX
package's grouped run.  Also the update counter past 2**31, 2**32 and
2**33, chunked telemetry, the single-instance ``ingest`` and one run
against the JAX package's own Pallas-kernel path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hier as jhier
from repro.core import stream as jstream
from repro_torch.core import hier as thier
from repro_torch.core import stream as tstream

import torch_parity as tp

CUTS = (64, 256, 1024)
BLOCK = 32
WARM = (0, 2, 8, 13)         # pre-warm blocks: next depths 0, 1, 2, 0
STEPS = 12
_JAX = {}


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def _fleet():
    """A desynchronized JAX fleet: instance i holds WARM[i] unique blocks."""
    if "fleet" not in _JAX:
        hs = []
        for n in WARM:
            h = jhier.create(CUTS, BLOCK)
            for t in range(n):
                keys = jnp.arange(t * BLOCK, (t + 1) * BLOCK, dtype=jnp.int32)
                h = jhier.update(h, keys, keys, jnp.ones(BLOCK), lazy_l0=True)
            hs.append(h)
        _JAX["fleet"] = jax.tree.map(lambda *xs: jnp.stack(xs), *hs)
    return _JAX["fleet"]


def _jax_ingest(lazy, chunk=1, use_kernel=False):
    key = (lazy, chunk, use_kernel)
    if key not in _JAX:
        rows, cols, vals = tp.stream(21, (len(WARM), STEPS, BLOCK), 200)
        _JAX[key] = jstream.ingest_instances(
            _fleet(), jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
            lazy_l0=lazy, chunk=chunk, use_kernel=use_kernel,
            batch_mode="grouped")
    return _JAX[key]


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("mode", ["grouped", "bucketed", "branchfree",
                                  "switch"])
def test_desynchronized_fleet_all_modes(mode, lazy, use_kernel):
    fleet = tp.to_torch(_fleet())
    depths = thier._plan_spill_depth(fleet, BLOCK)
    assert len(set(depths.tolist())) == 3          # depths 0, 1, 2 at once
    rows, cols, vals = tp.stream(21, (len(WARM), STEPS, BLOCK), 200)
    want, want_tel = _jax_ingest(lazy)
    got, tel = tstream.ingest_instances(
        fleet, *map(torch.from_numpy, (rows, cols, vals)), lazy_l0=lazy,
        use_kernel=use_kernel, batch_mode=mode)
    tp.assert_states_equal(got, want)
    tp.assert_telemetry_equal(tel, want_tel)
    assert int(got.spills[:, 1].sum()) > 0          # depth-2 merges ran
    # the caller's state is untouched
    tp.assert_states_equal(fleet, _fleet())


def test_grouped_matches_reference_kernel_path():
    """One run against the JAX package's Pallas kernels (interpret mode)."""
    rows, cols, vals = tp.stream(21, (len(WARM), STEPS, BLOCK), 200)
    want, want_tel = _jax_ingest(True, use_kernel=True)
    got, tel = tstream.ingest_instances(
        tp.to_torch(_fleet()), *map(torch.from_numpy, (rows, cols, vals)),
        lazy_l0=True, use_kernel=True)
    tp.assert_states_equal(got, want)
    tp.assert_telemetry_equal(tel, want_tel)


@pytest.mark.parametrize("mode", ["grouped", "switch"])
def test_chunked_telemetry(mode):
    rows, cols, vals = tp.stream(21, (len(WARM), STEPS, BLOCK), 200)
    want, want_tel = _jax_ingest(True, chunk=2)
    got, tel = tstream.ingest_instances(
        tp.to_torch(_fleet()), *map(torch.from_numpy, (rows, cols, vals)),
        lazy_l0=True, chunk=2, batch_mode=mode)
    tp.assert_states_equal(got, want)
    assert tel["nnz0"].shape == (len(WARM), STEPS)
    assert tel["per_update"]["nnz0"].shape == (len(WARM), STEPS // 2)
    tp.assert_telemetry_equal(tel, want_tel)


@pytest.mark.parametrize("start", [2**31 - 40, 2**32 - 40, 2**33 - 40])
def test_counter_past_word_boundaries(start):
    """The int64 counter stays exact across 2**31, 2**32 and 2**33, and its
    (lo, hi) words equal the JAX package's carry-pair words."""
    rows, cols, vals = tp.stream(3, (2, 4, BLOCK), 50)
    j = _fleet()
    j = jax.tree.map(lambda x: x[:2], j)
    j = jhier.HierAssoc(layers=j.layers, spills=j.spills, overflow=j.overflow,
                        n_updates=jnp.full((2,), start % 2**32, jnp.uint32),
                        n_updates_hi=jnp.full((2,), start >> 32, jnp.int32),
                        cuts=j.cuts)
    want, _ = jstream.ingest_instances(j, *map(jnp.asarray,
                                               (rows, cols, vals)),
                                       lazy_l0=True)
    got, _ = tstream.ingest_instances(tp.to_torch(j),
                                      *map(torch.from_numpy,
                                           (rows, cols, vals)), lazy_l0=True)
    tp.assert_states_equal(got, want)
    assert thier.exact_update_count(got) == 2 * (start + 4 * BLOCK)
    assert thier.exact_update_count(got) == jhier.exact_update_count(want)


def test_single_instance_ingest_and_masked_update_instances():
    rows, cols, vals = tp.stream(4, (STEPS, BLOCK), 150)
    want, want_tel = jstream.ingest(jhier.create(CUTS, BLOCK),
                                    *map(jnp.asarray, (rows, cols, vals)),
                                    lazy_l0=True)
    got, tel = tstream.ingest(thier.create(CUTS, BLOCK, device="cpu"),
                              *map(torch.from_numpy, (rows, cols, vals)),
                              lazy_l0=True)
    tp.assert_states_equal(got, want)
    tp.assert_telemetry_equal(tel, want_tel)
    # one masked batched step on the desynchronized fleet
    j = _fleet()
    r, c, v = (x[:, 0] for x in tp.stream(6, (len(WARM), 1, BLOCK), 150))
    mask = np.random.default_rng(5).random((len(WARM), BLOCK)) < .5
    want = jstream.update_instances(j, *map(jnp.asarray, (r, c, v)),
                                    lazy_l0=True, mask=jnp.asarray(mask))
    got = tstream.update_instances(tp.to_torch(j),
                                   *map(torch.from_numpy, (r, c, v)),
                                   lazy_l0=True, mask=torch.from_numpy(mask))
    tp.assert_states_equal(got, want)
