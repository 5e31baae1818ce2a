"""Port parity: ``repro_torch.core.hier`` against ``repro.core.hier``.

``update`` fused (``switch``, ``branchfree``) and layered, lazy layer 0 on
and off, the merge kernels on and off (their plain versions on the CPU),
on spill-heavy and masked integer-valued streams: every layer, spill,
overflow and counter exactly equal to the JAX package's after each block.
Also ``query_all`` and ``flush`` (fused and layered), the masked block
wider than the creation block size (the append fit check), the
numpy state converter and the counter's word view.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hier as jhier
from repro_torch.core import hier as thier

import torch_parity as tp

CUTS = (64, 256)
BLOCK = 32
STEPS = 12
_JAX = {}     # (mode, lazy, masked) -> JAX states after each block


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def _stream(masked: bool, block: int = BLOCK):
    rows, cols, vals = tp.stream(11, (STEPS, block), 300)
    mask = np.random.default_rng(12).random((STEPS, block)) < 0.6 \
        if masked else None
    return rows, cols, vals, mask


def _knobs(mode, lazy):
    return dict(lazy_l0=lazy, fused=mode != "layered",
                batch_mode="switch" if mode == "layered" else mode)


def _jax_run(mode, lazy, masked):
    key = (mode, lazy, masked)
    if key not in _JAX:
        rows, cols, vals, mask = _stream(masked)
        h = jhier.create(CUTS, BLOCK)
        out = []
        for t in range(STEPS):
            h = jhier.update(h, jnp.asarray(rows[t]), jnp.asarray(cols[t]),
                             jnp.asarray(vals[t]),
                             None if mask is None else jnp.asarray(mask[t]),
                             **_knobs("switch" if mode != "layered"
                                      else mode, lazy))
            out.append(h)
        _JAX[key] = out
    return _JAX[key]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("mode", ["switch", "branchfree", "layered"])
def test_update_matches_reference(mode, lazy, use_kernel, masked):
    rows, cols, vals, mask = _stream(masked)
    want = _jax_run(mode, lazy, masked)
    h = thier.create(CUTS, BLOCK, device="cpu")
    for t in range(STEPS):
        h = thier.update(h, torch.from_numpy(rows[t]),
                         torch.from_numpy(cols[t]), torch.from_numpy(vals[t]),
                         None if mask is None else torch.from_numpy(mask[t]),
                         use_kernel=use_kernel, **_knobs(mode, lazy))
        tp.assert_states_equal(h, want[t])
    assert int(h.spills[0]) >= 2                   # spill-heavy


@pytest.mark.parametrize("mode", ["switch", "branchfree"])
def test_wide_masked_block_fit_check(mode):
    """A masked block wider than the creation block size can reach past
    layer 0's capacity on the append path: the fit check must send it to
    the merge exactly as the reference does."""
    rows, cols, vals, mask = _stream(True, block=48)
    jh = jhier.create(CUTS, 16)
    th = thier.create(CUTS, 16, device="cpu")
    for t in range(STEPS):
        jh = jhier.update(jh, *map(jnp.asarray, (rows[t], cols[t], vals[t],
                                                 mask[t])),
                          lazy_l0=True, batch_mode=mode)
        th = thier.update(th, *map(torch.from_numpy, (rows[t], cols[t],
                                                      vals[t], mask[t])),
                          lazy_l0=True, batch_mode=mode)
        tp.assert_states_equal(th, jh)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("lazy", [False, True])
def test_query_all_and_flush_match(lazy, use_kernel):
    jstates = _jax_run("switch", lazy, False)
    for jh in (jstates[4], jstates[-1]):
        th = tp.to_torch(jh)
        for fused in (True, False):
            want = jhier.query_all(jh, lazy_l0=lazy, fused=fused)
            got = thier.query_all(th, lazy_l0=lazy, fused=fused,
                                  use_kernel=use_kernel)
            tp.assert_segment_equal(got, want)
            want_f = jhier.flush(jh, lazy_l0=lazy, fused=fused)
            got_f = thier.flush(th, lazy_l0=lazy, fused=fused,
                                use_kernel=use_kernel)
            tp.assert_states_equal(got_f, want_f)


def test_state_converter_round_trip():
    jh = _jax_run("switch", True, False)[-1]
    d = tp.jax_state_to_numpy(jh)
    th = thier.state_from_numpy(d, device="cpu")
    back = thier.state_to_numpy(th)
    assert back.keys() == d.keys()
    for k in d:
        if k == "cuts":
            assert back[k] == d[k]
        else:
            assert back[k].dtype == d[k].dtype, k
            np.testing.assert_array_equal(back[k], d[k], err_msg=k)
    again = thier.state_from_numpy(back, device="cpu")
    tp.assert_states_equal(again, jh)


def test_counter_words_view():
    h = thier.create(CUTS, BLOCK, device="cpu")
    h = thier.HierAssoc(layers=h.layers, spills=h.spills,
                        overflow=h.overflow,
                        n_updates=torch.tensor(3 * 2**32 + 7), cuts=h.cuts)
    lo, hi = thier.counter_words(h)
    assert int(lo) == 7 and int(hi) == 3
    assert thier.exact_update_count(h) == 3 * 2**32 + 7
    d = thier.state_to_numpy(h)
    assert d["n_updates"].dtype == np.uint32 and int(d["n_updates"]) == 7
    assert d["n_updates_hi"].dtype == np.int32 and int(d["n_updates_hi"]) == 3


def test_invalid_config_messages_match():
    h = thier.create(CUTS, BLOCK, device="cpu")
    r = torch.zeros(BLOCK, dtype=torch.int32)
    with pytest.raises(ValueError, match="invalid d4m config signature: "
                       "lazy_l0 requires the plus.times semiring"):
        thier.update(h, r, r, torch.ones(BLOCK), sr="max.plus", lazy_l0=True)
    with pytest.raises(ValueError, match="invalid d4m config signature: "
                       "batch_mode must be one of"):
        thier.update(h, r, r, torch.ones(BLOCK), batch_mode="grouped")
    with pytest.raises(ValueError, match="strictly increasing"):
        thier.create((64, 64), BLOCK, device="cpu")
