"""Port parity: the hier_merge kernels' plain PyTorch versions against the
JAX Pallas kernels (interpret mode) on every runnable registry job, the
port's ``ops.merge`` / ``ops.merge_multi`` against the JAX package's, and
the port's registry input makers against the reference's, bit for bit.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
them against these plain versions there); on a CPU tensor each wrapper runs
its plain version and counts no launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import registry as jreg
from repro.kernels.hier_merge import ops as jops
from repro_torch.kernels import registry as treg
from repro_torch.kernels.hier_merge import hier_merge as thm
from repro_torch.kernels.hier_merge import ops as tops
from repro_torch.kernels.hier_merge import ref as tref

import torch_parity as tp


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def _port_name(ref_name: str) -> str:
    return ref_name.replace("_pallas", "_cuda")


_JAX_JOBS = {j.name: j for j in jreg.jobs() if j.family == "hier_merge"}
_PORT_JOBS = {j.name: j for j in treg.jobs()}
_RUNNABLE = sorted(n for n, j in _JAX_JOBS.items() if not j.audit_only)


def _torch_args(args):
    if isinstance(args[3], list):                  # merge_multi layout
        bh, bl, bv, runs = args
        return (*(torch.from_numpy(x) for x in (bh, bl, bv)),
                [tuple(torch.from_numpy(x) for x in r) for r in runs])
    return tuple(torch.from_numpy(x) for x in args)


def _assert_out(got, want, exact, rtol):
    got = [np.asarray(x) for x in got]
    want = [np.asarray(x) for x in want]
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i], want[i])
    if exact:
        np.testing.assert_array_equal(got[2], want[2])
    else:
        fin = np.isfinite(want[2])
        np.testing.assert_array_equal(got[2][~fin], want[2][~fin])
        np.testing.assert_allclose(got[2][fin], want[2][fin], rtol=rtol,
                                   atol=1e-6)


def test_port_registry_matches_reference_jobs():
    """One port job per reference job, every family (the audit-only n65536
    row runs on the card in the port), and one CUDA source per family."""
    assert sorted(j.name for j in treg.jobs()) == \
        sorted(_port_name(j.name) for j in jreg.jobs())
    assert treg.AUDITED_FILES == ("hier_merge/csrc/hier_merge.cu",
                                  "embedding_bag/csrc/embedding_bag.cu",
                                  "segment_agg/csrc/segment_agg.cu")
    assert {j.counter for j in treg.jobs()} <= set(treg.LAUNCHES)


@pytest.mark.parametrize("name", sorted(_JAX_JOBS))
def test_input_makers_bit_for_bit(name):
    a = _JAX_JOBS[name].make_inputs(3)
    b = _PORT_JOBS[_port_name(name)].make_inputs(3)
    flat = lambda x: [y for v in x for y in (flat(v) if isinstance(
        v, (list, tuple)) else [v])]
    fa, fb = flat(a), flat(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", _RUNNABLE)
def test_plain_matches_pallas_interpret(name):
    """The plain version (what a CPU tensor runs) equals the Pallas kernel
    in interpret mode and the port's sort-based oracle."""
    jjob, tjob = _JAX_JOBS[name], _PORT_JOBS[_port_name(name)]
    args = jjob.make_inputs(0)
    want = jjob.fn(*args, interpret=True)
    targs = _torch_args(args)
    exact = args[2].dtype == np.int32
    got = tjob.fn(*targs)                        # CPU -> plain version
    _assert_out(got, want, exact, tjob.rtol)
    _assert_out(tjob.oracle(*targs), want, exact, tjob.rtol)


def test_wrappers_route_by_device():
    """CPU tensors run the plain version and count no launch; a tensor on
    another device is refused, never silently moved."""
    args = _torch_args(_PORT_JOBS["hier_merge.merge_cuda/n512.plus.times"
                                  ".float32"].make_inputs(0))
    treg.reset_launches()
    got = thm.merge_cuda(*args, sr_name="plus.times")
    _assert_out(got, thm.merge_plain(*args, sr_name="plus.times"), True, 0)
    assert treg.launches()["hier_merge.merge"] == 0
    meta = tuple(x.to("meta") for x in args)
    with pytest.raises(ValueError, match="unsupported device"):
        thm.merge_cuda(*meta)
    with pytest.raises(ValueError, match="unsupported device"):
        thm.merge_multi_cuda(meta[:3], [meta[3:]])


def _seg(seed, n, cap, nkeys, dtype, sr_name):
    rng = np.random.default_rng(seed)
    seg = treg._canonical_segment(rng, 2 * n, nkeys, dtype, sr_name)
    return tuple(np.concatenate([x[:n], x[-1:].repeat(cap - n)])
                 for x in seg)


@pytest.mark.parametrize("sr_name", ["plus.times", "max.plus", "min.plus"])
@pytest.mark.parametrize("caps,out_cap", [((48, 80), 128), ((1000, 24), 1024),
                                          ((100, 100), 64)])
def test_ops_merge_matches(caps, out_cap, sr_name):
    """Padding, the kernel's size rule, truncation and overflow of
    ``ops.merge`` against the JAX package's (its XLA path: the same padding
    and finalize around an independent sort)."""
    a = _seg(1, caps[0] // 2, caps[0], 10**5, np.float32, sr_name)
    b = _seg(2, caps[1] // 2, caps[1], 10**5, np.float32, sr_name)
    want = jops.merge(*map(jnp.asarray, a + b), out_capacity=out_cap,
                      sr_name=sr_name, use_kernel=False)
    for use_kernel in (True, False):
        got = tops.merge(*map(torch.from_numpy, a + b), out_capacity=out_cap,
                         sr_name=sr_name, use_kernel=use_kernel)
        _assert_out(got[:4], want[:4], False, tp.RTOL)
        assert int(got[4]) == int(want[4])


@pytest.mark.parametrize("out_cap", [2048, 300])
def test_ops_merge_multi_matches(out_cap):
    rng = np.random.default_rng(5)
    block = (rng.integers(0, 40, 96).astype(np.int32),
             rng.integers(-40, 40, 96).astype(np.int32),
             rng.normal(size=96).astype(np.float32))
    runs = _seg(6, 200, 400, 10**4, np.float32, "plus.times") \
        + _seg(7, 300, 700, 10**4, np.float32, "plus.times")
    want = jops.merge_multi(*map(jnp.asarray, block + runs),
                            out_capacity=out_cap, use_kernel=False)
    assert tops.multi_padded_capacity(96, (400, 700)) == 2048
    for use_kernel in (True, False):
        got = tops.merge_multi(*map(torch.from_numpy, block + runs),
                               out_capacity=out_cap, use_kernel=use_kernel)
        _assert_out(got[:4], want[:4], False, tp.RTOL)
        assert int(got[4]) == int(want[4])


def test_ops_merge_multi_pallas_interpret_once():
    """One multi-way merge through the JAX Pallas kernel itself."""
    rng = np.random.default_rng(8)
    block = (rng.integers(0, 30, 64).astype(np.int32),
             rng.integers(0, 30, 64).astype(np.int32),
             rng.integers(1, 4, 64).astype(np.float32))
    run = _seg(9, 50, 100, 900, np.float32, "plus.times")
    want = jops.merge_multi(*map(jnp.asarray, block + run), out_capacity=200,
                            use_kernel=True, interpret=True)
    got = tops.merge_multi(*map(torch.from_numpy, block + run),
                           out_capacity=200)
    _assert_out(got[:4], want[:4], True, 0)


def test_zero_for_matches_reference():
    from repro.kernels.hier_merge import ref as jref
    for sr_name in ("plus.times", "max.plus", "min.plus", "max.min"):
        for td, nd in ((torch.float32, np.float32), (torch.int32, np.int32)):
            assert np.asarray(tref._zero_for(sr_name, td), nd) == \
                jref._zero_for(sr_name, np.dtype(nd))
