"""Port parity: the embedding_bag kernel's plain PyTorch version against the
JAX Pallas kernel (interpret mode) on the registry job, and the port's
``ops.embedding_bag`` against the JAX package's (mask, sum / mean,
out-of-range indices, multi-hot bags).

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
this plain version there); on a CPU tensor the wrapper runs its plain
version and counts no launch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import registry as jreg
from repro.kernels.embedding_bag import ops as jops
from repro_torch.kernels import registry as treg
from repro_torch.kernels.embedding_bag import embedding_bag as teb
from repro_torch.kernels.embedding_bag import ops as tops

RTOL = 2e-5   # the registry's embedding_bag rtol


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


_JOB = "embedding_bag.embedding_bag_pallas/v512.d128"


def _jobs():
    j = {x.name: x for x in jreg.jobs()}[_JOB]
    t = {x.name: x for x in treg.jobs()}[_JOB.replace("_pallas", "_cuda")]
    return j, t


def test_input_maker_bit_for_bit():
    j, t = _jobs()
    for x, y in zip(j.make_inputs(4), t.make_inputs(4)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_plain_matches_pallas_interpret():
    """The registry job through the Pallas kernel (interpret mode) and
    through the port's wrapper on the CPU (its plain version), rtol 2e-5;
    the port's oracle too.  No launch is counted."""
    j, t = _jobs()
    args = j.make_inputs(0)
    want = np.asarray(j.fn(*args, interpret=True))
    targs = tuple(torch.from_numpy(a) for a in args)
    treg.reset_launches()
    got = t.fn(*targs)
    assert treg.launches()[t.counter] == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(t.oracle(*targs).numpy(), want, rtol=RTOL,
                               atol=RTOL)
    # the plain version accumulates in the kernel's order: a loop over l
    acc = np.zeros_like(want)
    for l in range(args[1].shape[1]):
        acc = acc + args[2][:, l:l + 1] * args[0][args[1][:, l]]
    np.testing.assert_array_equal(t.plain(*targs).numpy(), acc)


def test_zero_weight_times_inf_stays_nan():
    table = torch.tensor([[1.0, np.inf], [2.0, 3.0]])
    idx = torch.tensor([[0, 1]], dtype=torch.int32)
    w = torch.tensor([[0.0, 1.0]])
    out = teb.embedding_bag_cuda(table, idx, w)
    assert bool(torch.isnan(out[0, 1])) and float(out[0, 0]) == 2.0


def test_wrapper_refuses_other_devices():
    table = torch.zeros((4, 8), device="meta")
    idx = torch.zeros((2, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        teb.embedding_bag_cuda(table, idx, torch.ones((2, 1), device="meta"))


def _case(seed, v=300, d=16, bags=24, bag=3, oob=False):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(np.float32)
    lo, hi = (-50, v + 50) if oob else (0, v)
    idx = rng.integers(lo, hi, (bags, bag)).astype(np.int32)
    w = rng.normal(size=(bags, bag)).astype(np.float32)
    mask = rng.random((bags, bag)) < 0.7
    mask[0] = False                       # an all-padding bag
    return table, idx, w, mask


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("with_mask,with_weights,oob",
                         [(True, True, False), (False, True, True),
                          (True, False, True), (False, False, False)])
def test_ops_matches_reference(combiner, use_kernel, with_mask,
                               with_weights, oob):
    """Masking, clamping of out-of-range indices, default weights and both
    combiners, against the JAX ``ops.embedding_bag`` (its reference path),
    on multi-hot bags (L = 3); rtol 2e-5."""
    table, idx, w, mask = _case(1, oob=oob)
    kw = dict(weights=w if with_weights else None,
              mask=mask if with_mask else None)
    want = jops.embedding_bag(
        jnp.asarray(table), jnp.asarray(idx),
        **{k: None if v is None else jnp.asarray(v) for k, v in kw.items()},
        combiner=combiner, use_kernel=False)
    got = tops.embedding_bag(
        torch.from_numpy(table), torch.from_numpy(idx),
        **{k: None if v is None else torch.from_numpy(v)
           for k, v in kw.items()},
        combiner=combiner, use_kernel=use_kernel)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=RTOL)


def test_ops_multi_hot_against_pallas_interpret():
    """A multi-hot case (L = 3, masked, weighted) through the JAX kernel
    itself: the Pallas kernel sums in the same order as the plain version."""
    table, idx, w, mask = _case(2, bags=8, oob=True)
    want = jops.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                              jnp.asarray(w), jnp.asarray(mask),
                              use_kernel=True, interpret=True)
    got = tops.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                             torch.from_numpy(w), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=RTOL)


def test_unknown_combiner_raises():
    table, idx, w, _ = _case(3)
    with pytest.raises(ValueError, match="unknown combiner"):
        tops.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                           combiner="max")
