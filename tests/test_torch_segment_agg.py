"""Port parity: the segment_agg kernel's plain PyTorch version against the
JAX Pallas kernel (interpret mode) on the registry job, and the port's
``ops.segment_sum`` against the JAX package's — unsorted ids, ids below 0
and at or above ``num_segments``, ``assume_sorted``, segment counts that
are not a multiple of the 128-node tile, and empty tiles.

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
from repro.kernels.segment_agg import ops as jops
from repro_torch.kernels import registry as treg
from repro_torch.kernels.segment_agg import ops as tops
from repro_torch.kernels.segment_agg import segment_agg as tsa

RTOL = 2e-5   # the registry's segment_agg rtol


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


_JOB = "segment_agg.segment_sum_pallas/t2.d128"


def _jobs():
    j = {x.name: x for x in jreg.jobs()}[_JOB]
    t = {x.name: x for x in treg.jobs()}[_JOB.replace("_pallas", "_cuda")]
    return j, t


def test_input_maker_bit_for_bit():
    j, t = _jobs()
    for x, y in zip(j.make_inputs(5), t.make_inputs(5)):
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
    assert got.shape == want.shape == (256, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(t.oracle(*targs).numpy(), want, rtol=RTOL,
                               atol=RTOL)


def test_plain_sums_each_node_in_edge_order():
    """The plain version adds a node's rows in edge order from 0.0 — the
    CUDA kernel's order — so it equals a sequential numpy loop bit for
    bit."""
    _, t = _jobs()
    msg, seg, starts = t.make_inputs(1)
    want = np.zeros((256, msg.shape[1]), np.float32)
    for e in range(starts[0], starts[-1]):
        want[seg[e]] = want[seg[e]] + msg[e]
    got = t.plain(*(torch.from_numpy(a) for a in (msg, seg, starts)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_refuses_other_devices():
    msg = torch.zeros((256, 4), device="meta")
    seg = torch.zeros((256,), dtype=torch.int32, device="meta")
    starts = torch.zeros((3,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsa.segment_sum_cuda(msg, seg, starts, 2)


def _edges(seed, e, d, lo, hi, sort=False):
    rng = np.random.default_rng(seed)
    seg = rng.integers(lo, hi, e).astype(np.int32)
    if sort:
        seg = np.sort(seg)
    return rng.normal(size=(e, d)).astype(np.float32), seg


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("e,d,num_segments,lo,hi,sort", [
    (500, 16, 300, -20, 340, False),     # unsorted; ids < 0 and >= N
    (200, 8, 1000, 0, 1000, False),      # 8 tiles, some empty
    (64, 12, 700, 500, 650, False),      # edges only in the last tiles
    (300, 32, 256, 0, 256, True),        # assume_sorted
    (0, 4, 130, 0, 130, False),          # no edges at all
])
def test_ops_segment_sum_matches_reference(use_kernel, e, d, num_segments,
                                           lo, hi, sort):
    msg, seg = _edges(e + d, e, d, lo, hi, sort)
    want = jops.segment_sum(jnp.asarray(msg), jnp.asarray(seg),
                            num_segments=num_segments, use_kernel=False)
    got = tops.segment_sum(torch.from_numpy(msg), torch.from_numpy(seg),
                           num_segments=num_segments, use_kernel=use_kernel,
                           assume_sorted=sort)
    assert got.dtype == torch.float32
    assert got.shape == (num_segments, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=RTOL)


@pytest.mark.parametrize("assume_sorted", [False, True])
def test_ops_segment_sum_against_pallas_interpret(assume_sorted):
    """One staged call through the JAX Pallas kernel itself (interpret),
    with 300 segments (3 tiles) and ids out of range: on both sides
    unsorted; sorted, only above (an id below 0 would break the order once
    it is clipped to ``num_segments``)."""
    lo = 0 if assume_sorted else -10
    msg, seg = _edges(9, 400, 16, lo, 320, sort=assume_sorted)
    want = jops.segment_sum(jnp.asarray(msg), jnp.asarray(seg),
                            num_segments=300, use_kernel=True,
                            interpret=True, assume_sorted=assume_sorted)
    got = tops.segment_sum(torch.from_numpy(msg), torch.from_numpy(seg),
                           num_segments=300, assume_sorted=assume_sorted)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=RTOL)


def test_stage_is_stable_and_padded_like_the_reference():
    """The staged operands: a stable sort (ties keep edge order, as JAX's
    argsort), E padded to ceil(E/KB)*KB + KB with id T*TN, and the
    searchsorted tile starts."""
    msg, seg = _edges(4, 260, 4, -5, 140)
    m, s, starts, t = tops.stage(torch.from_numpy(msg),
                                 torch.from_numpy(seg), num_segments=130)
    clip = np.where((seg >= 0) & (seg < 130), seg, 130)
    order = np.asarray(jnp.argsort(jnp.asarray(clip)))
    assert t == 2 and s.shape == (512,) and m.shape == (512, 4)
    np.testing.assert_array_equal(s[:260].numpy(), clip[order])
    np.testing.assert_array_equal(m[:260].numpy(), msg[order])
    assert bool((s[260:] == 256).all()) and bool((m[260:] == 0).all())
    np.testing.assert_array_equal(
        starts.numpy(), np.searchsorted(s.numpy(), [0, 128, 256]))
