"""Port parity: the segment_agg kernel's plain PyTorch version against the
JAX Pallas kernel (interpret mode) on the registry job, and the port's
``ops.segment_sum`` against the JAX package's — unsorted ids, ids below 0
and at or above ``num_segments``, ``assume_sorted``, segment counts that
are not a multiple of the 128-node tile, empty tiles and a hub whose run
crosses many chunks; the plain version's order of additions (pieces of a
run per chunk of sorted edges, then the pieces in chunk order) against a
numpy loop, bit for bit, and the new staging (ids only: the order, the
sorted ids, the tile starts).

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


def _chunked_loop(msg, seg, lo, hi, n_out):
    """The kernel's order of additions as a sequential numpy loop: each
    stretch of one node inside one chunk of ``CHUNK`` sorted edges summed
    from 0.0 in edge order, a node's stretches added in chunk order."""
    chunk = tsa.CHUNK
    out = np.zeros((n_out, msg.shape[1]), np.float32)
    seen = set()
    for e in range(lo, hi):
        n = seg[e]
        if e == lo or seg[e - 1] != n or e % chunk == 0:
            piece = np.zeros(msg.shape[1], np.float32)
        piece = piece + msg[e]
        if e + 1 == hi or seg[e + 1] != n or (e + 1) % chunk == 0:
            out[n] = out[n] + piece if n in seen else piece
            seen.add(n)
    return out


def _hub_edges(seed, e, d, n, hub, hub_edges, lo=0, hi=None):
    """Unsorted edges over [lo, hi) (default [0, n)) with ``hub_edges`` of
    them sent to node ``hub``."""
    msg, seg = _edges(seed, e, d, lo, n if hi is None else hi)
    seg[np.random.default_rng(seed + 1).permutation(e)[:hub_edges]] = hub
    return msg, seg


def _hub_sorted():
    """Sorted hub operands: node 37's run spans more than 3 chunks."""
    m, s = _hub_edges(11, 700, 12, 200, 37, 300)
    order = np.argsort(s, kind="stable")
    msg, seg = m[order], s[order]
    starts = np.searchsorted(seg, [0, 128, 256]).astype(np.int32)
    run = np.flatnonzero(seg == 37)
    assert run[-1] // tsa.CHUNK - run[0] // tsa.CHUNK >= 3
    return msg, seg, starts


def _plain_equals_loop(msg, seg, starts):
    n_out = 128 * (starts.shape[0] - 1)
    want = _chunked_loop(msg, seg, starts[0], starts[-1], n_out)
    got = tsa.segment_sum_plain(
        *(torch.from_numpy(a) for a in (msg, seg, starts)),
        starts.shape[0] - 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_sums_each_node_in_edge_order():
    """The plain version adds a node's rows in the kernel's order: each
    piece of its run inside one chunk from 0.0 in edge order, then the
    pieces in chunk order.  It equals that order as a sequential numpy loop
    bit for bit: on the registry job, and on a hub whose run spans more
    than 3 chunks."""
    _, t = _jobs()
    _plain_equals_loop(*t.make_inputs(1))
    _plain_equals_loop(*_hub_sorted())


@pytest.mark.parametrize("runs", [
    (64, 64, 64),            # runs of exactly one chunk
    (64, 192, 0, 64),        # a run starting and ending on chunk boundaries
    (30, 300, 50),           # a run crossing 5 boundaries from mid-chunk
    (10, 5000, 0, 0, 7),     # a 5,000-edge hub, empty nodes after it
    (63, 2, 63),             # a 2-edge run across one boundary
])
def test_plain_runs_at_chunk_boundaries(runs):
    """Node i owns ``runs[i]`` consecutive sorted edges: runs placed on,
    across and between the 64-edge chunk boundaries, summed in the chunked
    order bit for bit."""
    seg = np.repeat(np.arange(len(runs), dtype=np.int32), runs)
    msg = np.random.default_rng(sum(runs)).normal(
        size=(seg.shape[0], 12)).astype(np.float32)
    starts = np.searchsorted(seg, [0, 128]).astype(np.int32)
    _plain_equals_loop(msg, seg, starts)


def test_plain_with_order_equals_plain_on_gathered_messages():
    """Reading row ``order[e]`` in place equals reading the gathered
    (sorted) messages, bit for bit: a hub, ids below 0 and at or above N
    (dropped), empty nodes."""
    msg, seg = _hub_edges(12, 900, 12, 300, 150, 400, lo=-20, hi=340)
    m = torch.from_numpy(msg)
    order, s, starts, t = tops.stage(torch.from_numpy(seg), num_segments=300)
    got = tsa.segment_sum_plain(m, s, starts, t, order=order)
    want = tsa.segment_sum_plain(m[order.long()].contiguous(), s, starts, t)
    assert torch.equal(got, want)
    assert torch.equal(tsa.segment_sum_cuda(m, s, starts, t, order=order),
                       got)
    np.testing.assert_allclose(
        got[:300].numpy(), tops.ref.segment_sum_ref(m, torch.from_numpy(seg),
                                                    300).numpy(),
        rtol=RTOL, atol=RTOL)


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


@pytest.mark.parametrize("use_kernel", [True, False])
def test_ops_segment_sum_with_a_hub(use_kernel):
    """A node with 400 of 900 edges (its run crosses 6 or more chunks),
    ids below 0 and at or above N: the port's ``ops.segment_sum`` against
    the JAX reference, and on the kernel route also against the JAX Pallas
    kernel (interpret), rtol 2e-5."""
    msg, seg = _hub_edges(13, 900, 16, 300, 150, 400, lo=-10, hi=320)
    got = tops.segment_sum(torch.from_numpy(msg), torch.from_numpy(seg),
                           num_segments=300, use_kernel=use_kernel)
    wants = [jops.segment_sum(jnp.asarray(msg), jnp.asarray(seg),
                              num_segments=300, use_kernel=False)]
    if use_kernel:
        wants.append(jops.segment_sum(jnp.asarray(msg), jnp.asarray(seg),
                                      num_segments=300, use_kernel=True,
                                      interpret=True))
    for want in wants:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=RTOL)


def test_staged_operands_sum_like_the_order_route():
    """``ref.staged_operands`` (the JAX package's staging: sorted, padded
    to ceil(E/128)*128 + 128 rows) through the wrapper equals the staging
    of ``ops.stage`` read through ``order``, bit for bit on the kept rows:
    the sorted edges sit at the same positions, so the chunks match."""
    msg, seg = _hub_edges(14, 700, 8, 300, 42, 200, lo=-7, hi=310)
    m, sg = torch.from_numpy(msg), torch.from_numpy(seg)
    m_pad, s_pad, st_pad, t = tops.ref.staged_operands(m, sg, 300)
    assert m_pad.shape == (896, 8) and s_pad.shape == (896,) and t == 3
    assert torch.equal(s_pad[700:], torch.full((196,), 384,
                                                dtype=torch.int32))
    order, s, starts, t2 = tops.stage(sg, num_segments=300)
    assert t2 == t and torch.equal(s_pad[:700], s)
    got = tsa.segment_sum_cuda(m_pad, s_pad, st_pad, t)
    want = tsa.segment_sum_cuda(m, s, starts, t, order=order)
    assert torch.equal(got[:300], want[:300])
    assert not want[300:].any()


def test_stage_is_stable_and_padded_like_the_reference():
    """The staged id operands: the order is JAX's (stable) ``argsort`` of
    the clipped ids, the sorted ids are the clipped ids in that order, the
    tile starts are the ``searchsorted`` ones; no message tensor and no
    padding.  With ``assume_sorted`` the ids are only clipped."""
    _, seg = _edges(4, 260, 4, -5, 140)
    order, s, starts, t = tops.stage(torch.from_numpy(seg), num_segments=130)
    clip = np.where((seg >= 0) & (seg < 130), seg, 130)
    want_order = np.asarray(jnp.argsort(jnp.asarray(clip)))
    assert t == 2 and order.dtype == s.dtype == starts.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(s.numpy(), clip[want_order])
    # the last boundary is num_segments: the clipped (dropped) ids lie
    # past it
    np.testing.assert_array_equal(
        starts.numpy(), np.searchsorted(clip[want_order], [0, 128, 130]))
    assert starts[-1] == np.sum(clip < 130)
    none, s2, starts2, t2 = tops.stage(torch.from_numpy(np.sort(clip)),
                                       num_segments=130, assume_sorted=True)
    assert none is None and t2 == 2
    assert torch.equal(s2, s) and torch.equal(starts2, starts)
