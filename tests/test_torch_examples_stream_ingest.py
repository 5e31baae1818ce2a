"""``repro_torch.examples.stream_ingest`` on the CPU at 2 instances, 8
blocks of 64, 4 rounds, cuts ``64,512,4096``, R-MAT scale 10: the update
counter exact, and after the restart the fleet (counter, every layer,
spills, overflow) equal to an uninterrupted 6-round run's; the degree
histogram equal to the JAX package's ``global_degree_histogram_fn`` on a
1-device JAX mesh over the same numpy streams and the tail exponent
within 1e-6 of the reference's; no process group left behind by the
example's one-rank fleet."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from repro.core import assoc as jassoc
from repro.core import distributed as jdist
from repro.core import hier as jhier
from repro.core import stream as jstream
from repro.data.powerlaw import degree_tail_exponent as jtail
from repro_torch import generator
from repro_torch.data.powerlaw import instance_streams
from repro_torch.examples import stream_ingest as si
from repro_torch.launch import ingest

SMALL = dict(instances=2, blocks=8, block_size=64, rounds=4,
             cuts="64,512,4096", scale=10, verbose=False, device="cpu")
HIST = dict(cuts=(64, 512), num_rows=1 << 10, num_bins=16)


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def test_args_are_the_references():
    args = si.ingest_args()
    assert (args.instances, args.blocks, args.block_size, args.rounds,
            args.cuts, args.scale, args.seed, args.ckpt_every) == \
        (8, 32, 4096, 4, "4096,32768,262144", 18, 0, 2)
    assert args.use_kernel is False and args.device == "cuda"


def test_restart_equals_an_uninterrupted_run():
    out, out2, resumed = si.ingest_and_resume(si.ingest_args(**SMALL))
    assert out["n_updates_counter"] == 2 * 8 * 64
    assert out2["n_updates_counter"] == 2 * 12 * 64
    whole, states = ingest.run_with_state(
        si.ingest_args(**dict(SMALL, rounds=6, blocks=12)))
    assert whole["n_updates_counter"] == out2["n_updates_counter"]
    assert whole["overflow"] == out2["overflow"] == 0
    for a, b in zip(resumed.layers, states.layers):
        for f in ("hi", "lo", "val", "nnz"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(resumed.spills, states.spills)


def test_histogram_and_tail_equal_the_reference():
    rows, cols, vals = instance_streams(generator(1, "cpu"), 2, 4, 64,
                                        scale=10)
    assert not dist.is_initialized()
    with si.one_rank_fleet("cpu") as mesh:
        assert mesh.size == 1 and dist.get_backend() == "gloo"
        hist, tail = si.degree_analytics(mesh, rows, cols, vals, **HIST)
    assert not dist.is_initialized()
    jmesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    jstates = jdist.create_instances(2, HIST["cuts"], 64)
    jstates, _ = jax.jit(jstream.ingest_instances)(
        jstates, *(jnp.asarray(x.numpy()) for x in (rows, cols, vals)))
    want = jdist.global_degree_histogram_fn(
        jmesh, ("data",), num_rows=HIST["num_rows"],
        num_bins=HIST["num_bins"])(jstates)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(want))
    merged = jhier.query_all(jax.tree.map(lambda x: x[0], jstates))
    jdeg = jassoc.reduce_rows(merged, HIST["num_rows"])
    assert abs(tail - jtail(jdeg)) < 1e-6
    assert int(hist.sum()) > 0


def test_main_leaves_no_process_group():
    kw = {k: v for k, v in SMALL.items() if k != "device"}
    out = si.main("cpu", hist_instances=2, hist_blocks=4, hist_block=64,
                  hist_scale=10, hist_cuts=HIST["cuts"],
                  num_rows=HIST["num_rows"], **kw)
    assert not dist.is_initialized()
    assert out["counter"] == 2 * 8 * 64
    assert out["resumed_counter"] == 2 * 12 * 64
    assert sum(out["histogram"]) > 0 and out["tail_exponent"] > 1
