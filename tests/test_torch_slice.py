"""The port's slice as a whole against the JAX package: one numpy R-MAT
stream through ``ingest_instances`` (grouped, lazy layer 0, merge kernels
on — their plain versions here) in both packages, then live point lookups
and ``query_all`` per instance; and the ingest CLI on the CPU, whose
exact counter must equal the updates fed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.core import hier as jhier
from repro.core import stream as jstream
from repro.query import engine as jengine
from repro_torch.core import distributed as tdist
from repro_torch.core import hier as thier
from repro_torch.core import stream as tstream
from repro_torch.kernels import registry
from repro_torch.launch import ingest as tingest
from repro_torch.query import engine as tengine

import torch_parity as tp

CUTS = (64, 256)
I, T, B, SCALE = 3, 16, 32, 8


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def _rmat_stream(seed):
    """A numpy R-MAT (Graph500) stream [I, T, B] with unit values."""
    rng = np.random.default_rng(seed)
    quad = rng.choice(4, size=(I * T * B, SCALE), p=(0.57, 0.19, 0.19, 0.05))
    w = 1 << np.arange(SCALE)
    rows = ((quad >> 1) * w).sum(1).astype(np.int32).reshape(I, T, B)
    cols = ((quad & 1) * w).sum(1).astype(np.int32).reshape(I, T, B)
    return rows, cols, np.ones((I, T, B), np.float32)


def test_slice_ingest_then_lookups_match():
    rows, cols, vals = _rmat_stream(0)
    jstates, jtel = jstream.ingest_instances(
        jdist.create_instances(I, CUTS, B), *map(jnp.asarray,
                                                 (rows, cols, vals)),
        lazy_l0=True, batch_mode="grouped")
    registry.reset_launches()
    tstates, ttel = tstream.ingest_instances(
        tdist.create_instances(I, CUTS, B, device="cpu"),
        *map(torch.from_numpy, (rows, cols, vals)), lazy_l0=True,
        use_kernel=True, batch_mode="grouped")
    # CPU tensors run the plain versions: no CUDA launch is counted
    assert registry.launches()["hier_merge.merge_multi"] == 0
    tp.assert_states_equal(tstates, jstates)
    tp.assert_telemetry_equal(ttel, jtel)
    assert int(tstates.spills[:, 0].sum()) > 0
    assert thier.exact_update_count(tstates) == I * T * B
    qr, qc = rows[:, -1, :], cols[:, -1, :] + 1      # hits and misses
    for i in range(I):
        jh = jax.tree.map(lambda x: x[i], jstates)
        th = tstream.instance(tstates, i)
        q = (np.concatenate([rows[i, -1], qr[i]]),
             np.concatenate([cols[i, -1], qc[i]]))
        want = jengine.point_lookup(jh, *map(jnp.asarray, q))
        for mode in ("auto", "scan", "canon"):
            got = tengine.point_lookup(th, *map(torch.from_numpy, q),
                                       use_kernel=True, l0_mode=mode)
            tp.assert_vals(got.numpy(), np.asarray(want), exact=True)
        tp.assert_segment_equal(thier.query_all(th, use_kernel=True),
                                jhier.query_all(jh))


def test_ingest_cli_on_cpu():
    args = tingest.parser().parse_args(
        ["--instances", "3", "--blocks", "8", "--rounds", "2",
         "--block-size", "32", "--cuts", "64,256", "--scale", "8",
         "--use-kernel", "--device", "cpu"])
    out = tingest.run(args)
    assert set(out) == {"updates_per_s", "total_updates", "wall_s",
                        "frac_blocks_layer0", "n_updates_counter",
                        "overflow"}
    assert out["total_updates"] == 3 * 8 * 32
    assert out["n_updates_counter"] == out["total_updates"]
    assert out["overflow"] == 0
    assert 0.0 <= out["frac_blocks_layer0"] <= 1.0
    out2, states = tingest.run_with_state(args)
    assert out2["n_updates_counter"] == out["n_updates_counter"]
    assert states.layers[0].hi.shape == (3, 64 + 32)
