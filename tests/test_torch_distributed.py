"""Port parity: ``repro_torch.core.distributed``'s sharded functions on
P = 2 and P = 4 gloo ranks on the CPU against ``repro.core.distributed``
on a 1-device CPU mesh.

The port's ranks start through ``launch.mesh.spawn_fleet``, once per P for
the whole module, and run every job in one go
(``torch_parity.run_fleet_jobs``); each rank holds its block of the fleet
(4 instances: 2 or 1 a rank) and returns its results, joined here in rank
order.  Inputs are numpy streams from ``torch_parity.stream`` (no SENTINEL
keys), states carried from the JAX package through the numpy converter.

* ``sharded_ingest_fn``: states and [I, T, ...] telemetry equal for the
  grouped and bucketed modes, lazy layer 0 on and off, chunk 1 and 2;
* ``sharded_query_fn``: the four semirings, ``per_instance`` on and off,
  each ``l0_mode``, ``use_kernel`` (the plain versions on the CPU) — the
  combined [Q] answer on every rank, the per-instance blocks joined —
  also on a float16 fleet (a 16-bit ``all_reduce``, exact on integers);
* ``global_degree_histogram_fn`` under the four semirings;
* ``aggregate_update_counts_fn`` with per-instance counters past 2**31,
  2**32 and 2**33;
* the ``invalid d4m config signature`` cases, nccl with more ranks than
  cards, and a ``torchrun`` fleet built by ``make_fleet_mesh``.

Tolerance: exact on integer-valued streams (keys, nnz, spills, overflow
and counters always); on the float stream values within the registry
rtol (1e-4, ``torch_parity.RTOL``): the port sums locally then
``all_reduce``s, the reference vmap-sums then ``psum``s.
"""
import itertools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.core import semiring as jsr
from repro.core import stream as jstream
from repro_torch.core import distributed as tdist
from repro_torch.core import hier as thier
from repro_torch.launch import mesh as tmesh

import torch_parity as tp

CUTS = (16, 64, 256)
BLOCK = 8
I = 4
T = 12
NKEYS = 40
Q = 20
NUM_BINS = 4
AXES = ("data",)
SEMIRINGS = ("plus.times", "max.plus", "min.plus", "max.min")
RANKS = (2, 4)

INGEST = [(mode, lazy, chunk, True) for mode, lazy, chunk in
          itertools.product(("grouped", "bucketed"), (True, False), (1, 2))]
INGEST += [("grouped", True, 1, False)]            # float values
INGEST_IDS = [f"{m}-lazy{int(l)}-chunk{c}-{'int' if i else 'float'}"
              for m, l, c, i in INGEST]
FLEETS = [(s, True, "float32") for s in SEMIRINGS]
FLEETS += [("plus.times", False, "float32"),   # float values
           ("plus.times", True, "float16")]    # a 16-bit all_reduce
QUERY = [(s, i, dt, mode, pi) for s, i, dt in FLEETS
         for mode in ("auto", "scan", "canon") for pi in (False, True)]
QUERY_IDS = [f"{s}-{'int' if i else 'float'}-{dt}-{m}-"
             f"{'per' if p else 'comb'}" for s, i, dt, m, p in QUERY]
COUNTERS = np.array([2**31 + 5, 2**32 + 7, 2**33 + 11, 2**33 + 2**32 + 3],
                    np.int64)


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def _mesh1():
    return jax.make_mesh((1,), AXES)


def _fleet(sr_name, integer, dtype):
    """A JAX fleet of I instances past layer-0 spills; plus.times with the
    lazy append buffer."""
    sr = jsr.get(sr_name)
    rows, cols, vals = tp.stream(7, (I, T, BLOCK), NKEYS, integer)
    states = jdist.create_instances(I, CUTS, BLOCK, dtype=dtype, sr=sr)
    states, _ = jstream.ingest_instances(
        states, jnp.asarray(rows), jnp.asarray(cols),
        jnp.asarray(vals, dtype), sr=sr, lazy_l0=sr_name == "plus.times")
    assert int(np.asarray(states.spills)[:, 0].min()) > 0
    return states


def _queries(state: dict):
    """Q keys: live keys of every layer of the fleet, then keys past
    NKEYS that no instance holds."""
    live = set()
    for i in range(len(CUTS)):
        hi, lo = state[f"layers[{i}].hi"], state[f"layers[{i}].lo"]
        nnz = state[f"layers[{i}].nnz"]
        for k in range(I):
            live |= set(zip(hi[k, :nnz[k]].tolist(), lo[k, :nnz[k]].tolist()))
    rng = np.random.default_rng(3)
    keys = sorted(live)
    pick = [keys[j] for j in rng.choice(len(keys), Q - 4, replace=False)]
    pick += [(NKEYS + 1, 2), (3, NKEYS + 5), (NKEYS + 2, NKEYS + 2), (0, 99)]
    q = np.asarray(pick, np.int32)
    return q[:, 0].copy(), q[:, 1].copy()


@pytest.fixture(scope="module")
def cases():
    """Every job's inputs (numpy) and the reference's answers."""
    mesh = _mesh1()
    jobs, want = [], []
    for mode, lazy, chunk, integer in INGEST:
        stream = tp.stream(11, (I, T, BLOCK), NKEYS, integer)
        fresh = jdist.create_instances(I, CUTS, BLOCK)
        knobs = dict(lazy_l0=lazy, chunk=chunk, batch_mode=mode)
        jobs.append(("ingest", knobs,
                     dict(states=tp.jax_state_to_numpy(fresh),
                          stream=stream)))
        want.append(jdist.sharded_ingest_fn(mesh, AXES, **knobs)(
            jdist.create_instances(I, CUTS, BLOCK),
            *map(jnp.asarray, stream)))
    fleets = {key: _fleet(*key) for key in FLEETS}
    for sr_name, integer, dtype, mode, per in QUERY:
        states = fleets[sr_name, integer, dtype]
        d = tp.jax_state_to_numpy(states)
        queries = _queries(d)
        knobs = dict(sr=sr_name, use_kernel=True, l0_mode=mode,
                     per_instance=per)
        jobs.append(("query", knobs, dict(states=d, queries=queries)))
        want.append(np.asarray(jdist.sharded_query_fn(
            mesh, AXES, **dict(knobs, sr=jsr.get(sr_name)))(
                states, *map(jnp.asarray, queries))))
    for sr_name in SEMIRINGS:
        states = fleets[sr_name, True, "float32"]
        jobs.append(("histogram", dict(num_rows=NKEYS, num_bins=NUM_BINS,
                                       sr=sr_name),
                     dict(states=tp.jax_state_to_numpy(states))))
        want.append(np.asarray(jdist.global_degree_histogram_fn(
            mesh, AXES, NKEYS, NUM_BINS, jsr.get(sr_name))(states)))
    states = fleets["plus.times", True, "float32"]
    states = states.__class__(
        layers=states.layers, spills=states.spills,
        overflow=states.overflow,
        n_updates=jnp.asarray(COUNTERS % 2**32, jnp.uint32),
        n_updates_hi=jnp.asarray(COUNTERS >> 32, jnp.int32),
        cuts=states.cuts)
    jobs.append(("count", {}, dict(states=tp.jax_state_to_numpy(states))))
    want.append(jdist.aggregate_update_counts_fn(mesh, AXES)(states))
    return jobs, want


@pytest.fixture(scope="module", params=RANKS, ids=lambda p: f"P{p}")
def fleet(request, cases, tmp_path_factory):
    """Every job run once on P gloo ranks: (P, per-rank results, the
    reference's answers)."""
    jobs, want = cases
    P = request.param
    got = tmesh.spawn_fleet(tp.run_fleet_jobs, P, "gloo", "cpu",
                            str(tmp_path_factory.mktemp(f"fleet{P}")),
                            args=(jobs,))
    assert len(got) == P and all(len(r) == len(jobs) for r in got)
    return P, got, want


def _joined(blocks):
    """Per-rank results with a leading instance axis, in rank order."""
    if isinstance(blocks[0], dict):
        return {k: blocks[0][k] if k == "cuts" else
                _joined([b[k] for b in blocks]) for k in blocks[0]}
    return np.concatenate(blocks, axis=0)


def _same_on_every_rank(got, j):
    for r in got[1:]:
        np.testing.assert_array_equal(r[j], got[0][j])
    return got[0][j]


@pytest.mark.parametrize("case", range(len(INGEST)), ids=INGEST_IDS)
def test_sharded_ingest(fleet, case):
    P, got, want = fleet
    state = _joined([r[case][0] for r in got])
    tel = _joined([r[case][1] for r in got])
    want_state, want_tel = want[case]
    state = thier.state_from_numpy(state, device="cpu")
    tp.assert_states_equal(state, want_state, exact=INGEST[case][3])
    assert (state.n_updates == T * BLOCK).all()
    _assert_tree_equal(tel, want_tel)
    # every rank ingested its own block only: P blocks of I/P instances
    assert all(r[case][0]["spills"].shape[0] == I // P for r in got)


def _assert_tree_equal(got, want):
    if isinstance(got, dict):
        assert got.keys() == want.keys()
        for k in got:
            _assert_tree_equal(got[k], want[k])
        return
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("case", range(len(QUERY)), ids=QUERY_IDS)
def test_sharded_query(fleet, case):
    P, got, want = fleet
    j = len(INGEST) + case
    sr_name, integer, dtype, _, per = QUERY[case]
    if per:
        assert all(r[j].shape == (I // P, Q) for r in got)
        out = _joined([r[j] for r in got])
    else:
        out = _same_on_every_rank(got, j)
        assert out.shape == (Q,)
    assert out.dtype == np.dtype(dtype)
    tp.assert_vals(out, want[j], integer, "query")
    if sr_name != "plus.times":        # absent keys: the zero, +-inf
        assert np.isinf(out[..., -4:]).all()


@pytest.mark.parametrize("sr_name", SEMIRINGS)
def test_global_degree_histogram(fleet, sr_name):
    P, got, want = fleet
    j = len(INGEST) + len(QUERY) + SEMIRINGS.index(sr_name)
    out = _same_on_every_rank(got, j)
    assert out.dtype == np.int32 and out.shape == (NUM_BINS,)
    np.testing.assert_array_equal(out, want[j])
    assert out.sum() > 0


def test_aggregate_update_counts_past_word_boundaries(fleet):
    P, got, want = fleet
    out = _same_on_every_rank(got, -1)
    assert isinstance(out, np.int64) and isinstance(want[-1], np.int64)
    assert out == want[-1] == COUNTERS.sum()


def test_invalid_signatures():
    """A ``data_axes`` that is not an axis of the mesh and an instance
    count the ranks do not divide raise the shared signature error; the
    reference refuses the bad axis too (shard_map's own error)."""
    mesh = tmesh.FleetMesh(group=None, rank=1, size=2,
                           device=torch.device("cpu"))
    for fn in (lambda a: tdist.sharded_ingest_fn(mesh, a),
               lambda a: tdist.sharded_query_fn(mesh, a),
               lambda a: tdist.global_degree_histogram_fn(mesh, a, 8, 4),
               lambda a: tdist.aggregate_update_counts_fn(mesh, a)):
        fn(AXES)
        for bad in (("model",), ("data", "data")):
            with pytest.raises(ValueError,
                               match="invalid d4m config signature"):
                fn(bad)
    with pytest.raises(ValueError):
        jdist.sharded_query_fn(_mesh1(), ("model",))(
            jdist.create_instances(2, CUTS, BLOCK), jnp.zeros(2, jnp.int32),
            jnp.zeros(2, jnp.int32))
    fleet = tdist.create_instances(3, CUTS, BLOCK, device="cpu")
    with pytest.raises(ValueError, match="invalid d4m config signature: 3 "
                       "instances do not divide over the 2 ranks"):
        tdist.shard(mesh, fleet)
    with pytest.raises(ValueError, match="invalid d4m config signature"):
        tdist.shard(mesh, torch.zeros((5, 2)))
    four = tdist.shard(mesh, tdist.create_instances(4, CUTS, BLOCK,
                                                    device="cpu"))
    assert four.spills.shape[0] == 2
    assert tdist.local_block(mesh, 4) == slice(2, 4)


def test_nccl_with_more_ranks_than_cards_raises(tmp_path):
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="nccl runs one rank per card"):
        tmesh.spawn_fleet(tp.run_fleet_jobs, n + 1, "nccl", "cuda",
                          str(tmp_path), args=([],))
    with pytest.raises(ValueError, match="backend must be one of"):
        tmesh.spawn_fleet(tp.run_fleet_jobs, 1, "mpi", "cpu", str(tmp_path))
    assert not list(tmp_path.iterdir())           # refused before any spawn


TORCHRUN_SCRIPT = """
import numpy as np, torch
from repro_torch.core import distributed
from repro_torch.launch.mesh import make_fleet_mesh
mesh = make_fleet_mesh("gloo", device="cpu")
fleet = distributed.create_instances(4, (16, 64), 8, device="cpu")
fleet = distributed.shard(mesh, fleet)
fleet.n_updates.fill_(2**33 + mesh.rank)
total = distributed.aggregate_update_counts_fn(mesh, ("data",))(fleet)
with open(f"rank{mesh.rank}.txt", "w") as f:
    f.write(f"{mesh.rank} {mesh.size} {mesh.device} {int(total)}")
torch.distributed.destroy_process_group()
"""


def test_make_fleet_mesh_under_torchrun(tmp_path):
    """``torchrun --standalone --nproc-per-node 2`` over
    ``make_fleet_mesh``: two ranks on the CPU find their rank, size and
    device, and count the fleet exactly."""
    script = tmp_path / "fleet.py"
    script.write_text(TORCHRUN_SCRIPT)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(Path(__file__).resolve().parents[1] / "src"),
                    os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(script)],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [(tmp_path / f"rank{r}.txt").read_text().split()
             for r in range(2)]
    want = str(4 * 2**33 + 0 + 0 + 1 + 1)
    assert lines == [["0", "2", "cpu", want], ["1", "2", "cpu", want]]
