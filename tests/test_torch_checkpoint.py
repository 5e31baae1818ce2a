"""Port parity: ``repro_torch.checkpoint`` against ``repro.checkpoint``,
and the ingest CLI's checkpoint, resume and obs flags against
``repro.launch.ingest``.

The port writes the JAX package's on-disk format (one .npy per leaf under
the JAX pytree path, ``manifest.json``, atomic ``step_<n>.tmp`` rename), so
a fleet written by either package restores in the other, leaf for leaf,
with update counters past 2**31, 2**32 and 2**33 (the port's int64
counter on disk as the reference's (uint32 lo, int32 hi) words).  The
reference's ``test_checkpoint_*`` cases are ported: a mixed tree, a
mid-stream fused + lazy hierarchy whose continued ingest equals an
uncheckpointed run bit for bit, the pre-widening manifest (a missing
``n_updates_hi`` keeps the template's value with a warning; any other
missing leaf raises ``KeyError``), a leftover ``.tmp`` directory, and the
asynchronous checkpointer's garbage collection — whose snapshot no
in-place update made after ``save`` reaches.  Exact throughout: the
streams are integer-valued.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.checkpoint import ckpt as jckpt_mod
from repro.core import distributed as jdist
from repro.core import hier as jhier
from repro.core import stream as jstream
from repro.launch import ingest as jingest
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.core import distributed as tdist
from repro_torch.core import hier as thier
from repro_torch.core import stream as tstream
from repro_torch.launch import ingest as tingest
from repro_torch.obs import trace as ttrace

import torch_parity as tp

ROOT = Path(__file__).resolve().parents[1]
CUTS = (16, 64, 256)
BLOCK = 8
I = 3


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def _jax_fleet(seed=0, t=12):
    rows, cols, vals = tp.stream(seed, (I, t, BLOCK), 40)
    states, _ = jstream.ingest_instances(
        jdist.create_instances(I, CUTS, BLOCK), *map(jnp.asarray,
                                                     (rows, cols, vals)),
        lazy_l0=True)
    return states


def _numpy_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def _manifest(step_dir) -> dict:
    with open(os.path.join(step_dir, "manifest.json")) as f:
        return json.load(f)


# ------------------------------------------------------------ round trips --

def test_checkpoint_roundtrip_mixed_tree(tmp_path):
    """A dict of parameters, a hierarchy and a step counter: every leaf
    back equal, static fields from the template, and the manifest's paths,
    shapes and dtypes those the JAX package writes for the same tree."""
    rows, cols = np.array([1, 2, 3, 1], np.int32), np.array([0, 1, 2, 0],
                                                             np.int32)
    h = thier.update(thier.create((8, 32), 4, device="cpu"),
                     torch.from_numpy(rows), torch.from_numpy(cols),
                     torch.ones(4))
    w = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    state = dict(params=dict(w=torch.from_numpy(w)), h=h,
                 step=torch.tensor(7, dtype=torch.int32))
    tckpt.save(str(tmp_path / "t"), 7, state, extra=dict(note="x"))
    assert tckpt.latest_step(str(tmp_path / "t")) == 7
    r = tckpt.restore(str(tmp_path / "t"), 7, state)
    assert r["h"].cuts == h.cuts
    assert torch.equal(r["params"]["w"], state["params"]["w"])
    assert torch.equal(r["step"], state["step"])
    _numpy_equal(thier.state_to_numpy(r["h"]), thier.state_to_numpy(h))

    jh = jhier.update(jhier.create((8, 32), 4), jnp.asarray(rows),
                      jnp.asarray(cols), jnp.ones(4))
    jckpt.save(str(tmp_path / "j"), 7,
               dict(params=dict(w=jnp.asarray(w)), h=jh, step=jnp.int32(7)),
               extra=dict(note="x"))
    mt, mj = (_manifest(tmp_path / d / "step_7") for d in ("t", "j"))
    assert mt == mj


def test_checkpoint_midstream_hier_roundtrip(tmp_path):
    """Save/restore a MID-STREAM hierarchy driven by the fused + lazy
    default path (a live append buffer, spills, overflow, counter): the
    restored state answers ``query_all`` identically and continued ingest
    equals an uncheckpointed run bit for bit — and the JAX package's run
    of the same stream."""
    rng = np.random.default_rng(42)
    steps, block, nkeys, cut_at = 16, 8, 10 ** 6, 13
    R = rng.integers(0, nkeys, (steps, block)).astype(np.int32)
    C = rng.integers(0, nkeys, (steps, block)).astype(np.int32)
    V = rng.integers(1, 4, (steps, block)).astype(np.float32)
    tR, tC, tV = map(torch.from_numpy, (R, C, V))
    mid, _ = tstream.ingest(thier.create((8, 16, 32), 8, device="cpu"),
                            tR[:cut_at], tC[:cut_at], tV[:cut_at],
                            fused=True, lazy_l0=True)
    assert int(mid.layers[0].nnz) > 0
    assert int(mid.spills.sum()) > 0 and int(mid.overflow) > 0
    assert int(mid.n_updates) == cut_at * block

    tckpt.save(str(tmp_path), cut_at, mid)
    restored = tckpt.restore(str(tmp_path), cut_at,
                             thier.create((8, 16, 32), 8, device="cpu"))
    assert restored.cuts == mid.cuts
    _numpy_equal(thier.state_to_numpy(restored), thier.state_to_numpy(mid))
    q_mid = thier.query_all(mid, lazy_l0=True)
    q_res = thier.query_all(restored, lazy_l0=True)
    assert torch.equal(q_mid.hi, q_res.hi) and torch.equal(q_mid.val,
                                                           q_res.val)
    cont_ckpt, _ = tstream.ingest(restored, tR[cut_at:], tC[cut_at:],
                                  tV[cut_at:], fused=True, lazy_l0=True)
    cont_live, _ = tstream.ingest(mid, tR[cut_at:], tC[cut_at:],
                                  tV[cut_at:], fused=True, lazy_l0=True)
    _numpy_equal(thier.state_to_numpy(cont_ckpt),
                 thier.state_to_numpy(cont_live))
    jfinal, _ = jstream.ingest(jhier.create((8, 16, 32), 8),
                               *map(jnp.asarray, (R, C, V)), fused=True,
                               lazy_l0=True)
    tp.assert_states_equal(cont_ckpt, jfinal)
    assert int(cont_ckpt.n_updates) == steps * block


def _with_counter(jstates, base: int):
    """The JAX fleet with instance i's counter set to ``base + i``."""
    n = np.array([base + i for i in range(I)], dtype=np.int64)
    return jstates.__class__(
        layers=jstates.layers, spills=jstates.spills,
        overflow=jstates.overflow,
        n_updates=jnp.asarray((n & 0xFFFFFFFF).astype(np.uint32)),
        n_updates_hi=jnp.asarray((n >> 32).astype(np.int32)),
        cuts=jstates.cuts)


@pytest.mark.parametrize("base", [2**31 + 5, 2**32 + 7, 2**33 + 1])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fleet_checkpoint_crosses_packages(tmp_path, writer, base):
    """A fleet checkpoint written by one package restores in the other with
    equal contents, counters past 2**31, 2**32 and 2**33 included."""
    jstates = _with_counter(_jax_fleet(), base)
    want = tp.jax_state_to_numpy(jstates)
    if writer == "jax":
        jckpt.save(str(tmp_path), 5, jstates)
        got = tckpt.restore(str(tmp_path), 5, tdist.create_instances(
            I, CUTS, BLOCK, device="cpu"))
        _numpy_equal(thier.state_to_numpy(got), want)
        assert got.n_updates.tolist() == [base + i for i in range(I)]
    else:
        tstates = tp.to_torch(jstates)
        assert tstates.n_updates.tolist() == [base + i for i in range(I)]
        tckpt.save(str(tmp_path), 5, tstates)
        got = jckpt.restore(str(tmp_path), 5,
                            jdist.create_instances(I, CUTS, BLOCK))
        _numpy_equal(tp.jax_state_to_numpy(got), want)
        man = _manifest(tmp_path / "step_5")
        assert [l["path"] for l in man["leaves"]] == \
            [p for p, _ in jckpt_mod._flatten(jstates)]
        assert {l["path"]: l["dtype"] for l in man["leaves"]}[
            ".n_updates"] == "uint32"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_restores_pre_widening_manifest(tmp_path, writer):
    """A manifest without ``n_updates_hi`` (written before the counter's
    high word existed) restores with the template's hi = 0 and a warning;
    a manifest missing any other leaf raises ``KeyError``."""
    jstates = _jax_fleet(1, 6)
    if writer == "jax":
        jckpt.save(str(tmp_path), 3, jstates)
    else:
        tckpt.save(str(tmp_path), 3, tp.to_torch(jstates))
    mpath = tmp_path / "step_3" / "manifest.json"
    man = json.loads(mpath.read_text())
    kept = [l for l in man["leaves"] if "n_updates_hi" not in l["path"]]
    assert len(kept) == len(man["leaves"]) - 1
    mpath.write_text(json.dumps(dict(man, leaves=kept)))
    template = tdist.create_instances(I, CUTS, BLOCK, device="cpu")
    with pytest.warns(UserWarning, match="migrating old checkpoint"):
        restored = tckpt.restore(str(tmp_path), 3, template)
    want = tp.jax_state_to_numpy(jstates)
    _numpy_equal(thier.state_to_numpy(restored), want)     # hi was 0 too
    assert restored.n_updates.tolist() == [6 * BLOCK] * I

    mpath.write_text(json.dumps(dict(
        man, leaves=[l for l in kept if "overflow" not in l["path"]])))
    with pytest.raises(KeyError, match="overflow"):
        tckpt.restore(str(tmp_path), 3, template)


def test_checkpoint_atomicity_partial_dir_ignored(tmp_path):
    tckpt.save(str(tmp_path), 1, dict(w=torch.ones(3)))
    # a crashed mid-save leaves only a .tmp dir — must be invisible
    os.makedirs(tmp_path / "step_2.tmp")
    assert tckpt.latest_step(str(tmp_path)) == 1
    assert tckpt.latest_step(str(tmp_path / "absent")) is None


def test_async_checkpointer_gc(tmp_path):
    ac = tckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ac.save(s, dict(w=torch.full((4,), float(s))))
    ac.wait()
    kept = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert kept == ["step_3", "step_4"]
    r = tckpt.restore(str(tmp_path), 4, dict(w=torch.zeros(4)))
    assert torch.equal(r["w"], torch.full((4,), 4.0))


def test_async_snapshot_unaffected_by_in_place_updates(tmp_path):
    """``AsyncCheckpointer.save`` copies the state to the host before it
    returns: the fleet updated in place afterwards (as ``segment_add`` and
    the stream's member writes do) leaves the written checkpoint as it was
    at ``save``."""
    states = tp.to_torch(_jax_fleet(2, 6))
    want = {k: np.array(v, copy=True)
            for k, v in thier.state_to_numpy(states).items()}
    ac = tckpt.AsyncCheckpointer(str(tmp_path), keep=1)
    ac.save(1, states)
    for leaf in (states.layers[0].val, states.layers[1].hi, states.spills,
                 states.n_updates):
        leaf.add_(1)
    ac.wait()
    got = tckpt.restore(str(tmp_path), 1, states)
    want["cuts"] = got.cuts
    _numpy_equal(thier.state_to_numpy(got), want)
    assert not np.array_equal(thier.state_to_numpy(states)["spills"],
                              want["spills"])


def test_bfloat16_leaves_in_the_reference_format(tmp_path):
    """bf16 leaves go to disk as the JAX package writes them (raw 2-byte
    words, ``bfloat16`` in the manifest): the port restores the JAX
    package's bf16 checkpoint and its own bit for bit."""
    x = np.random.default_rng(3).normal(size=12).astype(np.float32)
    jckpt.save(str(tmp_path / "j"), 1, dict(v=jnp.asarray(x, jnp.bfloat16)))
    tv = torch.from_numpy(x).to(torch.bfloat16)
    tckpt.save(str(tmp_path / "t"), 1, dict(v=tv))
    assert _manifest(tmp_path / "j" / "step_1") == \
        _manifest(tmp_path / "t" / "step_1")
    for d in ("j", "t"):
        r = tckpt.restore(str(tmp_path / d), 1,
                          dict(v=torch.zeros(12, dtype=torch.bfloat16)))
        assert r["v"].dtype == torch.bfloat16
        assert torch.equal(r["v"].view(torch.int16), tv.view(torch.int16))


# ------------------------------------------------------------ ingest CLI --

def _reference_defaults(monkeypatch) -> dict:
    """The reference CLI's parsed defaults (its parser is built inside
    ``main``: run it with ``run`` replaced)."""
    seen = {}

    def fake_run(args):
        seen.update(vars(args))
        return dict(updates_per_s=1.0, total_updates=1, wall_s=1.0,
                    n_updates_counter=1, overflow=0)
    monkeypatch.setattr(jingest, "run", fake_run)
    monkeypatch.setattr("sys.argv", ["ingest"])
    jingest.main()
    return seen


def test_ingest_flags_match_reference(monkeypatch):
    """The port's ingest CLI has the reference's flags with its defaults,
    ``--ckpt-dir``/``--ckpt-every``/``--resume``/``--obs``/``--obs-dir``
    and ``--precompile``/``--stages-cache`` among them, plus ``--device``
    (default cuda)."""
    want = _reference_defaults(monkeypatch)
    got = vars(tingest.parser().parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want
    for k in ("ckpt_dir", "ckpt_every", "resume", "obs", "obs_dir",
              "precompile", "stages_cache"):
        assert k in got, k
    assert got["precompile"] is False and got["stages_cache"] == ""


def _cli(tmp_path, *extra):
    return tingest.parser().parse_args(
        ["--instances", "3", "--blocks", "16", "--rounds", "8",
         "--block-size", "32", "--cuts", "64,256,1024", "--scale", "8",
         "--use-kernel", "--device", "cpu", *extra])


def test_ingest_resume_equals_uninterrupted_run(tmp_path):
    """``--ckpt-every 2``, cut after round 5 (the checkpoints of rounds 6
    and 8 removed, standing for a crash), then ``--resume``: the run
    restarts at round 4, draws rounds 4..7 as the uninterrupted run did,
    and ends in its state, leaf for leaf; the fast-layer fraction counts
    only the resumed rounds' spills."""
    d = str(tmp_path / "ck")
    out_a, a = tingest.run_with_state(_cli(tmp_path, "--ckpt-dir", d,
                                           "--ckpt-every", "2"))
    assert sorted(os.listdir(d)) == ["step_2", "step_4", "step_6", "step_8"]
    for s in (6, 8):
        shutil.rmtree(os.path.join(d, f"step_{s}"))
    out_b, b = tingest.run_with_state(_cli(tmp_path, "--ckpt-dir", d,
                                           "--ckpt-every", "2", "--resume"))
    _numpy_equal(thier.state_to_numpy(b), thier.state_to_numpy(a))
    assert out_b["total_updates"] == 4 * 3 * 2 * 32
    assert out_b["n_updates_counter"] == out_a["n_updates_counter"] \
        == 3 * 16 * 32
    assert sorted(os.listdir(d)) == ["step_2", "step_4", "step_6", "step_8"]
    assert 0.0 <= out_b["frac_blocks_layer0"] <= 1.0
    # round r's stream does not depend on the rounds before it
    one = tingest.round_generator(0, 5, "cpu")
    assert torch.equal(torch.randint(0, 99, (8,), generator=one),
                       torch.randint(0, 99, (8,), generator=tingest
                                     .round_generator(0, 5, "cpu")))


def test_ingest_obs_events_read_by_the_reference_monitor(tmp_path):
    """``--obs`` writes the fleet sample before the stream and after every
    round, one ``ingest_round`` span per round, the metrics snapshot and
    the run summary; the reference's stdlib-only monitor, as its own
    command, aggregates them into the run's update total and rate."""
    d = str(tmp_path / "obs")
    try:
        out = tingest.run(_cli(tmp_path, "--obs", "--obs-dir", d))
    finally:
        ttrace.disable()
    with open(os.path.join(d, "obs.jsonl")) as f:
        evs = [json.loads(line)["ev"] for line in f]
    assert evs.count("fleet") == 9 and evs.count("ingest_round") == 8
    assert evs[-2:] == ["metrics", "run_summary"]
    summary_path = tmp_path / "summary.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", "repro.launch.monitor",
                          "--once", "--strict", "--obs-dir", d,
                          "--summary-out", str(summary_path)],
                         env=env, cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    summary = json.loads(summary_path.read_text())
    assert summary["malformed_records"] == 0
    assert summary["events"]["run_summary"] == 1
    assert summary["fleet"]["updates_total"] == out["total_updates"]
    assert summary["fleet"]["updates_per_s"] == pytest.approx(
        out["updates_per_s"])
