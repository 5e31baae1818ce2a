"""Port parity: ``repro_torch.analysis.contracts`` against
``repro.analysis.contracts``.

A ``HierVec`` training state (``dcn.hier_embed_init``) restores under
``REPRO_CHECK=1``, checked by its own contract, and each clause of that
contract seeded into a saved state is refused — held against a dict-based
check of the saved arrays, not against the reference, whose duck typing
takes a ``HierVec`` for a ``HierAssoc``.

Each violation that the reference's ``tests/test_contracts.py`` seeds
(a dirty sentinel tail, an unsorted prefix, a SENTINEL key in the prefix,
the nnz bound, the counter's carry and consistency, the spill-plan bound)
is seeded into the same JAX state, carried into the port, and fires in
both packages with the same message text (the reference's checkify error,
the port's ``ContractViolation``); a clean state passes both.  Under
``REPRO_CHECK=1`` the port's front doors (``hier.update``/``flush``,
``stream.update_instances``/``ingest_instances``,
``engine.point_lookup``, ``checkpoint.restore``) return exactly what they
return unchecked, refuse a corrupt input naming the invariant, and with
the knob off run no check at all.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import contracts as jcon
from repro.core import assoc as jassoc
from repro.core import hier as jhier
from repro.core import semiring as jsr
from repro_torch.analysis import contracts as tcon
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.core import assoc as tassoc
from repro_torch.core import distributed as tdist
from repro_torch.core import hier as thier
from repro_torch.core import stream as tstream
from repro_torch.query import engine as tengine

import torch_parity as tp

JSR = jsr.PLUS_TIMES
TSR = tassoc.sr_mod.PLUS_TIMES


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


@pytest.fixture(autouse=True)
def _knob_off(monkeypatch):
    monkeypatch.delenv("REPRO_CHECK", raising=False)


def small_hier(seed=0, cuts=(16, 64), block=8, n=8):
    """The reference test's state: one block of n random keys (numpy)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 50, n).astype(np.int32)
    cols = rng.integers(0, 50, n).astype(np.int32)
    return jhier.update(jhier.create(cuts, block_size=block),
                        jnp.asarray(rows), jnp.asarray(cols),
                        jnp.ones((n,), jnp.float32))


def with_layer0(h, **fields):
    l0 = dataclasses.replace(h.layers[0], **fields)
    return dataclasses.replace(h, layers=(l0,) + h.layers[1:])


def make_seg(n=6, cap=16):
    idx = jnp.arange(n, dtype=jnp.int32)
    seg, _ = jassoc.from_coo(idx, idx, jnp.ones((n,), jnp.float32), cap, JSR)
    return seg


def to_port_seg(seg):
    return tassoc.AssocSegment(*(torch.from_numpy(np.array(getattr(seg, f)))
                                 for f in ("hi", "lo", "val", "nnz")))


def _swap01(seg):
    return dataclasses.replace(
        seg, hi=seg.hi.at[0].set(seg.hi[1]).at[1].set(seg.hi[0]),
        lo=seg.lo.at[0].set(seg.lo[1]).at[1].set(seg.lo[0]))


def _seeded(kind):
    """(JAX call, port call, message pattern) of one seeded violation."""
    if kind == "dirty_tail":
        bad = with_layer0(small_hier(),
                          val=small_hier().layers[0].val.at[-1].set(99.0))
        return (lambda: jcon.validate_hier(bad, JSR),
                lambda: tcon.validate_hier(tp.to_torch(bad), TSR),
                "sentinel-tail violation in hier layer 0: slots")
    if kind == "unsorted_prefix":
        bad = _swap01(make_seg())
        return (lambda: jcon.validate_segment(bad, JSR, sorted=True),
                lambda: tcon.validate_segment(to_port_seg(bad), TSR,
                                              sorted=True),
                "canonical-form violation in segment: entries")
    if kind == "sentinel_in_prefix":
        seg = make_seg()
        bad = dataclasses.replace(
            seg, hi=seg.hi.at[0].set(jassoc.SENTINEL),
            lo=seg.lo.at[0].set(jassoc.SENTINEL))
        return (lambda: jcon.validate_segment(bad, JSR, sorted=True),
                lambda: tcon.validate_segment(to_port_seg(bad), TSR,
                                              sorted=True),
                "canonical-form violation in segment: SENTINEL key")
    if kind == "nnz_bound":
        bad = dataclasses.replace(make_seg(cap=16), nnz=jnp.int32(17))
        return (lambda: jcon.validate_segment(bad, JSR, sorted=False),
                lambda: tcon.validate_segment(to_port_seg(bad), TSR,
                                              sorted=False),
                "nnz bound violation in segment")
    if kind == "counter_carry":
        bad = dataclasses.replace(small_hier(), n_updates_hi=jnp.int32(-1))
        return (lambda: jcon.validate_hier(bad, JSR),
                lambda: tcon.validate_hier(tp.to_torch(bad), TSR),
                "counter carry violation in hier: high word negative")
    if kind == "counter_consistency":
        bad = dataclasses.replace(small_hier(), n_updates=jnp.uint32(0),
                                  n_updates_hi=jnp.int32(0))
        return (lambda: jcon.validate_hier(bad, JSR),
                lambda: tcon.validate_hier(tp.to_torch(bad), TSR),
                "counter consistency violation in hier: live slots exceed")

    def jplan():
        err, _ = jcon.checkified(lambda d: jcon.check_plan(d, (16, 64)))(
            jnp.array([0, 2], jnp.int32))
        jcon.throw(err)
    return (jplan,
            lambda: tcon.check_plan(torch.tensor([0, 2]), (16, 64)),
            r"spill-plan bound violation in plan: planned depth outside "
            r"\[0, 2\)")


@pytest.mark.parametrize("kind", [
    "dirty_tail", "unsorted_prefix", "sentinel_in_prefix", "nnz_bound",
    "counter_carry", "counter_consistency", "plan_bound"])
def test_seeded_violation_fires_with_reference_message(kind):
    jcall, tcall, pattern = _seeded(kind)
    with pytest.raises(ValueError, match=pattern):
        jcall()
    with pytest.raises(tcon.ContractViolation, match=pattern):
        tcall()


def test_clean_states_pass_and_raw_contract_allows_disorder():
    """A clean hierarchy passes both packages; the raw-buffer contract
    makes no ordering claim, so an unsorted prefix passes it; a counter
    of another dtype than int64 is a hard error."""
    h = small_hier()
    jcon.validate_hier(h, JSR)
    tcon.validate_hier(tp.to_torch(h), TSR)
    tcon.check_hier(tp.to_torch(h), TSR, l0_sorted=True)
    tcon.validate_segment(to_port_seg(_swap01(make_seg())), TSR,
                          sorted=False)
    bad = dataclasses.replace(tp.to_torch(h),
                              n_updates=torch.zeros((), dtype=torch.int32))
    with pytest.raises(TypeError, match="counter word dtype violation"):
        tcon.validate_hier(bad, TSR)
    assert not tcon.enabled() and tcon.enabled(True)


def test_merge_many_deep_check_names_the_run():
    """``merge_many(debug=True)`` checks every input run's canonical form
    before merging, as the reference's deep check does."""
    seg = to_port_seg(_swap01(make_seg()))
    blk = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(tcon.ContractViolation,
                       match="canonical-form violation in merge_many input "
                       "run 0"):
        tassoc.merge_many((seg,), blk, blk, torch.ones(4), out_capacity=32,
                          debug=True)
    out, _ = tassoc.merge_many((to_port_seg(make_seg()),), blk, blk,
                               torch.ones(4), out_capacity=32, debug=True)
    assert int(out.nnz) == 6


def test_update_front_door_fires_on_corrupt_input(monkeypatch):
    h = small_hier()
    bad = tp.to_torch(with_layer0(h, val=h.layers[0].val.at[-1].set(99.0)))
    monkeypatch.setenv("REPRO_CHECK", "1")
    idx = torch.arange(8, dtype=torch.int32)
    with pytest.raises(tcon.ContractViolation,
                       match="sentinel-tail violation in hier.update input"):
        thier.update(bad, idx, idx, torch.ones(8))
    with pytest.raises(tcon.ContractViolation,
                       match="sentinel-tail violation in query.engine"
                       ".point_lookup input"):
        tengine.point_lookup(bad, idx, idx)


def _fleet(I=3, cuts=(16, 64, 256), block=8):
    return tdist.create_instances(I, cuts, block, device="cpu")


def _stream(I=3, T=10, B=8):
    return tuple(map(torch.from_numpy, tp.stream(5, (I, T, B), 40)))


def _front_doors():
    """Every checked front door on a small state, each returning a state
    or a tensor; run once with the knob off and once on."""
    rows, cols, vals = _stream()
    out = {}
    for lazy, uk in ((True, True), (False, False)):
        fleet, _ = tstream.ingest_instances(_fleet(), rows, cols, vals,
                                            lazy_l0=lazy, use_kernel=uk)
        out[f"ingest_instances lazy{lazy}"] = fleet
        out[f"update_instances lazy{lazy}"] = tstream.update_instances(
            fleet, rows[:, 0], cols[:, 0], vals[:, 0], lazy_l0=lazy,
            use_kernel=uk)
        one = tstream.instance(fleet, 1)
        out[f"update lazy{lazy}"] = thier.update(
            one, rows[1, 0], cols[1, 0], vals[1, 0], lazy_l0=lazy,
            use_kernel=uk)
        out[f"flush lazy{lazy}"] = thier.flush(one, lazy_l0=lazy,
                                               use_kernel=uk)
        for mode in ("scan", "canon"):
            out[f"point_lookup lazy{lazy} {mode}"] = tengine.point_lookup(
                fleet, rows[:, 0], cols[:, 0], use_kernel=uk, l0_mode=mode)
    layered, _ = tstream.ingest_instances(_fleet(), rows, cols, vals,
                                          fused=False)
    out["ingest_instances layered"] = layered
    return out


def _as_numpy(x):
    if isinstance(x, torch.Tensor):
        return {"": x.numpy()}
    return thier.state_to_numpy(x)


def test_checked_front_doors_match_unchecked(monkeypatch):
    """``REPRO_CHECK=1`` changes no result: every front door returns the
    same state or answer, leaf for leaf, with the checks on and off — and
    the checks ran."""
    off = _front_doors()
    calls = []
    real = tcon._raise_first
    monkeypatch.setattr(tcon, "_raise_first",
                        lambda flags: calls.append(len(flags)) or real(flags))
    monkeypatch.setenv("REPRO_CHECK", "1")
    on = _front_doors()
    assert len(calls) > 50
    assert off.keys() == on.keys()
    for k in off:
        a, b = _as_numpy(off[k]), _as_numpy(on[k])
        for leaf in a:
            np.testing.assert_array_equal(np.asarray(a[leaf]),
                                          np.asarray(b[leaf]),
                                          err_msg=f"{k} {leaf}")


def test_knob_off_runs_no_check(monkeypatch):
    """With ``REPRO_CHECK`` unset the front doors call no check: no device
    reduction and no host read come from the sanitizer."""
    calls = []
    for name in ("_raise_first", "check_hier", "check_canonical",
                 "check_counter", "check_plan", "validate_restored"):
        monkeypatch.setattr(tcon, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    _front_doors()
    assert calls == []
    monkeypatch.setenv("REPRO_CHECK", "0")
    _front_doors()
    assert calls == []


def test_checked_ingest_validates_the_plan(monkeypatch):
    """Every grouped step of a checked ingest bound-checks its planned
    depths: a plan past the hierarchy's depth is refused by name."""
    rows, cols, vals = _stream(T=4)
    monkeypatch.setenv("REPRO_CHECK", "1")
    plans = []
    real = tcon.check_plan
    monkeypatch.setattr(tcon, "check_plan",
                        lambda d, c, name: plans.append(name) or
                        real(d, c, name))
    tstream.ingest_instances(_fleet(), rows, cols, vals, lazy_l0=True)
    assert plans == ["stream.update_instances"] * 4
    monkeypatch.setattr(thier, "_plan_spill_depth",
                        lambda h, n: torch.full_like(h.layers[0].nnz, 3))
    with pytest.raises(tcon.ContractViolation,
                       match="spill-plan bound violation in "
                       "stream.update_instances"):
        tstream.ingest_instances(_fleet(), rows, cols, vals, lazy_l0=True)


# -------------------------------------------------------- ckpt.restore --

def _corrupt_saved_leaf(step_dir, suffix, value):
    with open(step_dir / "manifest.json") as f:
        man = json.load(f)
    leaf = next(l for l in man["leaves"] if l["path"].endswith(suffix))
    p = step_dir / leaf["file"]
    a = np.load(p)
    a[-1] = value
    np.save(p, a)


def test_restore_clean_passes_under_check(tmp_path, monkeypatch):
    h = tp.to_torch(small_hier())
    tckpt.save(str(tmp_path), 1, h)
    monkeypatch.setenv("REPRO_CHECK", "1")
    out = tckpt.restore(str(tmp_path), 1, h)
    assert torch.equal(out.layers[0].val, h.layers[0].val)


def test_restore_corrupt_checkpoint_names_invariant(tmp_path, monkeypatch):
    h = tp.to_torch(small_hier())
    tckpt.save(str(tmp_path), 1, h)
    _corrupt_saved_leaf(tmp_path / "step_1", "val", 123.0)
    monkeypatch.setenv("REPRO_CHECK", "1")
    with pytest.raises(tcon.ContractViolation,
                       match="sentinel-tail violation in restore step_1 "
                       "layer 0"):
        tckpt.restore(str(tmp_path), 1, h)
    # knob off: the corrupt restore is NOT validated (zero-cost default)
    monkeypatch.delenv("REPRO_CHECK")
    tckpt.restore(str(tmp_path), 1, h)


def test_restore_unsorted_layer_names_invariant(tmp_path, monkeypatch):
    """A deeper layer restored out of order fails the checked restore by
    name (deeper layers are always held to canonical form)."""
    h = thier.flush(tp.to_torch(small_hier()))
    tckpt.save(str(tmp_path), 2, h)
    with open(tmp_path / "step_2" / "manifest.json") as f:
        man = json.load(f)
    for suffix in (".layers/1/.hi", ".layers/1/.lo"):
        leaf = next(l for l in man["leaves"] if l["path"] == suffix)
        p = tmp_path / "step_2" / leaf["file"]
        a = np.load(p)
        a[[0, 1]] = a[[1, 0]]
        np.save(p, a)
    monkeypatch.setenv("REPRO_CHECK", "1")
    with pytest.raises(tcon.ContractViolation,
                       match="canonical-form violation in restore step_2 "
                       "layer 1"):
        tckpt.restore(str(tmp_path), 2, h)


def test_restore_migrated_leaf_validated(tmp_path, monkeypatch):
    h = tp.to_torch(small_hier())
    tckpt.save(str(tmp_path), 3, h)
    mpath = tmp_path / "step_3" / "manifest.json"
    man = json.loads(mpath.read_text())
    man["leaves"] = [l for l in man["leaves"]
                     if not l["path"].endswith("n_updates_hi")]
    mpath.write_text(json.dumps(man))
    monkeypatch.setenv("REPRO_CHECK", "1")
    with pytest.warns(UserWarning, match="migrating old checkpoint"):
        tckpt.restore(str(tmp_path), 3, h)           # clean template: ok
    bad_tmpl = dataclasses.replace(h, n_updates=torch.tensor(-(1 << 32)))
    with pytest.warns(UserWarning, match="migrating old checkpoint"):
        with pytest.raises(tcon.ContractViolation,
                           match="counter carry violation"):
            tckpt.restore(str(tmp_path), 3, bad_tmpl)


# ------------------------------------------- a HierVec restored (REPRO_CHECK) --

VEC_CLAUSES = {
    "nnz": "nnz bound violation",
    "tail": "sentinel-tail violation",
    "padding": "padding violation",
    "sentinel": "SENTINEL key inside the live prefix",
    "order": "not sorted-unique",
}


def _vec_contract(d) -> list:
    """The clauses of ``core/vassoc.py``'s contract one layer breaks,
    checked on a dict of its numpy arrays apart from the port's code:
    nnz in [0, C], SENTINEL keys and zero payload rows in [nnz, C), no
    SENTINEL key and strictly increasing keys in [0, nnz)."""
    key, val, nnz = d["key"], d["val"], int(d["nnz"])
    bad = []
    if not 0 <= nnz <= key.shape[0]:
        bad.append("nnz")
        nnz = min(max(nnz, 0), key.shape[0])
    if (key[nnz:] != tassoc.SENTINEL).any():
        bad.append("tail")
    if (val[nnz:] != 0).any():
        bad.append("padding")
    if (key[:nnz] == tassoc.SENTINEL).any():
        bad.append("sentinel")
    if (np.diff(key[:nnz].astype(np.int64)) <= 0).any():
        bad.append("order")
    return bad


def _hier_embed_state():
    """DCN-v2's smoke config, its hier embedding state after enough
    gradient blocks that every layer holds entries."""
    from repro_torch.configs import registry as tcfg
    from repro_torch.core import vassoc
    from repro_torch.models import dcn as tdcn
    cfg = tcfg.get_smoke_config("dcn-v2")
    state = tdcn.hier_embed_init(cfg, 2, (16, 64, 256), device="cpu")
    h = state.hier
    block = h.layers[0].capacity - h.cuts[0]
    rng = np.random.default_rng(0)
    for _ in range(11):          # layers end at nnz 12, 46 and 67
        keys = torch.as_tensor(rng.integers(0, 400, block).astype(np.int32))
        vals = torch.as_tensor(rng.normal(size=(block, cfg.embed_dim))
                               .astype(np.float32))
        h = vassoc.update(h, keys, vals)
    assert all(int(l.nnz) > 1 for l in h.layers)
    return dataclasses.replace(state, hier=h)


def _layers_np(h):
    return [dict(key=l.key.numpy(), val=l.val.numpy(), nnz=l.nnz.numpy())
            for l in h.layers]


def test_restore_hier_embed_state_under_check(tmp_path, monkeypatch):
    """A training state with a ``HierVec`` restores under REPRO_CHECK=1
    (the reference's duck typing took it for a HierAssoc), every leaf
    equal, and the dict-based check agrees that each layer is clean."""
    tree = dict(hier=_hier_embed_state())
    assert all(_vec_contract(d) == [] for d in _layers_np(tree["hier"].hier))
    tckpt.save(str(tmp_path), 1, tree)
    monkeypatch.setenv("REPRO_CHECK", "1")
    out = tckpt.restore(str(tmp_path), 1, tree)
    for a, b in zip(out["hier"].hier.layers, tree["hier"].hier.layers):
        assert torch.equal(a.key, b.key) and torch.equal(a.val, b.val)
        assert torch.equal(a.nnz, b.nnz)
    tcon.validate_restored(out)


def _seed_vec(seg, clause):
    key, val, nnz = seg.key.clone(), seg.val.clone(), seg.nnz.clone()
    n = int(nnz)
    if clause == "nnz":
        nnz = torch.tensor(key.shape[0] + 1, dtype=torch.int32)
    elif clause == "tail":
        key[n] = 5
    elif clause == "padding":
        val[n, 0] = 1.0
    elif clause == "sentinel":
        key[n - 1] = tassoc.SENTINEL
    else:
        key[[0, 1]] = key[[1, 0]]
    return dataclasses.replace(seg, key=key, val=val, nnz=nnz)


@pytest.mark.parametrize("clause", sorted(VEC_CLAUSES))
def test_seeded_hiervec_violation_is_refused(clause, tmp_path, monkeypatch):
    """Each clause of the HierVec contract, broken in one layer of a saved
    training state, refuses the checked restore by name; the dict-based
    check names the same clause."""
    state = _hier_embed_state()
    h = state.hier
    layers = list(h.layers)
    layers[1] = _seed_vec(layers[1], clause)
    bad = dict(hier=dataclasses.replace(
        state, hier=dataclasses.replace(h, layers=tuple(layers))))
    assert clause in _vec_contract(_layers_np(bad["hier"].hier)[1])
    tckpt.save(str(tmp_path), 2, bad)
    monkeypatch.setenv("REPRO_CHECK", "1")
    with pytest.raises(tcon.ContractViolation,
                       match=VEC_CLAUSES[clause]) as err:
        tckpt.restore(str(tmp_path), 2, dict(hier=state))
    assert "restore step_2.hier.hier layer 1" in str(err.value)
    with pytest.raises(tcon.ContractViolation, match=VEC_CLAUSES[clause]):
        tcon.validate_restored(bad)
    with pytest.raises(tcon.ContractViolation,
                       match=r"hiervec layer 1"):
        tcon.check_hiervec(bad["hier"].hier)
