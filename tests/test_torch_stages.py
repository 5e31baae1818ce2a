"""Port parity of the ``stages`` front door: ``repro_torch.stages`` against
``repro.stages`` on the CPU, where every entry dispatches eagerly.

Covered: ``signature_of`` (each ``None`` knob, a ``D4MConfig``, every
invalid combination with the reference's message, and the same message
at every entry point); ``wrap`` memoized with the reference's counter
deltas; the ``stats()`` keys; ``fleet_jobs``' entry names; the launch
acceptance (``precompile_fleet``, then a ``launch/ingest`` and a
``launch/query`` run with 0 compiles and 0 lowerings); the ``dispatch``
records read by the reference's monitor; the gauge names;
``contracts.debug_signature`` keying a separate entry; ``_step_sig``;
the cache directory; a ``"graph"`` entry on the CPU; the introspection
under the reference's names and keys (``abstract_args``,
``compiled_for``, ``cost_of`` on clones, ``audit``,
``Compiled.cost_analysis`` / ``as_text`` / ``memory_analysis``); and the
decode step
with a 0-d tensor ``cache_len``, at and past ``max_len``, against the
host-int decode and the reference (rtol 1e-4 / atol 1e-5, float sums in
another order).
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import stages as jstages
from repro.analysis import contracts as jcontracts
from repro.configs import d4m_stream as jd4m
from repro.configs import registry as jcfg
from repro.core import hier as jhier
from repro.launch import train as jtrain
from repro.models import transformer as jtf
from repro.obs import metrics as jmetrics
from repro_torch import stages
from repro_torch.analysis import contracts
from repro_torch.configs import d4m_stream as td4m
from repro_torch.configs import registry as tcfg
from repro_torch.core import distributed as tdist
from repro_torch.core import hier as thier
from repro_torch.core import semiring as tsr
from repro_torch.core import stream as tstream
from repro_torch.kernels import build
from repro_torch.launch import ingest as tingest
from repro_torch.launch import query as tquery
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttf
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.query import service as tservice

import torch_parity as tp

ROOT = Path(__file__).resolve().parents[1]
DECODE = dict(rtol=1e-4, atol=1e-5)
DELTA_KEYS = ("lowerings", "compiles", "memory_hits", "dispatches",
              "disk_hits", "disk_writes")


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def _fields(sig) -> dict:
    return dataclasses.asdict(sig)


# ----------------------------------------------------------- signatures -----

KNOBS = ("cuts", "block_size", "dtype", "sr", "fused", "lazy_l0",
         "use_kernel", "chunk", "batch_mode", "mesh", "data_axes",
         "l0_mode")


@pytest.mark.parametrize("knob", KNOBS)
def test_none_knob_reads_as_the_reference(knob):
    """An explicit ``None`` is "the default", as in the reference:
    ``fused=None`` is True, ``dtype=None`` float32, ``chunk=None`` 1."""
    assert _fields(stages.signature_of(**{knob: None})) == \
        _fields(jstages.signature_of(**{knob: None}))


def test_none_knob_values():
    sig = stages.signature_of(fused=None, dtype=None, chunk=None)
    assert (sig.fused, sig.dtype, sig.chunk) == (True, "float32", 1)


@pytest.mark.parametrize("which", ["config", "smoke_config"])
def test_signature_of_a_d4m_config(which):
    """Positional ``cfg``: its fields are read, keywords win."""
    tc, jc = getattr(td4m, which)(), getattr(jd4m, which)()
    assert _fields(stages.signature_of(tc)) == \
        _fields(jstages.signature_of(jc))
    over = dict(chunk=3, l0_mode="canon", fused=False, dtype="bfloat16")
    assert _fields(stages.signature_of(tc, **over)) == \
        _fields(jstages.signature_of(jc, **over))


INVALID = [
    dict(cuts=(64, 16)), dict(cuts=(0, 16)), dict(cuts=()),
    dict(cuts="ab"), dict(block_size=0), dict(sr="no.such.semiring"),
    dict(dtype="no_such_dtype"), dict(chunk=0), dict(chunk=1.5),
    dict(batch_mode="nope"), dict(lazy_l0=True, sr="max.plus"),
    dict(l0_mode="nope"),
    dict(batch_mode="grouped", allowed_batch_modes=("switch",)),
]


@pytest.mark.parametrize("kw", INVALID, ids=repr)
def test_invalid_signatures_match_the_reference(kw):
    with pytest.raises(ValueError) as want:
        jstages.signature_of(**kw)
    with pytest.raises(ValueError) as got:
        stages.signature_of(**kw)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("invalid d4m config signature: ")


def test_one_message_at_every_entry_point():
    """``lazy_l0`` outside plus.times fails alike at ``stream.ingest_jit``,
    ``hier.update``, ``stream.update_instances`` and
    ``service.make_ingest_fn``."""
    bad = dict(sr=tsr.get("max.plus"), lazy_l0=True)
    h = thier.create((16, 64), 8, device="cpu")
    states = tdist.create_instances(2, (16, 64), 8, device="cpu")
    blk = torch.zeros(8, dtype=torch.int32)
    calls = [
        lambda: tstream.ingest_jit((16, 64), 8, **bad),
        lambda: thier.update(h, blk, blk, blk.float(), **bad),
        lambda: tstream.update_instances(states, blk.expand(2, 8),
                                         blk.expand(2, 8),
                                         blk.float().expand(2, 8), **bad),
        lambda: tservice.make_ingest_fn(**bad),
    ]
    msgs = set()
    for call in calls:
        with pytest.raises(ValueError) as e:
            call()
        msgs.add(str(e.value))
    assert msgs == {"invalid d4m config signature: lazy_l0 requires the "
                    "plus.times semiring, got 'max.plus'"}


# ----------------------------------------------------------- the cache ------

def _deltas(mod, fn, x, entry):
    sig = mod.signature_of(extra=(("case", entry),))
    w = mod.wrap(fn, entry, sig)
    assert mod.wrap(fn, entry, sig) is w
    s0 = mod.stats()
    w(x)
    s1 = mod.stats()
    w(x)
    s2 = mod.stats()
    return [{k: b[k] - a[k] for k in DELTA_KEYS} for a, b in
            ((s0, s1), (s1, s2))], w


def test_wrap_is_memoized_with_the_reference_counters():
    """The first dispatch lowers and compiles once; the second is a memory
    hit — the same deltas as the reference's."""
    want, _ = _deltas(jstages, lambda x: x * 2, jnp.arange(4.0),
                      "test.stages.memo")
    got, w = _deltas(stages, lambda x: x * 2, torch.arange(4.0),
                     "test.stages.memo")
    assert got == want
    assert want[0]["compiles"] == 1 and want[1]["memory_hits"] == 1
    # another shape is another key
    s0 = stages.stats()
    w(torch.arange(5.0))
    assert stages.stats()["compiles"] == s0["compiles"] + 1


def test_dispatch_builds_once():
    made = []

    def make():
        made.append(1)
        return lambda x: x + 1
    sig = stages.signature_of(extra=(("case", "dispatch"),))
    for _ in range(3):
        out = stages.dispatch("test.stages.dispatch", sig, make,
                              torch.ones(2))
    assert len(made) == 1 and torch.equal(out, torch.full((2,), 2.0))


def test_stats_keys_are_the_references():
    assert set(stages.stats()) == set(jstages.stats()) | {"captures"}
    s = stages.stats(reset=True)
    assert isinstance(s["per_entry"], dict)
    after = stages.stats()
    assert all(after[k] == 0 for k in DELTA_KEYS + ("captures",))
    assert after["per_entry"] == {}


def test_graph_entry_is_eager_on_the_cpu():
    """A ``"graph"`` entry called with CPU tensors runs its function: one
    compile, no capture, steady after one dispatch."""
    w = stages.wrap(lambda x: x + 1, "test.stages.graph",
                    stages.signature_of(extra=(("case", "graph"),)),
                    kind="graph")
    x = torch.zeros(3)
    assert w.is_steady(x)
    s0 = stages.stats()
    assert torch.equal(w.steady(x), torch.ones(3))
    s1 = stages.stats()
    assert s1["dispatches"] - s0["dispatches"] == 1
    assert s1["captures"] == s0["captures"]
    assert w.last.last_kind == "eager" and w.last.steady()
    w.release()
    with pytest.raises(ValueError, match="kind must be one of"):
        stages.Wrapped(lambda x: x, "e", stages.Signature(), kind="jit")


def test_cache_dir_moves_the_kernel_builds(tmp_path, monkeypatch):
    """``set_cache_dir`` points the kernel libraries at ``<dir>/build``;
    a build pass that finds them current counts ``disk_hits``."""
    try:
        stages.set_cache_dir(str(tmp_path))
        assert stages.cache_dir() == str(tmp_path)
        assert build.BUILD_DIR == tmp_path / "build"
        monkeypatch.setattr(build, "_stale", lambda s: False)
        s0 = stages.stats()
        build.build_all()
        s1 = stages.stats()
        assert s1["disk_hits"] - s0["disk_hits"] == len(
            build.registry.AUDITED_FILES)
        assert s1["disk_writes"] == s0["disk_writes"]
    finally:
        stages.set_cache_dir(None)
    assert stages.cache_dir() is None
    assert build.BUILD_DIR == build.DEFAULT_BUILD_DIR


def test_cache_dir_from_the_environment(tmp_path):
    code = ("from repro_torch import stages\n"
            "from repro_torch.kernels import build\n"
            "print(stages.cache_dir()); print(build.BUILD_DIR)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_STAGES_CACHE_DIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(tmp_path), str(tmp_path / "build")]


# ----------------------------------------------------------- fleet jobs -----

@pytest.mark.parametrize("analytics", [0, 1024])
def test_fleet_job_names_are_the_references(analytics):
    tc, jc = td4m.smoke_config(), jd4m.smoke_config()
    got = stages.fleet_jobs(tc, analytics_num_rows=analytics, device="cpu")
    want = jstages.fleet_jobs(jc, analytics_num_rows=analytics)
    assert [e for e, _, _ in got] == [e for e, _, _ in want]
    assert [w.entry for _, w, _ in got] == [w.entry for _, w, _ in want]
    for entry, w, _ in got:
        assert w.kind == ("graph" if entry == "service.point_query"
                          else "eager")
    assert stages.kernel_jobs()


def test_precompile_fleet_then_launch_zero_compiles():
    """The reference's launch acceptance: ``precompile_fleet`` at the CLIs'
    shapes, then a ``launch/ingest`` and a ``launch/query`` run make no
    lowering and no compile, and hit the memory cache."""
    I, blocks, B, rounds, scale = 2, 8, 16, 4, 8
    cuts = (32, 128, 512)
    queries, top_k = 16, 4
    sig = stages.signature_of(cuts=cuts, block_size=B, fused=True,
                              lazy_l0=True, chunk=1, batch_mode="grouped",
                              l0_mode="auto")
    report = stages.precompile_fleet(
        sig, instances=I, blocks=blocks // rounds, queries=queries,
        analytics_num_rows=1 << scale, analytics_k=top_k, device="cpu")
    assert set(report) >= {"stream.ingest_instances", "service.ingest",
                           "service.point_query", "service.analytics",
                           "hier.update", "hier.flush", "hier.query_all",
                           "query.engine.point_lookup"}
    assert set(report.values()) <= {"compiled", "cached"}
    again = stages.precompile_fleet(
        sig, instances=I, blocks=blocks // rounds, queries=queries,
        analytics_num_rows=1 << scale, analytics_k=top_k, device="cpu")
    assert set(again.values()) == {"cached"}

    stages.reset_stats()
    common = ["--instances", str(I), "--blocks", str(blocks),
              "--block-size", str(B), "--rounds", str(rounds),
              "--cuts", ",".join(map(str, cuts)), "--scale", str(scale),
              "--device", "cpu"]
    out_i = tingest.run(tingest.parser().parse_args(common))
    assert out_i["total_updates"] == I * blocks * B
    out_q = tquery.run(tquery.parser().parse_args(
        common + ["--queries", str(queries), "--top-k", str(top_k)]))
    assert out_q["updates_per_s"] > 0
    s = stages.stats()
    assert s["compiles"] == 0, s
    assert s["lowerings"] == 0, s
    assert s["memory_hits"] > 0 and s["captures"] == 0, s


# ----------------------------------------------------------- observability --

def test_dispatch_records_read_by_the_reference_monitor(tmp_path):
    """``--obs`` writes one ``dispatch`` record per dispatch, with the
    reference's fields and the port's ``kind``; the reference's monitor,
    as its own command, counts them per entry."""
    d = str(tmp_path / "obs")
    stages.reset_stats()
    args = tingest.parser().parse_args([
        "--instances", "2", "--blocks", "8", "--block-size", "16",
        "--rounds", "4", "--cuts", "32,128,512", "--scale", "8",
        "--obs", "--obs-dir", d, "--device", "cpu"])
    try:
        tingest.run(args)
    finally:
        ttrace.disable()
    n = stages.stats()["dispatches"]
    recs = [json.loads(line) for line in
            (Path(d) / "obs.jsonl").read_text().splitlines()]
    disp = [r for r in recs if r["ev"] == "dispatch"]
    assert len(disp) == n > 0
    for r in disp:
        assert {"entry", "sig", "wall_s", "compile_s", "prov",
                "kind"} <= set(r)
        assert r["prov"] in ("compile", "memory") and r["kind"] == "eager"
    summary, port_summary = tp.monitor_summaries(d, tmp_path)
    assert port_summary == summary
    assert summary["malformed_records"] == 0
    per = {}
    for r in disp:
        per[r["entry"]] = per.get(r["entry"], 0) + 1
    assert {e: v["count"] for e, v in summary["dispatch"].items()} == per
    gauges = tmetrics.REGISTRY.snapshot()["gauges"]
    assert gauges["stages.dispatches"] >= n - 1


def _small_hier_run(hier_mod, to_arr):
    rows, cols, vals = tp.stream(5, (2, 8), 40)
    h = hier_mod.create((16, 64), 8) if to_arr is jnp.asarray else \
        hier_mod.create((16, 64), 8, device="cpu")
    for t in range(2):
        h = hier_mod.update(h, to_arr(rows[t]), to_arr(cols[t]),
                            to_arr(vals[t]))
    return hier_mod.flush(h)


def test_gauge_names_are_the_references():
    """After the same dispatches in both packages the exported gauge names
    agree, the port adding ``stages.captures``."""
    def names(stages_mod, metrics_mod, hier_mod, to_arr):
        stages_mod.reset_stats()
        _small_hier_run(hier_mod, to_arr)
        reg = metrics_mod.Registry()
        metrics_mod.export_stages_gauges(reg)
        return set(reg.snapshot()["gauges"])
    want = names(jstages, jmetrics, jhier, jnp.asarray)
    got = names(stages, tmetrics, thier, torch.from_numpy)
    assert got == want | {"stages.captures"}
    assert "stages.entry.hier.update.dispatches" in got


def test_debug_signature_keys_its_own_entry(monkeypatch):
    """Under ``REPRO_CHECK=1`` a front door dispatches its checked build
    under the signature's ``DEBUG_EXTRA`` twin — a separate key, always
    eager — as the reference does; off, the production key."""
    sig = stages.signature_of(cuts=(16, 64), block_size=8)
    twin = contracts.debug_signature(sig)
    assert contracts.sig_debug(twin) and not contracts.sig_debug(sig)
    assert contracts.debug_signature(twin) == twin
    assert twin.extra == tuple(jcontracts.DEBUG_EXTRA)
    assert contracts.DEBUG_EXTRA == jcontracts.DEBUG_EXTRA

    def debug_entries(stages_mod, hier_mod, to_arr, sig_debug):
        before = set(stages_mod.lowered_keys())
        _small_hier_run(hier_mod, to_arr)
        return sorted((k[0], sig_debug(k[1])) for k in
                      set(stages_mod.lowered_keys()) - before
                      if k[0].startswith("hier."))
    for on in ("0", "1"):
        monkeypatch.setenv("REPRO_CHECK", on)
        jstages.clear_memory_cache()
        stages.clear_memory_cache()
        want = debug_entries(jstages, jhier, jnp.asarray,
                             jcontracts.sig_debug)
        got = debug_entries(stages, thier, torch.from_numpy,
                            contracts.sig_debug)
        assert got == want and got
        assert all(d == (on == "1") for _, d in got)
    w = thier.update_wrapped(twin)
    assert w.kind == "eager" and w.sig == twin


# ------------------------------------------------------------- launchers ----

@pytest.mark.parametrize("extra", [{}, dict(compress="int8"),
                                   dict(hier_embed=True)])
def test_step_sig_is_the_references(extra):
    args = argparse.Namespace(arch="smollm-360m", smoke=True, lr=3e-4)
    assert _fields(ttrain._step_sig(args, **extra)) == \
        _fields(jtrain._step_sig(args, **extra))


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-236b"])
def test_decode_with_a_tensor_cache_len(arch):
    """A 0-d int32 ``cache_len`` decodes as the host int does, bit for
    bit, at ``max_len - 1``, ``max_len`` and past it (the write clamped
    to the last slot), and as the reference does."""
    cfg = jcfg.get_smoke_config(arch)
    tcf = tcfg.get_smoke_config(arch)
    jp = jtf.init(jax.random.PRNGKey(0), cfg)
    params = ttf.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 6)
                                             ).astype(np.int32)
    max_len = 8
    _, jc, _ = jtf.prefill(jp, jnp.asarray(toks), cfg, max_len=max_len)
    _, tc, _ = ttf.prefill(params, torch.from_numpy(toks), tcf,
                           max_len=max_len)
    tc2 = {k: v.clone() for k, v in tc.items()}
    tok = toks[:, -1:]
    for n in (max_len - 1, max_len, max_len + 2):
        jl, jc = jtf.decode_step(jp, jnp.asarray(tok), jc, n, cfg)
        il, tc = ttf.decode_step(params, torch.from_numpy(tok), tc, n, tcf)
        tl, tc2 = ttf.decode_step(params, torch.from_numpy(tok), tc2,
                                  torch.tensor(n, dtype=torch.int32), tcf)
        assert torch.equal(tl, il)
        for k in tc:
            assert torch.equal(tc2[k], tc[k]), k
            np.testing.assert_allclose(tc2[k].numpy(), np.asarray(jc[k]),
                                       err_msg=f"{k} at {n}", **DECODE)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"logits at {n}", **DECODE)


# -------------------------------------------------------- introspection -----

MEMORY_ATTRS = ("argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "alias_size_in_bytes",
                "generated_code_size_in_bytes")


def _small_update():
    sig = stages.signature_of(cuts=(16, 64), block_size=8,
                              batch_mode="switch",
                              extra=(("case", "introspection"),))
    h = thier.create((16, 64), 8, torch.float32, tsr.PLUS_TIMES,
                     device="cpu")
    g = np.random.default_rng(0)
    block = tuple(torch.as_tensor(g.integers(0, 50, 8).astype(np.int32))
                  for _ in range(2)) + (torch.ones(8),)
    return thier.update_wrapped(sig), (h,) + block + (None,)


def test_introspection_has_the_references_names():
    for name in ("abstract_args", "compiled_for", "cost_of", "audit"):
        assert callable(getattr(stages, name))
        assert callable(getattr(jstages, name))
    for name in ("cost_analysis", "as_text", "memory_analysis"):
        assert callable(getattr(stages.Compiled, name))
        assert callable(getattr(jstages.Compiled, name))


def test_abstract_args_rebuilds_the_key():
    w, args = _small_update()
    key = w._key(args)
    rebuilt = stages.abstract_args(key)
    assert w._key(rebuilt) == key
    assert isinstance(rebuilt[0], thier.HierAssoc)
    assert rebuilt[0].cuts == (16, 64)
    leaves = stages.tree_leaves(rebuilt)
    assert leaves and all(isinstance(x, stages.Abstract) for x in leaves)
    assert rebuilt[4] is None


def test_cost_of_has_the_references_keys_and_leaves_state_unchanged():
    w = stages.wrap(lambda x: x.add_(1), "test.stages.inplace",
                    stages.signature_of(extra=(("case", "inplace"),)),
                    donate_argnums=(0,))
    x = torch.arange(8, dtype=torch.float32)
    before = x.clone()
    cost = stages.cost_of(w, x)
    assert torch.equal(x, before)
    jw = jstages.wrap(lambda v: v + 1, "test.stages.jcost",
                      jstages.signature_of(extra=(("case", "jcost"),)))
    assert set(cost) == set(jstages.cost_of(jw, jnp.zeros(8))) == \
        {"flops", "bytes_accessed", "peak_bytes"}
    # one add an element, as XLA counts the reference's ``v + 1``
    assert cost["flops"] == jstages.cost_of(jw, jnp.zeros(8))["flops"] == 8
    assert cost["bytes_accessed"] == 64
    # a fleet entry: the state passed in is the state after
    uw, args = _small_update()
    snap = [t.clone() for t in stages.tree_leaves(args)]
    c2 = stages.cost_of(uw, *args)
    assert c2["bytes_accessed"] > 0 and c2["peak_bytes"] > 0
    assert all(torch.equal(a, b)
               for a, b in zip(stages.tree_leaves(args), snap))


def test_compiled_introspection():
    w, args = _small_update()
    comp = stages.compiled_for(w, *args)
    w(*args)
    assert w.last is comp
    cost = comp.cost_analysis()          # recorded on zeros of the key
    assert {"flops", "bytes accessed"} <= set(cost)
    jcomp = jstages.compiled_for(
        jstages.wrap(lambda v: v * 2, "test.stages.jintro",
                     jstages.signature_of(extra=(("case", "jintro"),))),
        jnp.zeros(4))
    assert {"flops", "bytes accessed"} <= set(jcomp.cost_analysis())
    jmem = jcomp.memory_analysis()
    mem = comp.memory_analysis()
    for name in MEMORY_ATTRS:
        assert hasattr(jmem, name)
        assert getattr(mem, name) >= 0
    assert mem.argument_size_in_bytes > 0 and mem.temp_size_in_bytes > 0
    text = comp.as_text()
    assert text.startswith("# entry hier.update kind eager")
    assert "aten." in text and "host_read item" in text
    # a graph entry's text names the kernels a replay launches
    qs = tservice.make_point_query_fn()
    states = tdist.create_instances(2, (16, 64), 8, torch.float32,
                                    tsr.PLUS_TIMES, device="cpu")
    q = torch.arange(4, dtype=torch.int32)
    gtext = stages.compiled_for(qs, states, q, q).as_text()
    assert "kind graph" in gtext and "# replay launches" in gtext


def test_audit_is_tracekits(monkeypatch):
    from repro_torch.analysis import tracekit
    seen = {}

    def fake(cfg=None, **kw):
        seen.update(cfg=cfg, kw=kw)
        return "audited"

    monkeypatch.setattr(tracekit, "audit_fleet", fake)
    assert stages.audit("cfg", device="cpu") == "audited"
    assert seen == dict(cfg="cfg", kw=dict(device="cpu"))
