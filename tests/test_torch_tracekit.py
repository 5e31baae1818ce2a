"""tracekit for the port (``repro_torch.analysis.tracekit``): recorded
calls of the fleet entries and committed cost budgets.

Mirrors the reference's ``tests/test_tracekit.py``: each seeded rule
(J001-J006) fires EXACTLY its own rule while the clean twin stays quiet;
J004 fires on ``.tolist()`` / ``.numpy()`` / ``.item()`` of a CPU tensor
(host reads the dispatcher does not show are caught by the recorder);
allow comments and the committed baseline (empty) behave as the
reference's, with the same allow regex, ``compare_budgets`` and
``render_budget_table`` outputs on identical inputs; the smoke fleet is
audit-clean; and the CLI exits 0 on the clean tree against the committed
``analysis/COST_BUDGETS.json`` and 1 on a breach, an unbudgeted entry and
each seeded rule."""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.analysis import tracekit as jtracekit
from repro_torch import stages
from repro_torch.analysis import baseline, tracekit

SRC = os.path.dirname(os.path.dirname(os.path.abspath(stages.__file__)))


def _wrap(fn, name, **kw):
    sig = stages.signature_of(extra=(("test_tracekit", name),))
    return stages.wrap(fn, f"test.tracekit.{name}", sig, **kw)


def _fired(wrapped, *args, acfg=None):
    rec = tracekit.record(wrapped, *args)
    return {v.rule for v in tracekit.run_rules([rec], acfg,
                                               lowered_keys=())}


F32 = torch.arange(8, dtype=torch.float32)
I32 = torch.arange(8, dtype=torch.int32)
BIG = torch.zeros(1 << 19)          # 2 MiB of float32


# ------------------------------------------------- seeded rule fixtures -----


def test_j001_float64_fires_exactly_once():
    bad = _wrap(lambda x: x.double() * 2.0, "j001_bad")
    ok = _wrap(lambda x: x * 2.0, "j001_ok")
    assert _fired(bad, F32) == {"J001"}
    assert _fired(ok, F32) == set()


def test_j002_closure_tensor():
    def make():
        big = torch.zeros(1 << 19)
        return lambda x: x + big[:8]
    bad = _wrap(make(), "j002_bad")
    glob = _wrap(lambda x: x + BIG[:8], "j002_global")
    ok = _wrap(lambda x, c: x + c[:8], "j002_ok")
    assert _fired(bad, F32) == {"J002"}
    assert _fired(glob, F32) == {"J002"}
    assert _fired(ok, F32, BIG) == set()
    loose = tracekit.AuditConfig(const_bytes=1 << 30)
    assert _fired(bad, F32, acfg=loose) == set()


def test_j003_unhonored_donation():
    bad = _wrap(lambda x: x + 1, "j003_bad", donate_argnums=(0,))
    ok = _wrap(lambda x: x.add_(1), "j003_ok", donate_argnums=(0,))
    undeclared = _wrap(lambda x: x + 1, "j003_none")
    assert _fired(bad, F32.clone()) == {"J003"}
    assert _fired(ok, F32.clone()) == set()
    assert _fired(undeclared, F32) == set()


@pytest.mark.parametrize("read", ["tolist", "numpy", "item", "int", "bool",
                                  "equal"])
def test_j004_host_read_on_a_cpu_tensor(read):
    fns = {"tolist": lambda x: torch.tensor(x.tolist()),
           "numpy": lambda x: torch.as_tensor(x.numpy() * 2),
           "item": lambda x: x * x[0].item(),
           "int": lambda x: x[: int(x[3])],
           "bool": lambda x: x if bool(x[0] == 0) else -x,
           "equal": lambda x: x if torch.equal(x, x) else -x}
    bad = _wrap(fns[read], f"j004_{read}")
    rec = tracekit.record(bad, F32)
    vs = tracekit.run_rules([rec], lowered_keys=())
    assert {v.rule for v in vs} == {"J004"}
    assert len(vs) == 1 and "test_torch_tracekit" not in vs[0].detail
    assert _fired(_wrap(lambda x: x * 2, "j004_ok"), F32) == set()


def test_j005_int64_widening_vs_index_ops():
    bad = _wrap(lambda h, l: (h.to(torch.int64) << 32) + l, "j005_bad")
    pair = _wrap(lambda h, l: (h > l) | ((h == l) & (l > 0)), "j005_pair")
    index = _wrap(lambda h, l: torch.argsort(h), "j005_index")
    assert _fired(bad, I32, I32) == {"J005"}
    assert _fired(pair, I32, I32) == set()
    assert _fired(index, I32, I32) == set()


def test_j006_retrace_surface_leak():
    w = _wrap(lambda x: x + 1, "j006")
    recs = []
    for n in range(1, 7):
        x = torch.zeros(n)
        w.lower(x)
        recs.append(tracekit.record(w, x))
    keys = [r.key for r in recs]
    tight = tracekit.AuditConfig(retrace_limit=4)
    vs = tracekit.run_rules(recs[:1], tight, lowered_keys=keys)
    assert [v.rule for v in vs] == ["J006"]
    assert tracekit.run_rules(recs[:1], tight, lowered_keys=keys[:4]) == []


def test_records_cover_every_call_of_a_sequence():
    w = _wrap(lambda x: x * 2, "sequence")

    def drive(call, rec):
        x = F32
        for _ in range(3):
            x = call(x)
    rec = tracekit.record(w, F32, drive=drive)
    t = rec.trace
    assert t.calls == 3 and len(t.peaks) == 3
    assert t.per_call()["bytes_accessed"] == 64   # 32 B read, 32 B written


# ------------------------------------------------ suppression + baseline ----


def test_allow_comment_scanning_matches_the_reference(tmp_path):
    good = tmp_path / "good"
    good.mkdir()
    (good / "owner.py").write_text(
        "# tracekit: allow(J004) entry=test.tracekit.* telemetry, "
        "removed in prod builds\n"
        "# tracekit: allow(J001, J005) entry=svc.* two rules\n"
        "# tracekit: allow(J004) entry=test.tracekit.*\n")
    allows = tracekit.scan_allows([str(good)])
    assert allows == jtracekit.scan_allows([str(good)])
    v = tracekit.Violation("J004", "test.tracekit.j004_bad", "item", "m")
    assert tracekit.suppressed(v, allows)
    assert not tracekit.suppressed(
        tracekit.Violation("J001", v.entry, "float64", "m"), allows)
    assert not tracekit.suppressed(
        tracekit.Violation("J004", "service.ingest", "d", "m"), allows)
    bare = tmp_path / "bare"
    bare.mkdir()
    (bare / "owner.py").write_text(
        "# tracekit: allow(J004) entry=test.tracekit.*\n")
    assert not tracekit.suppressed(v, tracekit.scan_allows([str(bare)]))


def test_j005_allow_counts_only_in_its_own_file(tmp_path):
    (tmp_path / "core").mkdir()
    (tmp_path / "core" / "assoc.py").write_text(
        "# tracekit: allow(J005) entry=* packs keys on purpose\n")
    allows = tracekit._scan([str(tmp_path)])
    here = tracekit.Violation("J005", "e", "widen:aten._to_copy.default"
                              "@core/assoc.py:pack_key", "m")
    there = tracekit.Violation("J005", "e", "widen:aten._to_copy.default"
                               "@core/hier.py:other", "m")
    assert tracekit._suppressed_in_tree(here, allows)
    assert not tracekit._suppressed_in_tree(there, allows)


def test_baseline_keys_are_line_free_and_counted(tmp_path):
    v = tracekit.Violation("J001", "svc.entry", "float64", "msg")
    assert v.key == "J001 svc.entry float64"
    path = tmp_path / "base.txt"
    path.write_text("# comment\n" + v.key + "\n")
    base = baseline.load_baseline(str(path))
    assert baseline.new_violations([v], base) == []
    assert baseline.new_violations([v, v], base) == [v]


def test_committed_baseline_is_empty():
    assert sum(baseline.load_baseline(
        tracekit.DEFAULT_BASELINE).values()) == 0


# ----------------------------------------------------------- budgets --------

_BUDGETS = {"entries": {
    "e1 aaa": dict(flops=100.0, bytes_accessed=1000.0, peak_bytes=None),
    "e3 ccc": dict(flops=10.0, bytes_accessed=10.0, peak_bytes=10.0),
}}
_MEASURED = [
    {"e1 aaa": dict(flops=120.0, bytes_accessed=1000.0, peak_bytes=5.0),
     "e2 bbb": dict(flops=1.0, bytes_accessed=1.0, peak_bytes=1.0)},
    {"e1 aaa": dict(flops=109.0, bytes_accessed=1050.0, peak_bytes=None)},
    {"e1 aaa": dict(flops=50.0, bytes_accessed=500.0, peak_bytes=None)},
]


def test_compare_budgets_verdicts():
    diff = tracekit.compare_budgets(_MEASURED[0], _BUDGETS, tolerance=0.10)
    assert len(diff["breaches"]) == 1 and "e1 aaa" in diff["breaches"][0]
    assert diff["missing"] == ["e2 bbb"] and diff["stale"] == ["e3 ccc"]
    assert tracekit.compare_budgets(_MEASURED[1], _BUDGETS,
                                    0.10)["breaches"] == []
    d2 = tracekit.compare_budgets(_MEASURED[2], _BUDGETS, 0.10)
    assert d2["breaches"] == [] and d2["improved"] == ["e1 aaa"]


@pytest.mark.parametrize("i", range(len(_MEASURED)))
def test_budget_machinery_matches_the_reference(i):
    got = tracekit.compare_budgets(_MEASURED[i], _BUDGETS, 0.10)
    want = jtracekit.compare_budgets(_MEASURED[i], _BUDGETS, 0.10)
    assert got == want
    assert tracekit.render_budget_table(got["rows"]) == \
        jtracekit.render_budget_table(want["rows"])


# ------------------------------------------------- fleet audit + CLI --------

FLEET_ENTRIES = {"stream.ingest_instances", "service.ingest",
                 "service.point_query", "service.analytics", "hier.update",
                 "hier.flush", "hier.query_all",
                 "query.engine.point_lookup", "hier.metrics_snapshot"}


@pytest.fixture(scope="module")
def fleet():
    sig = stages.signature_of(cuts=(96, 384), block_size=32, lazy_l0=True,
                              batch_mode="grouped", l0_mode="auto")
    return stages.audit(sig, instances=2, blocks=2, queries=8,
                        analytics_num_rows=256, analytics_k=4, device="cpu")


def test_fleet_is_audit_clean(fleet):
    """Tier-1 gate: the fleet is J-clean against the EMPTY committed
    baseline; every hit is a reasoned in-tree allow, the graph entry reads
    no host, and the ingest sequences spilled into every layer."""
    assert [v.render() for v in fleet["fresh"]] == []
    assert {r.entry for r in fleet["records"]} == FLEET_ENTRIES
    assert not [v for v in fleet["violations"]
                if v.entry == "service.point_query" and v.rule == "J004"]
    for key, row in fleet["measured"].items():
        assert row["flops"] is not None and row["bytes_accessed"] > 0, key
    ingest = [r for r in fleet["records"] if r.entry == "service.ingest"][0]
    assert ingest.trace.calls >= 2
    assert all(r.trace.calls == 1 for r in fleet["records"]
               if r.entry in ("service.point_query", "hier.flush"))


def test_cli_check_clean_tree_exits_0(monkeypatch):
    """The CLI on the committed budgets (the CPU's, at the smoke config),
    from a cold ``stages`` cache as in a process of its own: J006 counts
    every lowering of the process, and the test files that ran before in
    this worker may have lowered the fleet's entries at other shapes.  The
    caches come back after the test."""
    for cache in ("_WRAPPED", "_LOWERED", "_COMPILED"):
        monkeypatch.setattr(stages, cache, {})
    data = tracekit.load_budgets(tracekit.DEFAULT_BUDGETS)
    assert data["_meta"]["backend"] == "cpu"
    assert {e["entry"] for e in data["entries"].values()} == FLEET_ENTRIES
    assert tracekit.main(["--check", "-q"]) == 0


def test_cli_module_entry_point_exits_0():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-m",
                          "repro_torch.analysis.tracekit", "--check", "-q"],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "tracekit: clean" in out.stdout


def _cached(fleet):
    return lambda cfg=None, **kw: fleet


def test_cli_budget_breach_and_missing_exit_1(fleet, tmp_path,
                                              monkeypatch):
    monkeypatch.setattr(tracekit, "audit_fleet", _cached(fleet))
    path = tmp_path / "b.json"
    assert tracekit.main(["--update", "--budgets", str(path), "-q"]) == 0
    assert tracekit.main(["--check", "--budgets", str(path), "-q"]) == 0
    data = json.loads(path.read_text())
    key = sorted(data["entries"])[0]
    data["entries"][key]["bytes_accessed"] = 1.0      # guaranteed breach
    path.write_text(json.dumps(data))
    assert tracekit.main(["--check", "--budgets", str(path), "-q"]) == 1
    assert tracekit.main(["--check", "-q", "--budgets",
                          str(tmp_path / "none.json")]) == 1


@pytest.mark.parametrize("rule", sorted(tracekit.RULES))
def test_cli_exits_1_on_each_seeded_rule(rule, monkeypatch):
    v = tracekit.Violation(rule, "test.seeded", "detail", "seeded")

    def fake_audit(cfg=None, **kw):
        return dict(records=[], violations=[v], suppressed=[], fresh=[v],
                    measured={})

    monkeypatch.setattr(tracekit, "audit_fleet", fake_audit)
    assert tracekit.main(["--check", "-q"]) == 1
