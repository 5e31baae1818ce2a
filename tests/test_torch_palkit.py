"""palkit for the port (``repro_torch.analysis.palkit``) on the CPU.

The kernels run only on the card, so here the rule engine runs on fixture
records (each seeded rule K000-K006 fires EXACTLY once, the clean twin is
quiet), the parsers on captured text written below (``-Xptxas=-v`` and
the four compute-sanitizer tools, including the "Device not supported"
answer of a machine where the tool cannot run), and the CLI exits 2 with
"no CUDA device".  The shared machinery gives the reference's outputs on
identical inputs (``compare_budgets``, the allow regex and scanning), the
committed baseline is empty, and the committed ``SMEM_BUDGETS.json``
(recorded on the card) budgets every registry and main-path job under the
H100's ceiling.  ``chip_smoke.py`` phase 16 runs the audit on the card."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import palkit as jpalkit
from repro_torch.analysis import baseline, palkit
from repro_torch.kernels import registry

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

CLEAN_TOOLS = dict(memcheck=0, initcheck=0, synccheck=0, racecheck=0)


def _launch(kernel="merge_kernel<true, float, 0>", **kw):
    row = dict(kernel=kernel, grid=4, block=256, smem_static=5260,
               smem_dynamic=0, regs=32, spill_bytes=0, vector=False,
               aligned=True)
    row.update(kw)
    return row


def _record(**kw):
    rec = palkit.KernelRecord("fixture/job", "hier_merge",
                              launches=[_launch()],
                              tools=dict(CLEAN_TOOLS), max_abs_err=0.0)
    return dataclasses.replace(rec, **kw)


SEEDED = {
    "K000": dict(failure="RuntimeError: nvcc failed", launches=[]),
    "K001": dict(launches=[_launch(block=100)]),
    "K002": dict(launches=[_launch(kernel="ring_kernel<4>",
                                   smem_dynamic=240_000)]),
    "K003": dict(tools=dict(CLEAN_TOOLS, memcheck=2)),
    "K004": dict(tools=dict(CLEAN_TOOLS, initcheck=1)),
    "K005": dict(diverged="output 2: max abs error 0.5 over rtol 0.0001"),
    "K006": dict(tools=dict(CLEAN_TOOLS, racecheck=3)),
}


@pytest.mark.parametrize("rule", sorted(SEEDED))
def test_each_seeded_rule_fires_exactly_once(rule):
    vs = palkit.run_rules([_record(**SEEDED[rule])])
    assert [v.rule for v in vs] == [rule], [v.render() for v in vs]


def test_clean_record_is_quiet():
    assert palkit.run_rules([_record()]) == []


def test_k001_vector_path_on_unaligned_operands():
    rec = _record(launches=[_launch(kernel="bag_kernel<4>", vector=True,
                                    aligned=False)])
    vs = palkit.run_rules([rec])
    assert [(v.rule, v.detail) for v in vs] == [("K001",
                                                 "vector:bag_kernel<4>")]


def test_checked_build_stands_in_for_an_unavailable_tool():
    unavailable = dict(memcheck=None, initcheck=None, synccheck=None,
                       racecheck=None)
    clean = _record(tools=unavailable, checked=dict(bounds=0, init=0,
                                                    sync=0))
    assert clean.check_counts() == dict(K003=0, K004=0, K006=0)
    assert palkit.run_rules([clean]) == []
    for cls, rule in (("bounds", "K003"), ("init", "K004"),
                      ("sync", "K006")):
        rec = _record(tools=unavailable,
                      checked=dict(dict(bounds=0, init=0, sync=0),
                                   **{cls: 1}))
        assert [v.rule for v in palkit.run_rules([rec])] == [rule]
    # neither ran: nothing counted (and the audit reports the failure)
    assert _record(tools=unavailable).check_counts() == dict(
        K003=None, K004=None, K006=None)


@pytest.mark.parametrize("tool", palkit.TOOLS)
def test_a_tool_that_failed_is_k000_not_a_stand_in(tool):
    """Only an unavailable tool hands over to the checked build: a tool
    that started and ended without its summary is a violation, even with
    the checked build clean."""
    rec = _record(tools=dict(CLEAN_TOOLS, **{tool: None}),
                  tool_failures={tool: "no summary line (exit -9)"},
                  checked=dict(bounds=0, init=0, sync=0))
    vs = palkit.run_rules([rec])
    assert [(v.rule, v.detail) for v in vs] == [("K000", f"sanitizer:{tool}")]


def test_measure_rows():
    rec = _record(launches=[
        _launch(kernel="prepare_kernel<uint32_t>", smem_static=36864,
                block=1024),
        _launch(regs=40, spill_bytes=8)])
    row = palkit.measure([rec])["fixture/job"]
    assert row["smem_bytes"] == 36864 and row["regs"] == 40
    assert row["spill_bytes"] == 8 and row["launches"] == 2
    assert row["kernels"] == ["merge_kernel<true, float, 0>",
                              "prepare_kernel<uint32_t>"]
    assert palkit.measure([_record(**SEEDED["K000"])]) == {}


# ---------------------------------------------------------------- parsers --

PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114prepare_kernelIjEEvPKiS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114prepare_kernelIjEEvPKiS2_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 36864 bytes smem
ptxas info    : Compile time = 19.376 ms
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111rows_kernelILi4EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111rows_kernelILi4EEEvPKf
    24 bytes stack frame, 24 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 64 registers, used 0 barriers, 24 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110bag_kernelILi4EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_110bag_kernelILi4EEEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
"""


def test_parse_ptxas():
    got = palkit.parse_ptxas(PTXAS)
    prep = got["_ZN12_GLOBAL__N_114prepare_kernelIjEEvPKiS2_"]
    assert prep == dict(regs=32, barriers=1, smem_static=36864, stack=0,
                        spill_stores=0, spill_loads=0)
    rows = got["_ZN12_GLOBAL__N_111rows_kernelILi4EEEvPKf"]
    assert (rows["regs"], rows["smem_static"], rows["stack"],
            rows["spill_stores"], rows["spill_loads"]) == (64, 0, 24, 24, 32)
    assert got["_ZN12_GLOBAL__N_110bag_kernelILi4EEEvPKf"]["regs"] == 32
    names = palkit.demangle(list(got))
    assert set(names) == set(got)
    if names != {n: n for n in got}:        # c++filt present
        assert "prepare_kernel<unsigned int>" in \
            names["_ZN12_GLOBAL__N_114prepare_kernelIjEEvPKiS2_"]


UNAVAILABLE = """\
========= COMPUTE-SANITIZER
========= Error: Device not supported. Please refer to the "Supported Devices" section of the sanitizer documentation
=========
rc 700
========= ERROR SUMMARY: 1 error
"""
MEMCHECK = """\
========= COMPUTE-SANITIZER
========= Invalid __global__ read of size 16 bytes
=========     at void (anonymous namespace)::ring_kernel<4>(const float *, const int *)+0x1d0 in segment_agg.cu:301
=========     by thread (0,0,0) in block (3,0,0)
=========     Address 0x7f00 is out of bounds
=========
========= Invalid __global__ write of size 4 bytes
=========     at void (anonymous namespace)::carry_kernel<4, 4>(const int *)+0x90 in segment_agg.cu:412
=========     by thread (1,0,0) in block (0,0,0)
=========
palkit --run-jobs: 12 job(s) done
========= ERROR SUMMARY: 2 errors
"""
RACECHECK = """\
========= COMPUTE-SANITIZER
========= Error: Race reported between Write access at void (anonymous namespace)::merge_kernel<true, float, 0>(const int *)+0x30 in hier_merge.cu:480
=========     and Read access at void (anonymous namespace)::merge_kernel<true, float, 0>(const int *)+0x40 in hier_merge.cu:490 [128 hazards]
=========
========= RACECHECK SUMMARY: 2 hazards displayed (1 error, 1 warning)
"""
CLEAN = """\
========= COMPUTE-SANITIZER
palkit --run-jobs: 12 job(s) done
========= ERROR SUMMARY: 0 errors
"""


def test_parse_sanitizer():
    u = palkit.parse_sanitizer(UNAVAILABLE, "memcheck")
    assert u["status"] == "unavailable" and u["errors"] is None
    assert "Device not supported" in u["message"]
    m = palkit.parse_sanitizer(MEMCHECK, "memcheck")
    assert (m["status"], m["errors"]) == ("ok", 2)
    assert m["per_kernel"] == {"ring_kernel": 1, "carry_kernel": 1}
    r = palkit.parse_sanitizer(RACECHECK, "racecheck")
    assert (r["status"], r["errors"]) == ("ok", 1)
    assert r["per_kernel"] == {"merge_kernel": 1}
    c = palkit.parse_sanitizer(CLEAN, "initcheck")
    assert (c["status"], c["errors"], c["per_kernel"]) == ("ok", 0, {})
    f = palkit.parse_sanitizer("Segmentation fault\n", "synccheck")
    assert f["status"] == "failed"
    assert palkit.parse_sanitizer(NO_SUMMARY, "memcheck")["status"] == \
        "failed"


NO_SUMMARY = """\
========= COMPUTE-SANITIZER
========= Program hit cudaErrorLaunchFailure (error 719) due to "unspecified launch failure" on CUDA API call to cudaStreamSynchronize.
=========
(timed out)
"""
FAKE_SANITIZER = """\
import sys
tool, text = sys.argv[2], {texts!r}
print(text[tool])
sys.exit({{"memcheck": 1, "initcheck": 137, "synccheck": 0,
          "racecheck": 1}}[tool])
"""


def test_sanitize_fails_a_tool_that_ends_without_its_summary(
        monkeypatch, tmp_path):
    """Captured text per tool from a stand-in compute-sanitizer: memcheck
    and racecheck "Device not supported" (unavailable: the checked build
    stands in for memcheck, racecheck's class is named not covered),
    initcheck killed with no summary line, synccheck with its summary but
    no jobs file.  The two that failed are K000 on every record."""
    fake = tmp_path / "compute-sanitizer"
    texts = dict(memcheck=UNAVAILABLE, initcheck=NO_SUMMARY,
                 synccheck=CLEAN, racecheck=UNAVAILABLE)
    fake.write_text(f"#!{sys.executable}\n"
                    + FAKE_SANITIZER.format(texts=texts))
    fake.chmod(0o755)
    monkeypatch.setattr(palkit, "sanitizer_path", lambda: str(fake))
    rec = palkit.KernelRecord("fixture/job", "hier_merge",
                              launches=[_launch()])
    report = palkit.sanitize([rec])
    assert {t: report[t]["status"] for t in palkit.TOOLS} == dict(
        memcheck="unavailable", initcheck="failed", synccheck="failed",
        racecheck="unavailable")
    assert "(bounds)" in report["memcheck"]["stand_in"]
    assert report["racecheck"]["stand_in"] == palkit.RACE_NOT_COVERED
    assert "did not run to their end" in report["synccheck"]["message"]
    assert set(rec.tool_failures) == {"initcheck", "synccheck"}
    assert "exit 137" in rec.tool_failures["initcheck"]
    assert rec.tools == dict.fromkeys(palkit.TOOLS)
    # the checked child has no card either: the job carries that too
    vs = palkit.run_rules([rec])
    assert [(v.rule, v.detail) for v in vs] == [
        ("K000", "launch"), ("K000", "sanitizer:initcheck"),
        ("K000", "sanitizer:synccheck")]


def test_compare_machinery_matches_the_reference():
    """The same verdicts as the reference's palkit on identical inputs (its
    field is ``vmem_bytes``, the port's ``smem_bytes``)."""
    budgets = {"kernels": {"k1": dict(smem_bytes=100),
                           "k3": dict(smem_bytes=7)}}
    measured = {"k1": dict(smem_bytes=120), "k2": dict(smem_bytes=5)}

    def rename(d, a, b):
        return {k: {(b if f == a else f): v for f, v in row.items()}
                for k, row in d.items()}

    for meas in (measured, {"k1": dict(smem_bytes=105)},
                 {"k1": dict(smem_bytes=50)}):
        got = palkit.compare_budgets(meas, budgets, 0.10)
        want = jpalkit.compare_budgets(
            rename(meas, "smem_bytes", "vmem_bytes"),
            {"kernels": rename(budgets["kernels"], "smem_bytes",
                               "vmem_bytes")}, 0.10)
        for key in ("missing", "stale", "improved"):
            assert got[key] == want[key]
        assert [b.replace("smem", "vmem") for b in got["breaches"]] == \
            want["breaches"]
        assert [r[3] for r in got["rows"]] == [r[3] for r in want["rows"]]
    table = palkit.render_budget_table(
        palkit.compare_budgets(measured, budgets)["rows"])
    assert "MISSING" in table and "BREACH" in table


@pytest.mark.parametrize("line", [
    "# palkit: allow(K005) kernel=hier_merge.* order of float sums",
    "# palkit: allow(K001, K002) kernel=* two rules",
    "# palkit: allow(K003) kernel=x",
    "# tracekit: allow(J004) entry=a reason",
])
def test_allow_regex_matches_the_reference(line):
    a, b = palkit._ALLOW_RE.search(line), jpalkit._ALLOW_RE.search(line)
    assert (a and a.groups()) == (b and b.groups())


def test_allow_scanning_and_suppression(tmp_path):
    (tmp_path / "owner.py").write_text(
        "# palkit: allow(K005) kernel=fixture/* float sums in another "
        "order\n# palkit: allow(K003) kernel=fixture/*\n")
    allows = palkit.scan_allows([str(tmp_path)])
    assert allows == jpalkit.scan_allows([str(tmp_path)])
    k5 = palkit.Violation("K005", "fixture/job", "divergence", "m")
    assert palkit.suppressed(k5, allows)
    assert not palkit.suppressed(
        palkit.Violation("K003", "fixture/job", "oob", "m"), allows)


def test_baseline_keys_are_per_job_and_counted(tmp_path):
    v = palkit.Violation("K002", "segment_agg.segment_sum_cuda/t2.d128",
                         "ceiling", "m")
    assert v.key == "K002 segment_agg.segment_sum_cuda/t2.d128 ceiling"
    path = tmp_path / "base.txt"
    path.write_text(v.key + "\n")
    base = baseline.load_baseline(str(path))
    assert baseline.new_violations([v, v], base) == [v]


def test_committed_baseline_is_empty():
    assert sum(baseline.load_baseline(
        palkit.DEFAULT_BASELINE).values()) == 0


def test_committed_budgets_cover_every_job_under_the_ceiling():
    data = palkit.load_budgets(palkit.DEFAULT_BUDGETS)
    assert "H100" in data["_meta"]["device"]
    rows = data["kernels"]
    names = {j.name for j in registry.jobs()}
    assert names <= set(rows)
    assert set(chip_smoke.ANALYSIS_JOBS.values()) <= set(rows)
    for name, row in rows.items():
        assert 0 <= row["smem_bytes"] <= palkit.SMEM_CEILING, name
        assert row["smem_bytes"] >= row["smem_static"]
    # reckoned from the sources: prepare_kernel's 36,864
    # static bytes; ring_kernel's ring at D = 512 and D = 64
    assert rows["hier_merge.merge_multi_cuda/main.3072+16384"][
        "smem_bytes"] == 4096 * 8 + 32 * 32 * 4
    assert rows["segment_agg.segment_sum_cuda/main.graphcast_r6"][
        "smem_dynamic"] == 4 * 12 * 512 * 4 + 1024
    assert rows["segment_agg.segment_sum_cuda/main.gat_cora"][
        "smem_dynamic"] == 4 * 32 * 64 * 4 + 1024


def test_every_registry_job_names_its_launch_config():
    assert all(j.launch_config is not None for j in registry.jobs())


def test_one_job_universe_for_audit_children_and_budgets(monkeypatch):
    """The audit, its ``--run-jobs`` children and ``--update`` all cover
    the registry's jobs and the main-path jobs; no option narrows it."""
    monkeypatch.setattr(registry, "jobs", lambda: ("a", "b"))
    monkeypatch.setattr(registry, "main_path_jobs", lambda: ("m",))
    assert palkit._jobs() == ["a", "b", "m"]
    assert palkit._child_cmd("o.json", True)[3:] == [
        "--run-jobs", "--out", "o.json", "--checked"]
    meta = palkit.load_budgets(palkit.DEFAULT_BUDGETS)["_meta"]
    assert meta["command"] == "python -m repro_torch.analysis.palkit --update"


def test_checked_libraries_only_by_call_before_the_first_load(monkeypatch):
    """``build.load`` hands out the checked library only after
    ``use_checked_libraries()``, which refuses once a library is loaded;
    the environment does not reach the loader."""
    from repro_torch.kernels import build
    built = []
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "_CHECKED", False)
    monkeypatch.setattr(build, "build_all",
                        lambda srcs, checked=False: built.append(checked))
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setenv("REPRO_KERNEL_CHECKS", "1")
    src = registry.AUDITED_FILES[0]
    assert build.load(src) == str(build.library_path(src))
    with pytest.raises(RuntimeError, match="already loaded"):
        build.use_checked_libraries()
    build._LOADED.clear()
    build.use_checked_libraries()
    assert build.load(src) == str(build.library_path(src, checked=True))
    assert built == [False, True]


# -------------------------------------------------------------------- CLI --


def test_cli_exits_2_without_a_card(capsys):
    assert palkit.main(["--check"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert palkit.main(["--update"]) == 2
    with pytest.raises(palkit.NoDevice):
        palkit.audit_kernels()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m",
                          "repro_torch.analysis.palkit", "--check"],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 2 and "no CUDA device" in out.stderr


def test_kernels_line_checks_from_a_report():
    """chip_smoke's (d): resources and one error count per tool, the
    checked build's where the sanitizer could not run; racecheck's None
    with its reason, since the checked build has no race detector."""
    msg = "Error: Device not supported."
    report = dict(
        sanitizer={t: dict(status="unavailable", message=msg)
                   for t in palkit.TOOLS},
        jobs={"j": dict(launches=[
            _launch(kernel="ring_kernel<4>", smem_static=0,
                    smem_dynamic=99328, regs=80),
            _launch(kernel="carry_kernel<4, 4>", smem_static=0, regs=104,
                    spill_bytes=0)],
            tools=dict.fromkeys(palkit.TOOLS),
            checked=dict(bounds=0, init=0, sync=0))})
    row = chip_smoke.kernel_checks(report, "j")
    assert (row["regs"], row["smem_static"], row["smem_dynamic"],
            row["spill_bytes"]) == (104, 0, 99328, 0)
    san = row["sanitizer"]
    assert {t: san[t] for t in palkit.TOOLS} == dict(CLEAN_TOOLS,
                                                     racecheck=None)
    assert san["counted_by"] == "checked build"
    assert san["not_covered"] == {"racecheck": (
        "compute-sanitizer racecheck did not run; "
        + palkit.RACE_NOT_COVERED)}
    assert san["compute_sanitizer"] == msg
    # where racecheck ran, its own count stands
    report["jobs"]["j"]["tools"] = dict(racecheck=2)
    san = chip_smoke.kernel_checks(report, "j")["sanitizer"]
    assert san["racecheck"] == 2 and san["not_covered"] == {}
    assert san["counted_by"] == dict(
        memcheck="checked build (bounds)", initcheck="checked build (init)",
        synccheck="checked build (sync)", racecheck="compute-sanitizer")


def test_main_path_jobs_build_on_the_cpu_and_are_budgeted():
    """``registry.main_path_jobs`` (phase 16's shapes) makes its merge
    operands on any device; every job has a committed budget row."""
    import torch
    jobs = registry.main_path_jobs("cpu")
    rows = palkit.load_budgets(palkit.DEFAULT_BUDGETS)["kernels"]
    assert {j.name for j in jobs} <= set(rows)
    bh, bl, bv, runs = jobs[1].make_inputs(0)
    assert jobs[1].name.endswith("bfloat16") and bv.dtype == torch.bfloat16
    assert (bh.shape[0], runs[0][0].shape[0]) == (3072, 16384)
    assert all(j.launch_config is not None for j in jobs)


def test_sanitize_never_skips_without_a_card(monkeypatch):
    """With no tool and no card nothing passes quietly: each tool is
    unavailable, the checked build's child refuses (exit 2), and the job
    then carries a failure (K000) instead of counts."""
    monkeypatch.setattr(palkit, "sanitizer_path", lambda: None)
    rec = palkit.KernelRecord("fixture/job", "hier_merge",
                              launches=[_launch()])
    report = palkit.sanitize([rec])
    assert {report[t]["status"] for t in palkit.TOOLS} == {"unavailable"}
    assert report["checked_build"]["status"] == "failed"
    assert report["checked_build"]["exit"] == 2
    assert rec.checked is None and "checked build" in rec.failure
    assert [v.rule for v in palkit.run_rules([rec])] == ["K000"]
