"""Whole runs at tiny sizes on the CPU (the harness's look for a card
skipped): sound runs come out correct; the control (the program's
bfloat16 value path) and every fault a cell can have come out not
correct.  And the command itself: no card, no result."""
import json
import shutil
import subprocess
import sys

import pytest
import torch

from port_bench import harness, run, spec
from port_bench.conftest import TINY, TINY_TRAFFIC

METRICS = [dict(name=n, unit="u", source=src) for n, src in (
    ("updates_per_s", "host_clock"), ("query_p95_ms", "host_clock"),
    ("setup_s", "host_clock"), ("query_wait_p95_ms", "host_clock"),
    ("query_batch_ms", "host_clock"),
    ("merge_entries_per_update", "program_counter"),
    ("sort_route_merges_per_step", "program_counter"),
    ("device_idle_pct.ingest", "device_trace"))]


def tiny_run(kind, seed=2**31 + 3, **kw):
    out = harness.run_cell(kind, TINY, TINY_TRAFFIC[kind], METRICS,
                           seed=seed, seconds=0.3, trace=False,
                           device="cpu", **kw)
    # the result line is printed as JSON, every number a plain one
    assert json.loads(json.dumps(out)) == out
    return out


@pytest.mark.parametrize("kind", ["ingest", "mixed"])
def test_sound_run_is_correct(kind):
    out = tiny_run(kind)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["failed"] == 0 and out["attempted"] > 0
    m = out["metrics"]
    assert m["setup_s"]["value"] > 0
    assert m["updates_per_s"]["value"] > 0
    if kind == "mixed":
        assert m["query_p95_ms"]["value"] > 0
        assert out["checks"]["unanswered"]["value"] == 0


@pytest.mark.parametrize("kind", ["ingest", "mixed"])
def test_traced_run_reads_per_layer_metrics(kind):
    out = harness.run_cell(kind, TINY, TINY_TRAFFIC[kind], METRICS,
                           seed=5, seconds=0.3, trace=True, device="cpu")
    assert json.loads(json.dumps(out)) == out
    assert out["correct"], out["checks"]
    assert out["metrics"]["merge_entries_per_update"]["value"] > 0
    assert out["device"]["window_s"] > 0 and "breakdown" in out
    if kind == "mixed":
        assert out["metrics"]["query_batch_ms"]["value"] > 0


def test_host_clock_metrics_read_the_untraced_window(monkeypatch):
    seen = {}

    class Reader:
        def __init__(self, name):
            self.name = name

        def read(self, run):
            seen[self.name] = run
            return 1.0
    monkeypatch.setattr(spec, "module", lambda kind, name: Reader(name))
    harness.run_cell("mixed", TINY, TINY_TRAFFIC["mixed"], METRICS,
                     seed=6, seconds=0.3, trace=True, device="cpu")
    plain, traced = seen["query_batch_ms"], seen["device_idle_pct.ingest"]
    assert plain is not traced
    assert plain.trace is None and traced.trace is not None
    assert seen["merge_entries_per_update"] is traced
    assert plain.batches and traced.batches


@pytest.mark.parametrize("kind", ["ingest", "mixed"])
def test_control_bfloat16_values_is_not_correct(kind):
    out = tiny_run(kind, value_dtype=torch.bfloat16)
    assert not out["correct"]
    c = out["checks"]
    assert c["wrong_entries"]["value"] > 0
    if kind != "ingest":
        assert c["wrong_answers"]["value"] > 0


def test_fault_step_returns_state_unchanged(monkeypatch):
    from repro_torch.core import stream
    monkeypatch.setattr(stream, "ingest_instances",
                        lambda states, *a, **k: (states, None))
    out = tiny_run("ingest")
    assert not out["correct"]
    assert out["checks"]["update_count_gap"]["value"] > 0


def test_fault_half_the_block_left_out(monkeypatch):
    from repro_torch.core import stream
    real = stream.ingest_instances

    def half(states, rows, cols, vals, **k):
        h = rows.shape[-1] // 2
        return real(states, rows[..., :h], cols[..., :h], vals[..., :h] * 2,
                    **k)
    monkeypatch.setattr(stream, "ingest_instances", half)
    out = tiny_run("ingest")
    assert not out["correct"]
    assert out["checks"]["wrong_entries"]["value"] > 0


def test_fault_answer_altered_where_produced(monkeypatch):
    from repro_torch.query import engine
    real = engine._point_lookup

    def altered(*a, **k):
        out = real(*a, **k)
        out[0, 0] += 1
        return out
    monkeypatch.setattr(engine, "_point_lookup", altered)
    out = tiny_run("mixed", seed=8)
    assert not out["correct"]
    assert out["checks"]["wrong_answers"]["value"] > 0


def test_forbidden_modules_compared_by_whole_name():
    clean = ["torch", "repro_torch", "repro_torch.core.stream", "port_bench",
             "reproducible", "jaxtyping"]
    assert run.loaded_forbidden(clean) == []
    assert run.loaded_forbidden(clean + ["jax.numpy", "repro.core"]) \
        == ["jax", "repro"]
    assert run.loaded_forbidden(["flax", "jaxlib.xla_client"]) \
        == ["flax", "jaxlib"]


def _command(cwd, cell="paper-ingest"):
    return subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", cell, "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=120)


def test_no_card_exits_nonzero_and_prints_no_result(no_cuda):
    done = _command(spec.REPO)
    assert done.returncode != 0
    assert done.stdout.strip() == ""
    assert "CUDA" in done.stderr


def test_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copy(spec.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = _command(tmp_path)
    assert done.returncode != 0
    assert done.stdout.strip() == ""


@pytest.mark.card
def test_cell_on_the_card(cuda):
    done = _command(spec.REPO)
    assert done.returncode == 0, done.stderr[-2000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
