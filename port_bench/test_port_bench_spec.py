"""BENCHMARK.json against the rules the file follows, and the harness
finding configurations, traffic and metrics by their names."""
import json
import re

import pytest

from port_bench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_config_file_is_found_by_name():
    for c in BENCH["configs"]:
        assert NAME.match(c["name"])
        assert c["file"] == f"port_bench/configs/{c['name']}.json"
        cfg = spec.config(c["name"])
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) <= set(cfg["reduced"])
        assert (spec.REPO / cfg["reference"]).exists()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    assert len({c["source"] for c in BENCH["configs"]}) \
        == len(BENCH["configs"])


def test_every_cell_finds_config_and_traffic():
    names = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        t = spec.traffic(w["traffic"])
        assert t["streams"] >= 1
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    assert {c["name"] for c in BENCH["configs"]} \
        == {w["config"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(group):
    for m in BENCH[group]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert callable(spec.module("metrics", m["name"]).read)


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = [w["name"] for w in BENCH["workloads"]]
    for cell in cells:
        e = [m["name"] for m in spec.metrics_for(BENCH, cell, False)]
        p = spec.metrics_for(BENCH, cell, True)
        assert "setup_s" in e and len(e) >= 2 and p
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for cell in m["workloads"]:
            reported = [x["name"] for x in spec.metrics_for(BENCH, cell,
                                                            False)]
            assert m["moves"] in reported, (m["name"], cell)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_metrics_for_filters_by_cell():
    e = [m["name"] for m in spec.metrics_for(BENCH, "paper-ingest", False)]
    assert e == ["updates_per_s", "setup_s"]
    p = [m["name"] for m in spec.metrics_for(BENCH, "paper-ingest", True)]
    assert "query_batch_ms" not in p and "ingest_roofline" in p
    # at four fifths of the knee the tail is the cell's end-to-end metric;
    # the ingest rate it leaves is read per layer, by updates_per_s's reader
    e = [m["name"] for m in spec.metrics_for(BENCH, "paper-ingest-query",
                                             False)]
    assert e == ["query_p95_ms", "setup_s"]
    p = [m["name"] for m in spec.metrics_for(BENCH, "paper-ingest-query",
                                             True)]
    assert "updates_per_s.query" in p and "ingest_roofline" not in p
    assert spec.module("metrics", "updates_per_s.query").__file__.endswith(
        "updates_per_s.py")


def test_new_pieces_are_found_by_file_name(tmp_path):
    for d in ("configs", "workloads", "metrics"):
        (tmp_path / d).mkdir()
    (tmp_path / "configs" / "x-1.json").write_text('{"name": "x-1"}')
    (tmp_path / "workloads" / "y.2.json").write_text('{"streams": 3}')
    (tmp_path / "metrics" / "z.w.py").write_text(
        "def read(run):\n    return run * 2\n")
    assert spec.config("x-1", tmp_path) == {"name": "x-1"}
    assert spec.traffic("y.2", tmp_path) == {"streams": 3}
    assert spec.module("metrics", "z.w", tmp_path).read(21) == 42
    # a quantity split by the metric it moves shares its reader
    (tmp_path / "metrics" / "v.py").write_text(
        "def read(run):\n    return run + 1\n")
    assert spec.module("metrics", "v.lookup", tmp_path).read(1) == 2
    with pytest.raises(FileNotFoundError):
        spec.module("metrics", "u.lookup", tmp_path)
    with pytest.raises(ValueError):
        spec.config("../etc", tmp_path)
    with pytest.raises(KeyError):
        spec.cell(BENCH, "no-such-cell")
