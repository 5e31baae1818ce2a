"""The benchmark's arithmetic: percentiles, peaks, byte counts and
interval unions."""
import numpy as np
import pytest

from port_bench import arith


@pytest.mark.parametrize("q", [0, 50, 95, 99, 100])
def test_percentile_is_exact_linear(q):
    x = np.random.default_rng(1).exponential(size=501)
    assert arith.percentile(x, q) == pytest.approx(np.percentile(x, q),
                                                   rel=1e-12)


def test_percentile_by_hand():
    assert arith.percentile([3.0], 95) == 3.0
    assert arith.percentile([1, 2, 3, 4], 50) == 2.5
    assert arith.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    with pytest.raises(ValueError):
        arith.percentile([], 50)


def test_peaks_table():
    p = arith.peaks("NVIDIA H100 80GB HBM3")
    assert p["bytes_per_s"] == 3.35e12
    assert arith.peaks("some other card") is None


def test_merge_traffic_by_hand():
    block = 10
    # one instance, 3 layers; steps: append, depth 1, append, depth 2
    nnz_start = [[5, 30, 100]]
    nnz0 = [[15, 0, 10, 0]]
    depth = [[0, 1, 0, 2]]
    nnz_end = [[0, 0, 160]]
    app, read, written = arith.merge_traffic(nnz_start, nnz_end, nnz0,
                                             depth, block)
    assert app == 2 * block
    # step 1: block + 15 slots + layer 1 (30); its result is not seen at
    # the end (layer 1 is cleared by step 3): counts as 30
    # step 3: block + 10 slots + layer 1 (30, the bound) + layer 2 (100);
    # result 160 at the end
    assert read == (10 + 15 + 30) + (10 + 10 + 30 + 100)
    assert written == 30 + 160


def test_merge_traffic_exact_when_each_layer_merges_once():
    app, read, written = arith.merge_traffic(
        [[0, 7, 0], [20, 0, 0]], [[0, 31, 0], [0, 0, 42]],
        [[0], [0]], [[1], [2]], 16)
    assert app == 0
    assert read == (16 + 0 + 7) + (16 + 20 + 0 + 0)
    assert written == 31 + 42


def test_union_and_merged_intervals():
    s = [0.0, 1.0, 1.5, 5.0, 9.0]
    e = [2.0, 1.2, 3.0, 6.0, 12.0]
    assert arith.merged_intervals(s, e, 0.0, 10.0) == [(0.0, 3.0),
                                                       (5.0, 6.0),
                                                       (9.0, 10.0)]
    assert arith.union_length(s, e, 0.0, 10.0) == pytest.approx(5.0)
    assert arith.union_length(s, e, 2.5, 5.5) == pytest.approx(1.0)
    assert arith.union_length([], [], 0.0, 1.0) == 0.0


@pytest.mark.parametrize("shape, grows", [
    ("steady", False), ("ramp", True), ("flat", False), ("settles", False)])
def test_sweep_backlog_growth(shape, grows):
    from port_bench import sweep
    t = np.linspace(0.5, 51.0, 35)
    rng = np.random.default_rng(3)
    y = {"steady": 10 + rng.integers(-6, 7, t.size),
         "ramp": 4 * t,
         "flat": np.zeros(t.size),
         "settles": np.minimum(t, 3.0) * 4 + rng.integers(-3, 4, t.size),
         }[shape]
    mean, rise, got = sweep.backlog_growth(t, y, 51.0)
    assert got is grows
    if shape == "ramp":
        # a backlog that grows steadily from empty rises by twice its mean
        assert abs(rise - 2 * mean) < 0.1 * mean
