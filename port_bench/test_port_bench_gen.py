"""The seeded inputs: R-MAT quadrant frequencies, determinism, values,
key sets and the arrival schedule."""
import numpy as np
import pytest
import torch

from port_bench import gen


def _edges(seed, n, scale):
    rows = torch.empty(n, dtype=torch.int32)
    cols = torch.empty(n, dtype=torch.int32)
    gen.rmat_fill(gen.generator(seed, "t"), rows, cols, scale)
    return rows, cols


@pytest.mark.parametrize("level", [0, 3, 5])
def test_rmat_quadrant_frequencies(level):
    n = 200_000
    rows, cols = _edges(7, n, 6)
    quad = ((rows >> level) & 1) * 2 + ((cols >> level) & 1)
    share = torch.bincount(quad.long(), minlength=4).double() / n
    # each level's bits are one independent quadrant draw
    assert torch.allclose(share, torch.tensor(gen.GRAPH500,
                                              dtype=torch.float64),
                          atol=0.005)


def test_rmat_in_range_and_chunked_alike(monkeypatch):
    a = _edges(3, 5000, 9)
    assert int(a[0].min()) >= 0 and int(a[0].max()) < 512
    assert int(a[1].min()) >= 0 and int(a[1].max()) < 512
    monkeypatch.setattr(gen, "CHUNK", 1000)
    b = _edges(3, 5000, 9)
    # chunks draw the same distribution (not the same bits): compare
    # the first level's quadrant shares
    for r, c in (a, b):
        q = (r & 1) * 2 + (c & 1)
        share = torch.bincount(q.long(), minlength=4).double() / 5000
        assert abs(float(share[0]) - 0.57) < 0.03


def test_streams_deterministic_by_seed():
    big = 2**31 + 12345
    one = gen.streams(big, 2, 3, 4, 16, 10, (40, 1500), "cpu")
    two = gen.streams(big, 2, 3, 4, 16, 10, (40, 1500), "cpu")
    other = gen.streams(big + 1, 2, 3, 4, 16, 10, (40, 1500), "cpu")
    for x, y in zip(one, two):
        assert torch.equal(x, y)
    assert not torch.equal(one[0], other[0])
    rows, cols, vals = one
    assert rows.shape == (2, 3, 4, 16) and vals.dtype == torch.float32
    assert torch.equal(vals, vals.round())
    assert float(vals.min()) >= 40 and float(vals.max()) <= 1500


def test_sub_seed_takes_any_whole_number():
    seeds = [0, 1, -1, 2**31 - 1, 2**31 + 7, 2**40, -2**35]
    subs = [gen.sub_seed(s, "stream") for s in seeds]
    assert len(set(subs)) == len(seeds)
    assert all(0 <= x < 2**63 for x in subs)
    assert gen.sub_seed(5, "a") != gen.sub_seed(5, "b")


def test_key_sets_mix():
    q_rows, q_cols = gen.key_sets(9, 200, 8, 0.5, 12, "cpu")
    assert q_rows.shape == (200, 8) and q_rows.dtype == torch.int32
    # the R-MAT half leans to low ids, the uniform half does not
    rmat_mean = float(q_rows[:, :4].double().mean())
    uni_mean = float(q_rows[:, 4:].double().mean())
    assert rmat_mean < 0.6 * uni_mean
    assert abs(uni_mean / 4096 - 0.5) < 0.05


def test_poisson_arrivals_stratified_and_fixed():
    a = gen.poisson_arrivals(20.0, 10.0)
    assert a.size == 200
    assert np.array_equal(a, gen.poisson_arrivals(20.0, 10.0))
    gaps = np.diff(a, prepend=0)
    # the gaps are the exponential's quantiles at (i + 0.5) / n, shuffled
    want = -np.log1p(-(np.arange(200) + 0.5) / 200) / 20.0
    assert np.allclose(np.sort(gaps), want)
    assert not np.allclose(gaps, want)
    assert np.all(np.diff(a) > 0) and abs(a[-1] - 10.0) < 1.0
    assert gen.poisson_arrivals(0.05, 10.0).size == 0
