"""The reference and the judge on hand-made streams and states."""
from types import SimpleNamespace

import torch

from port_bench import judge, reference

SCALE = 4


def _stream():
    # 3 blocks of 4 updates; keys as (row, col)
    rows = torch.tensor([[1, 2, 1, 3], [1, 1, 0, 2], [3, 3, 1, 2]],
                        dtype=torch.int32)
    cols = torch.tensor([[1, 0, 1, 2], [1, 5, 0, 0], [2, 2, 1, 0]],
                        dtype=torch.int32)
    vals = torch.tensor([[10, 20, 30, 40], [50, 60, 70, 80],
                         [90, 100, 110, 120]], dtype=torch.float32)
    return rows, cols, vals


def key(r, c):
    return (r << SCALE) | c


def test_prefix_answers_by_hand():
    ps = reference.PrefixSums(*_stream(), SCALE)
    keys = torch.tensor([key(1, 1), key(2, 0), key(3, 2), key(1, 5),
                         key(0, 0), key(7, 7)])
    want = {0: [0, 0, 0, 0, 0, 0],
            1: [40, 20, 40, 0, 0, 0],
            2: [90, 100, 40, 60, 70, 0],
            3: [200, 220, 230, 60, 70, 0]}
    for b, w in want.items():
        got = ps.answers(keys, torch.full_like(keys, b))
        assert got.tolist() == [float(x) for x in w], b


def test_prefix_contents_by_hand():
    ps = reference.PrefixSums(*_stream(), SCALE)
    keys, sums = ps.contents(2)
    assert keys.tolist() == [key(0, 0), key(1, 1), key(1, 5), key(2, 0),
                             key(3, 2)]
    assert sums.tolist() == [70.0, 90.0, 60.0, 100.0, 40.0]
    keys, sums = ps.contents(0)
    assert keys.numel() == 0 and sums.numel() == 0


def test_mismatches_counts_values_and_missing_keys():
    k = torch.tensor([1, 2, 3])
    s = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    assert reference.mismatches(k, s, k, s) == 0
    assert reference.mismatches(
        k, s, k, s + torch.tensor([0, 0, 0.5], dtype=s.dtype)) == 1
    assert reference.mismatches(k[:2], s[:2], k, s) == 1
    assert reference.mismatches(torch.tensor([1, 4]), s[:2], k[:2],
                                s[:2]) == 2
    assert reference.mismatches(k[:0], s[:0], k[:0], s[:0]) == 0


def test_judge_combines_layers_and_ignores_dead_slots():
    S = 2**31 - 1

    def seg(hi, lo, val, nnz):
        return SimpleNamespace(hi=torch.tensor([hi], dtype=torch.int32),
                               lo=torch.tensor([lo], dtype=torch.int32),
                               val=torch.tensor([val]),
                               nnz=torch.tensor([nnz], dtype=torch.int32))
    state = SimpleNamespace(layers=[
        # raw layer 0: a repeated key, and a dead slot past nnz
        seg([1, 2, 1, 9], [1, 0, 1, 9], [5.0, 6.0, 7.0, 1000.0], 3),
        seg([1, 3, S], [1, 2, S], [8.0, 9.0, 0.0], 2),
    ], n_updates=torch.tensor([12]), overflow=torch.tensor([0]))
    keys, sums = judge.contents(state, 0, SCALE)
    assert keys.tolist() == [key(1, 1), key(2, 0), key(3, 2)]
    assert sums.tolist() == [20.0, 6.0, 9.0]
    n, o = judge.counters(state)
    assert n.tolist() == [12] and o.tolist() == [0]
