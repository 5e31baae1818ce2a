"""The sort route at a depth-2 merge's width, on a CUDA card against the
CPU: one ``merge_many`` of a 100,000-entry raw block and full-capacity
layers of 300,000, 1,900,000 and 14,700,000 slots (the ``d4m-paper``
hierarchy's), about 60 % of all 17,000,000 slots sentinels, with
whole-number float32 values, so the card's sums are exact and its result
equals the CPU's bit for bit.  Run on the card's machine with
``PYTHONPATH=src python -m pytest tests/test_torch_sort_route_card.py``;
skipped where there is no card (its ``card`` marker is the one
``port_bench/conftest.py`` registers).
"""
import pytest
import torch

from repro_torch.core import assoc
from repro_torch.core import semiring as sr_mod
from repro_torch.kernels import registry

BLOCK = 100_000
CAPACITIES = (300_000, 1_900_000, 14_700_000)
LIVE_SHARE = 0.4
KEY_BITS = 12                # hi and lo in [0, 4096): 2**24 keys


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda")


def depth2_operands(seed: int):
    """(layers, block hi, lo, val) on the CPU: each layer canonical with
    ``LIVE_SHARE`` of its capacity live (distinct keys drawn from one key
    space, so the layers and the block share keys), the block raw, unsorted
    and with duplicates; values whole numbers in [40, 1500]."""
    g = torch.Generator().manual_seed(seed)
    mask = (1 << KEY_BITS) - 1

    def values(m):
        return torch.randint(40, 1501, (m,), generator=g).to(torch.float32)

    layers = []
    for cap in CAPACITIES:
        m = int(LIVE_SHARE * cap)
        key = torch.randperm(1 << 2 * KEY_BITS, generator=g)[:m].sort().values
        pad = torch.full((cap - m,), assoc.SENTINEL, dtype=torch.int32)
        layers.append(assoc.AssocSegment(
            hi=torch.cat([(key >> KEY_BITS).to(torch.int32), pad]),
            lo=torch.cat([(key & mask).to(torch.int32), pad]),
            val=torch.cat([values(m), torch.zeros(cap - m)]),
            nnz=torch.tensor(m, dtype=torch.int32)))
    key = torch.randint(0, 1 << 2 * KEY_BITS, (BLOCK,), generator=g)
    return (layers, (key >> KEY_BITS).to(torch.int32),
            (key & mask).to(torch.int32), values(BLOCK))


def merge_depth2(layers, hi, lo, val):
    """The depth-2 merge as the hierarchy makes it: into layer 2's
    capacity, with the kernel route asked for (its capacity rule sends
    this width to the sort route)."""
    return assoc.merge_many(layers, hi, lo, val, out_capacity=CAPACITIES[-1],
                            sr=sr_mod.PLUS_TIMES, use_kernel=True)


@pytest.mark.card
def test_depth2_sort_route_card_equals_cpu(cuda):
    layers, hi, lo, val = depth2_operands(2147483917)
    width = BLOCK + sum(CAPACITIES)
    live = sum(int(s.nnz) for s in layers) + BLOCK
    assert 0.58 < 1 - live / width < 0.62
    want, want_ovf = merge_depth2(layers, hi, lo, val)
    on_card = [assoc.AssocSegment(*(x.to(cuda) for x in (
        s.hi, s.lo, s.val, s.nnz))) for s in layers]
    before = registry.launches().get("assoc.sort_route", 0)
    got, ovf = merge_depth2(on_card, hi.to(cuda), lo.to(cuda), val.to(cuda))
    torch.cuda.synchronize()
    assert registry.launches()["assoc.sort_route"] == before + 1
    assert 0 < int(want.nnz) < CAPACITIES[-1] and int(want_ovf) == 0
    for f in ("hi", "lo", "val", "nnz"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert int(ovf) == 0
