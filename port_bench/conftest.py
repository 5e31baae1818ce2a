"""The benchmark's tests: CPU tests at tiny sizes, and ``card`` tests that
run a cell on a CUDA card (``python -m pytest -m card port_bench`` on the
card's machine; skipped elsewhere, decided inside the ``cuda`` fixture)."""
from __future__ import annotations

import pytest

TINY = dict(
    name="tiny", instances=3, block=16, cuts=[32, 128, 512],
    capacities=[48, 176, 688], epoch_blocks=16, blocks_per_call=4,
    rmat_scale=8, rmat_params=[0.57, 0.19, 0.19, 0.05],
    semiring="plus.times", value_dtype="float32", values=[40, 1500],
    fused=True, lazy_l0=True, batch_mode="grouped", use_kernel=True,
    query_l0_mode="auto", query_batch=8,
    reference="port_bench/reference.py")

TINY_TRAFFIC = {
    "ingest": dict(streams=2, warmup_blocks=8, queries=None,
                   trace_seconds=0.3),
    "mixed": dict(streams=2, warmup_blocks=8,
                  queries=dict(rate_per_s=40.0, rmat_share=0.5, key_sets=4),
                  trace_seconds=0.3),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda")


@pytest.fixture
def no_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
