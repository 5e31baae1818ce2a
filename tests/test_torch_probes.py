"""The port's layer and block probes (``repro_torch.launch.probes``) and
the tiny production mesh (the counterpart of
``tests/test_multidevice.py::test_tiny_production_mesh_lowering``).

* Under a fake group of 4 (a child process), on a ``(2, 2)`` mesh: LM
  cells at 5 layers of their smoke widths (smollm's and granite-moe's
  train step, phi3-mini's prefill, deepseek-v2's decode; batch 8 x 32)
  recorded whole, and the reference's layer probes (the same cell at 2
  and 3 layers) extrapolated, ``p3 + (L - 3)(p3 - p2)``: flops,
  collective bytes and bytes equal exactly (tolerance 0).  Every layer
  adds the same ops and collectives: ``transformer._layers`` reduces each
  layer's gradient to its parameter's sharding, so the stacked
  gradient's collectives do not follow L's parity, and the recorder
  leaves out the ops DTensor's sharding propagation runs on a cache miss,
  which only the first call of each placement makes.  The D4M ingest
  cell's block probes (1 and 2 updates): no collective either way;
  ingest is data-dependent (spills come later in the stream), so the
  extrapolation from its first two updates counts fewer flops and bytes
  than the cell.
* Under a fake group of 8: mistral-nemo's smoke config at
  ``num_microbatches=2`` on a ``(2, 2, 2)`` ``("pod", "data", "model")``
  mesh through ``cells.lower_cell``: collective bytes > 0, of the kinds
  FSDP x TP makes.
"""
import pytest

import torch_parity as tp

LM_PROBES = ("smollm-360m:train_4k", "granite-moe-3b-a800m:train_4k",
             "phi3-mini-3.8b:prefill_32k", "deepseek-v2-236b:decode_32k")


@pytest.fixture(scope="module")
def probed():
    return tp.run_child("dryrun_probe_checks")


@pytest.mark.parametrize("cell", LM_PROBES)
def test_layer_probes_extrapolate_to_the_recording(probed, cell):
    got = probed[cell]
    raw, corr = got["raw"], got["corrected"]
    kind = cell.split(":")[1].split("_")[0]
    assert set(got["probes"]) == {f"{kind}_L2", f"{kind}_L3"}
    assert raw["flops"] > 0 and raw["coll"] > 0
    assert corr == raw
    p2, p3 = (got["probes"][f"{kind}_L{n}"] for n in (2, 3))
    assert p3["flops"] > p2["flops"]


def test_block_probes_of_ingest(probed):
    got = probed["d4m-stream:ingest_small"]
    raw, corr = got["raw"], got["corrected"]
    assert set(got["probes"]) == {"ingest_T1", "ingest_T2"}
    assert 0 < corr["flops"] < raw["flops"]
    assert corr["coll"] == raw["coll"] == 0
    assert 0 < corr["bytes"] < raw["bytes"]


@pytest.fixture(scope="module")
def tiny():
    return tp.run_child("dryrun_tiny_production")


def test_tiny_production_mesh_lowering(tiny):
    assert tiny["total"] > 0
    assert {"all-gather", "all-reduce", "reduce-scatter"} <= \
        set(tiny["by_type"])
    assert all(b > 0 for b in tiny["by_type"].values())
    assert tiny["tokens"] == tp.DRY_BATCH * tp.DRY_SEQ
