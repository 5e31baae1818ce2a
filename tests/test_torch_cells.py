"""Port parity: ``repro_torch.launch.cells`` / ``dryrun`` / ``diagnose``
against ``repro.launch``'s, for the LM and D4M families.

* ``all_cells()``, ``scaled_cuts``, ``apply_variant``, ``_pad256`` and
  ``_kv_read_flops`` equal the reference's.
* ``meta`` of one train, one prefill and one decode LM cell and of every
  D4M cell equals the reference's ``lower_cell`` on a 1-device ``(1, 1)``
  JAX mesh (lowering only); the port's side is lowered on ``meta`` in a
  child process under a fake group of 1.
* Under a fake group of 4 (a child process): each LM arch's train cell at
  its smoke widths (batch 8 x 32) on a ``(4, 1)`` data-only mesh.  For the
  dense archs the per-device flops of the matrix products are exactly a
  quarter of the unsharded step's; the MoE archs route every token on each rank (``moe.py``'s
  ``replicate(xt)``), so theirs are more — the ratio found is held.  The
  argument bytes are the local shapes' bytes (``sharding.local_shape`` of
  every parameter's spec, the two float32 moments, the count and the
  batch).  The D4M ingest cell makes no collective; the query cell makes
  one all-reduce of the 32-bin int32 histogram.
* ``meta`` of every GNN cell (4 archs x 4 shapes) and of DCN-v2's four
  (``serve_bulk`` on the kernel route, ``use_kernel=1``) equals the
  reference's ``lower_cell`` on a ``(1, 1)`` JAX mesh; the ``hier``
  variant raises the reference's ``ValueError`` in both packages.
* Under the fake group of 4, on a ``(2, 2)`` mesh, each GNN kind's train
  cell and DCN-v2's train, serve and retrieval cells at smoke widths
  (DCN-v2's table given the six largest fields of the full config): the
  argument bytes are the specs' local shapes' bytes, every train cell
  makes collectives, and the vocab-parallel lookup gathers no more than a
  tenth of one rank's block of the table (its all-gathers are the ids and
  the batch-sized activations).
* ``dryrun.run_cell`` on the (16, 16) production mesh (a fake group of
  256, in a child process, on the CPU with the probes' check) writes the
  reference's keys for the D4M ``ingest_small`` cell and a ``long_500k``
  skip; the roofline's memory term is the recorded bytes over
  ``HW_H100["hbm_bw"]``, and the recorded flops (its sorts, compares and
  bit ops, counted as XLA counts the reference's) give a numeric useful
  fraction.
* ``diagnose.analyze`` on recorded text.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest

import torch_parity as tp
from repro.configs import get_config as jget_config
from repro.launch import cells as jcells
from repro_torch.configs import GNN_SHAPES, get_config, list_archs
from repro_torch.launch import cells, diagnose
from repro_torch.roofline import HW_H100

META_CELLS = [("smollm-360m", "train_4k"), ("smollm-360m", "prefill_32k"),
              ("mistral-nemo-12b", "decode_32k"),
              ("d4m-stream", "ingest_small"), ("d4m-stream", "ingest_paper"),
              ("d4m-stream", "ingest_wide"), ("d4m-stream", "query")]
# the reference's run_cell record keys (repro/launch/dryrun.py)
OK_KEYS = {"arch", "shape", "mesh", "variant", "n_devices", "status",
           "lower_s", "compile_s", "meta", "memory_analysis",
           "cost_analysis", "collective_bytes_per_device", "collectives",
           "hlo_ops", "raw", "probe_s", "corrected", "probes", "roofline",
           "model_flops", "useful_fraction", "fits_hbm", "total_s"}
SKIP_KEYS = {"arch", "shape", "mesh", "variant", "n_devices", "status",
             "reason", "total_s"}
# per-device / unsharded matrix flops of the MoE archs' smoke train cells on a
# (4, 1) mesh: every rank routes all 256 tokens and runs every expert's
# capacity, where the dense layers see a quarter of the batch
MOE_RATIO = {"granite-moe-3b-a800m": 42123264 / 104792064,
             "deepseek-v2-236b": 66846720 / 188743680}


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def test_all_cells_equal_the_reference():
    assert cells.all_cells() == jcells.all_cells()
    assert len([c for c in cells.all_cells() if c[0] != "d4m-stream"]) == 40


@pytest.mark.parametrize("cuts,block", [
    ((2048, 16384, 131072), 1024), ((2048, 16384, 131072), 8192),
    ((2048, 16384, 131072), 100_000), ((64, 256), 32), ((10, 20, 30), 7)])
def test_scaled_cuts_equal_the_reference(cuts, block):
    assert cells.scaled_cuts(cuts, block) == jcells.scaled_cuts(cuts, block)
    assert cells.scaled_cuts(cuts, block, 4) == \
        jcells.scaled_cuts(cuts, block, 4)


@pytest.mark.parametrize("arch,variant", [
    ("smollm-360m", "baseline"), ("smollm-360m", "num_microbatches=8"),
    ("granite-moe-3b-a800m", "remat=false,dtype=float32,n_layers=3"),
    ("deepseek-v2-236b", "capacity_factor=2.5,moe_shard=tp"),
    ("d4m-stream", "cuts=1024+8192,use_kernel=1,chunk=2")])
def test_apply_variant_equals_the_reference(arch, variant):
    got = cells.apply_variant(get_config(arch), variant)
    want = jcells.apply_variant(jget_config(arch), variant)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_small_helpers_equal_the_reference():
    for n in (1, 2048, 2708, 1_000_000, 61_859_140):
        assert cells._pad256(n) == jcells._pad256(n)
    for arch in ("smollm-360m", "deepseek-v2-236b", "mistral-nemo-12b"):
        for b, s in ((128, 32768), (1, 524288)):
            assert cells._kv_read_flops(get_config(arch), b, s) == \
                jcells._kv_read_flops(jget_config(arch), b, s)


# the 16 GNN and 4 recsys cells, serve_bulk on the kernel route
GNN_RECSYS_CELLS = [(a, s, "baseline") for a in list_archs("gnn")
                    for s in sorted(GNN_SHAPES)] + [
    ("dcn-v2", "train_batch", "baseline"), ("dcn-v2", "serve_p99", "baseline"),
    ("dcn-v2", "serve_bulk", "use_kernel=1"),
    ("dcn-v2", "retrieval_cand", "baseline")]


@pytest.fixture(scope="module")
def port_metas():
    return tp.run_child("dryrun_metas", META_CELLS + GNN_RECSYS_CELLS)


def _jax_meta(arch, shape, variant="baseline"):
    from jax.sharding import Mesh
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    with mesh:
        return jcells.lower_cell(arch, shape, mesh, variant)[1]


@pytest.mark.parametrize("arch,shape", META_CELLS)
def test_meta_equals_the_reference(port_metas, arch, shape):
    assert port_metas[f"{arch}:{shape}"] == _jax_meta(arch, shape)


@pytest.mark.parametrize("arch,shape,variant", GNN_RECSYS_CELLS)
def test_gnn_recsys_meta_equals_the_reference(port_metas, arch, shape,
                                              variant):
    assert port_metas[f"{arch}:{shape}:{variant}"] == \
        _jax_meta(arch, shape, variant)


def test_hier_variant_is_refused_in_both(train_cells):
    with pytest.raises(ValueError) as want:
        _jax_meta("dcn-v2", "train_batch", "hier")
    assert train_cells["hier"] == str(want.value)
    assert "not enough values to unpack" in train_cells["hier"]


@pytest.fixture(scope="module")
def train_cells():
    return tp.run_child("dryrun_train_cells")


@pytest.mark.parametrize("arch", tp.DENSE_ARCHS)
def test_dense_train_cell_flops_are_a_quarter(train_cells, arch):
    """The matrix products' flops exactly; the whole count, elementwise
    work too, is above them (every rank also repeats its replicated
    leaves' updates, so it is not a quarter exactly)."""
    row = train_cells["train41"][arch]
    assert row["cost"]["flops"] > row["matrix_flops"] > 0
    assert 4 * row["matrix_flops"] == row["unsharded"]["matrix_flops"]


@pytest.mark.parametrize("arch", tp.MOE_ARCHS)
def test_moe_train_cell_flops_ratio(train_cells, arch):
    row = train_cells["train41"][arch]
    ratio = row["matrix_flops"] / row["unsharded"]["matrix_flops"]
    assert ratio == MOE_RATIO[arch]
    assert 0.25 < ratio < 0.5


@pytest.mark.parametrize("arch", tp.DENSE_ARCHS + tp.MOE_ARCHS)
def test_train_cell_argument_bytes_are_the_local_shapes(train_cells, arch):
    row = train_cells["train41"][arch]
    assert row["arg_bytes"] == row["expected_arg_bytes"]
    assert sum(v["bytes"] for v in row["collectives"].values()) > 0
    assert 0 < row["peak_bytes"] < row["unsharded"]["peak bytes"]


def test_d4m_cells_collectives(train_cells):
    ingest, query = (train_cells["d4m"][s] for s in ("ingest_small",
                                                     "query"))
    assert ingest["collectives"] == {} and ingest["raw"]["coll"] == 0
    assert ingest["raw"]["bytes"] > 0 and ingest["raw"]["flops"] > 0
    assert query["collectives"] == {"all-reduce": dict(bytes=32 * 4,
                                                       count=1)}
    # a (2, 2) mesh: 4 ranks of 4 instances each, one rank recorded
    assert ingest["meta"]["n_instances"] == 16
    assert ingest["meta"]["updates"] == 16 * 8 * 1024
    assert ingest["arg_bytes"] > 0


def test_d4m_ingest_cell_has_flops_and_a_useful_fraction_in_both(
        train_cells):
    """The ``ingest_small`` cell: one rank's 4 instances of the (2, 2)
    mesh in the port, the 4 instances of a (1, 1) JAX mesh in the
    reference — the same per-device work.  Both count flops and give a
    useful fraction; their ratio is printed, not held: the port records
    every block of the stream where XLA counts the reference's ``scan``
    body once, and jnp's indexing adds clamp arithmetic the port does
    not do."""
    from jax.sharding import Mesh

    from repro.roofline.terms import useful_fraction as jfraction
    from repro_torch.roofline.terms import useful_fraction
    row = train_cells["d4m"]["ingest_small"]
    flops, meta = row["cost"]["flops"], row["meta"]
    fraction = useful_fraction(meta["model_flops"], flops * 4)
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    with mesh:
        low, jmeta = jcells.lower_cell("d4m-stream", "ingest_small", mesh)
        jcost = low.compile().cost_analysis()
    jcost = jcost[0] if isinstance(jcost, list) else jcost
    jflops = jcost["flops"]
    jfrac = jfraction(jmeta["model_flops"], jflops)
    assert flops > 0 and jflops > 0
    assert 0 < fraction < float("inf") and 0 < jfrac < float("inf")
    assert jmeta["model_flops"] * 4 == meta["model_flops"]
    print(f"ingest_small flops a device: port {flops:.0f}, reference "
          f"{jflops:.0f}, ratio {flops / jflops:.4f}; useful fraction "
          f"port {fraction:.4f}, reference {jfrac:.4f}")


@pytest.mark.parametrize("arch,shape", tp.GNN_CELLS + tp.RECSYS_CELLS)
def test_gnn_recsys_cell_argument_bytes_are_the_local_shapes(
        train_cells, arch, shape):
    row = train_cells["gnn"][f"{arch}:{shape}"]
    assert row["arg_bytes"] == row["expected"]["args"]
    assert row["cost"]["flops"] > 0 and row["peak_bytes"] > 0
    if row["meta"]["kind"] in ("full", "sampled", "batched", "train"):
        assert sum(v["bytes"] for v in row["collectives"].values()) > 0


@pytest.mark.parametrize("shape", [s for _, s in tp.RECSYS_CELLS])
def test_recsys_lookup_gathers_no_table(train_cells, shape):
    row = train_cells["gnn"][f"dcn-v2:{shape}"]
    block = row["expected"]["table"]
    assert block > 10 * 2**20              # one rank's rows: tens of MiB
    gathered = row["collectives"]["all-gather"]["bytes"]
    assert 0 < 10 * gathered < block


@pytest.fixture(scope="module")
def dryrun_records(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    return out, tp.run_child("dryrun_cells_run", out)


def test_run_cell_writes_the_reference_keys(dryrun_records):
    out, recs = dryrun_records
    ok = recs["d4m-stream:ingest_small"]
    assert ok["status"] == "ok", ok.get("traceback")
    assert set(ok) == OK_KEYS
    assert ok["n_devices"] == 256 and ok["mesh"] == "single"
    assert set(ok["memory_analysis"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes",
        "generated_code_size_in_bytes"}
    assert set(ok["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                   "dominant"}
    assert ok["roofline"]["dominant"] == "memory"
    # the roofline is the recording's; the probes' extrapolation is a check
    assert ok["roofline"]["memory_s"] == ok["raw"]["bytes"] / HW_H100["hbm_bw"]
    assert 0 < ok["corrected"]["bytes"] < ok["raw"]["bytes"]
    assert ok["raw"]["flops"] > 0 and ok["useful_fraction"] > 0
    assert ok["collective_bytes_per_device"] == 0
    assert set(ok["probes"]) == {"ingest_T1", "ingest_T2"}
    assert ok["meta"]["n_instances"] == 1024 and ok["fits_hbm"] is True
    skip = recs["smollm-360m:long_500k"]
    assert skip["status"] == "skip" and set(skip) == SKIP_KEYS
    assert "sub-quadratic" in skip["reason"]
    with open(os.path.join(out, "single",
                           "d4m-stream__ingest_small.json")) as f:
        assert json.load(f)["status"] == "ok"


def test_diagnose_analyze(capsys):
    text = "\n".join([
        "# entry cells.lm_train kind eager",
        "aten.mm.default(bfloat16[8, 64], bfloat16[64, 64]) -> "
        "(bfloat16[8, 64])",
        "_c10d_functional.all_gather_into_tensor.default(float32[4, 16]) "
        "-> (float32[8, 16])",
        "_c10d_functional.wait_tensor.default(float32[8, 16]) -> "
        "(float32[8, 16])",
        "aten.mm.default(float32[8, 16], float32[16, 1024]) -> "
        "(float32[8, 1024])",
        "kernel hier_merge.merge_multi bytes=64"])
    got = diagnose.analyze(text, top=2)
    assert got["tensors"] == [(8 * 1024 * 4, "float32[8, 1024]", "mm"),
                              (8 * 64 * 2, "bfloat16[8, 64]", "mm")]
    assert got["collectives"] == {"all-gather": (8 * 16 * 4, 1)}
    assert got["ops"] == {"mm": 2, "all_gather_into_tensor": 1,
                          "wait_tensor": 1}
    printed = capsys.readouterr().out
    assert "== collectives (per-device result bytes) ==" in printed
