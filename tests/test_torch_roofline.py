"""Port parity: ``repro_torch.roofline`` against ``repro.roofline``, and
the recorder's per-device count under DTensor.

* ``parse_hlo_collectives`` / ``collective_bytes_by_type`` / ``count_op``
  on the port's text format (``stages.Compiled.as_text()``: one recorded
  op a line) — the reference's ``test_roofline_parse.py`` cases: every
  kind's per-device result bytes, a two-tensor result, non-collectives
  (``wait_tensor``, ``_wrap_tensor_autograd``, an ``add``) not counted,
  and a collective with no kind of the reference's under its own name.
* ``HW_H100``'s values, the roofline terms and their dominance, and
  ``model_flops_lm`` / ``useful_fraction`` equal to the reference's.
* Under a fake process group of 4 (in a child process, so that no test
  worker keeps a group): a ``(2, 2)`` sharded matmul recorded on the CPU
  and on ``meta`` counts one rank's share — the local flops
  (2 * 32 * 8 * 16), one all-gather whose bytes are its per-device result
  (16 x 16 float32), the local argument bytes and a peak above 0 on
  ``meta``; ``signature_of`` takes a ``DeviceMesh`` as the reference takes
  a ``Mesh``; ``replicate_grad`` / ``grad_as_forward`` are identities
  whose backward puts the gradient under the asked placements.
* An unsharded call is recorded as before, each op's tensors read and
  written once; its flops are ``FlopCounterMode``'s for the product and
  one a element for the ``relu``, as XLA counts the reference's
  ``jnp.maximum(x @ y, 0)``.
* Arguments kept for a recording live with the caller's ``Lowered`` /
  ``Compiled``: another lowering of the key leaves them as they were, and
  dropping the caller's objects frees them.
"""
import gc
import types
import weakref

import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.roofline import terms as jterms
from repro_torch import stages
from repro_torch.analysis import tracekit
from repro_torch.roofline import HW_H100, hlo, roofline_terms
from repro_torch.roofline.terms import (H100_F32_FLOPS, model_flops_lm,
                                        useful_fraction)

TEXT = """# entry test.step kind eager
aten.mm.default(bfloat16[2, 512, 128], bfloat16[128, 128]) -> (bfloat16[2, 512, 128])
_c10d_functional.all_gather_into_tensor.default(bfloat16[2, 512, 128]) -> (bfloat16[2, 512, 2048])
_c10d_functional.wait_tensor.default(bfloat16[2, 512, 2048]) -> (bfloat16[2, 512, 2048])
_c10d_functional.all_reduce.default(float32[1024]) -> (float32[1024])
_c10d_functional._wrap_tensor_autograd.default(float32[1024]) -> (float32[1024])
_c10d_functional.reduce_scatter_tensor.default(float32[128, 32]) -> (float32[64, 32])
_c10d_functional.all_to_all_single.default(bfloat16[16, 64]) -> (bfloat16[16, 64])
c10d.broadcast_.default(uint8[128]) -> (uint8[128])
c10d.allreduce_.default(float32[8], float32[8]) -> (float32[8], float32[8])
c10d._allgather_base_.default(float32[4], float32[2]) -> (float32[4])
c10d._reduce_scatter_base_.default(float32[2], float32[4]) -> (float32[2])
aten.add.Tensor(float32[9], float32[9]) -> (float32[9])
kernel hier_merge.merge_multi bytes=4096
host_read item at core/stream.py:320"""


def test_parse_collectives_by_type():
    parsed = hlo.parse_hlo_collectives(TEXT)
    assert parsed["all-gather"] == dict(bytes=2 * 512 * 2048 * 2 + 4 * 4,
                                        count=2)
    assert parsed["all-reduce"] == dict(bytes=1024 * 4 + 2 * 8 * 4, count=2)
    assert parsed["reduce-scatter"] == dict(bytes=64 * 32 * 4 + 2 * 4,
                                            count=2)
    assert parsed["all-to-all"] == dict(bytes=16 * 64 * 2, count=1)
    assert parsed["broadcast_"] == dict(bytes=128, count=1)
    assert set(parsed) == {"all-gather", "all-reduce", "reduce-scatter",
                           "all-to-all", "broadcast_"}
    total, by_type = hlo.collective_bytes_by_type(TEXT)
    assert total == sum(v["bytes"] for v in parsed.values())
    assert by_type == {k: v["bytes"] for k, v in parsed.items()}
    assert hlo.count_op(TEXT, "mm") == 1
    assert hlo.count_op(TEXT, "add") == 1
    assert hlo.count_op(TEXT, "fusion") == 0
    assert hlo.collective_bytes_by_type("") == (0, {})


def test_hw_h100_is_the_data_sheets():
    assert set(HW_H100) == set(jterms.HW_V5E)
    assert HW_H100 == dict(name="h100_sxm", peak_flops=989e12,
                           hbm_bw=3.35e12, link_bw=450e9, hbm_bytes=80e9)
    assert H100_F32_FLOPS == 67e12


def test_roofline_terms_and_dominance():
    t = roofline_terms(flops_per_device=989e12,
                       hbm_bytes_per_device=3.35e12,
                       collective_bytes_per_device=225e9)
    np.testing.assert_allclose(t.compute_s, 1.0)
    np.testing.assert_allclose(t.memory_s, 1.0)
    np.testing.assert_allclose(t.collective_s, 0.5)
    assert t.dominant in ("compute", "memory") and t.bound_s == 1.0
    assert roofline_terms(1e12, 1e9, 500e9).dominant == "collective"
    f32 = roofline_terms(67e12, 0, 0, hw=dict(HW_H100,
                                              peak_flops=H100_F32_FLOPS))
    np.testing.assert_allclose(f32.compute_s, 1.0)
    assert set(t.as_dict()) == set(jterms.roofline_terms(1, 1, 1).as_dict())
    # the same arithmetic as the reference's at the same hardware dict
    for args in ((3e12, 5e9, 7e8), (0.0, 1.0, 0.0)):
        got = roofline_terms(*args, hw=jterms.HW_V5E).as_dict()
        assert got == jterms.roofline_terms(*args).as_dict()


@pytest.mark.parametrize("n,na,tokens,train", [
    (100, 50, 10, True), (100, 50, 10, False),
    (361_821_120, 361_821_120, 1_048_576, True),
    (3_298_793_472, 800_000_000, 128, False)])
def test_model_flops_and_useful_fraction_equal_the_reference(n, na, tokens,
                                                             train):
    assert model_flops_lm(n, na, tokens, train) == \
        jterms.model_flops_lm(n, na, tokens, train)
    for hlo_flops in (0.0, 1.0, 2.5e15):
        got = useful_fraction(model_flops_lm(n, na, tokens, train),
                              hlo_flops)
        assert got == jterms.useful_fraction(
            jterms.model_flops_lm(n, na, tokens, train), hlo_flops)
    assert useful_fraction(50.0, 100.0) == 0.5


@pytest.fixture(scope="module")
def recorded():
    return tp.run_child("dryrun_recorder_checks")


@pytest.mark.parametrize("dev", ["cpu", "meta"])
def test_sharded_matmul_counts_one_rank(recorded, dev):
    """A (64, 16) Shard(0) x Shard(1) by a (16, 16) Shard(0) x Replicate()
    matmul: DTensor all-gathers the right operand's rows over the data
    axis; the recorder sees the local mm and the all-gather's
    per-device result."""
    row = recorded["matmul"][dev]
    assert row["cost"]["flops"] == 2 * 32 * 8 * 16
    assert row["collectives"] == {"all-gather": dict(bytes=16 * 16 * 4,
                                                     count=1)}
    assert row["arg_bytes"] == (32 * 8 + 8 * 16) * 4
    assert row["peak_bytes"] > 0
    assert "aten.mm.default(float32[32, 8], float32[8, 16]) -> " \
        "(float32[32, 16])" in row["text"]
    # no op at the global shape: the sharding propagation is not recorded
    assert "[64, 16]" not in row["text"]
    assert row["analysis"]["collectives"] == {"all-gather": (1024, 1)}
    assert row["analysis"]["tensors"][0] == (2048, "float32[32, 16]", "mm")


def test_signature_of_takes_a_device_mesh(recorded):
    from repro import stages as jstages
    for key, shape in (("sig22", (2, 2)), ("sig41", (4, 1))):
        ref = types.SimpleNamespace(axis_names=("data", "model"),
                                    devices=np.zeros(shape))
        assert recorded[key] == jstages.signature_of(mesh=ref).mesh
    assert recorded["sig22"] == (("data", 2), ("model", 2))


def test_grad_placements(recorded):
    got = recorded["grad_to"]
    assert got["forward"] == ["R", "R", "S(0)", "R"]
    assert got["same"] and got["plain"]
    assert got["backward"] == ["R", "R"]


def test_unsharded_recording_is_flop_counter_and_bytes():
    a, b = torch.ones(6, 4), torch.ones(4, 5)
    w = stages.wrap(lambda x, y: (x @ y).relu(), "test.plain_mm",
                    stages.signature_of())
    comp = w.lower(a, b).compile()
    tracekit.record_compiled(comp, (a, b))
    cost = comp.cost_analysis()
    assert cost["flops"] == 2 * 6 * 4 * 5 + 6 * 5
    assert cost["bytes accessed"] == (24 + 20 + 30) * 4 + (30 + 30) * 4
    mem = comp.memory_analysis()
    assert mem.argument_size_in_bytes == (24 + 20) * 4
    assert mem.output_size_in_bytes == 30 * 4
    meta = tuple(torch.empty(t.shape, device="meta") for t in (a, b))
    tracekit.record_compiled(comp, meta)
    assert comp.cost_analysis()["flops"] == 2 * 6 * 4 * 5 + 6 * 5
    assert comp.memory_analysis().argument_size_in_bytes == (24 + 20) * 4
    assert comp.memory_analysis().temp_size_in_bytes > 0


def test_a_model_argument_counts_and_is_not_moved():
    """A ``ParamTree`` argument's parameters count in the argument bytes,
    and the recorded call runs on a copy of it."""
    from repro_torch.models import common
    params = common.ParamTree(dict(w=torch.ones(3, 2)))

    def step(p, x):
        p.w.add_(1.0)
        return x @ p.w

    w = stages.wrap(step, "test.param_step", stages.signature_of())
    comp = w.lower(params, torch.ones(4, 3), keep_args=True).compile()
    assert comp.memory_analysis().argument_size_in_bytes == (6 + 12) * 4
    assert torch.equal(params.w, torch.ones(3, 2))


def test_kept_arguments_live_with_the_caller():
    w = stages.wrap(lambda x: (x * 2).sum(), "test.kept_args",
                    stages.signature_of())
    x = torch.ones(1000)
    ref = weakref.ref(x)
    comp = w.lower(x, keep_args=True).compile()
    assert comp.cost_analysis()["bytes accessed"] > 0
    recorded = comp.recorded
    other = w.lower(torch.zeros(1000), keep_args=True).compile()
    other.cost_analysis()
    assert comp.args[0] is x and comp.recorded is recorded
    assert other is not comp and other.args[0] is not x
    cached = w.lower(x).compile()
    assert cached is w.lower(x).compile() and cached.args is None
    del x, comp, other
    gc.collect()
    assert ref() is None
