"""Port parity: ``repro_torch.distribution.sharding`` against
``repro.distribution.sharding``, and the port's production meshes.

* The spec trees: ``lm_param_specs`` for the five LM full configs (and
  granite-moe's expert-TP ``moe_shard="tp"``, deepseek-v2's ``"ep"``),
  ``recsys_param_specs`` for DCN-v2 and ``gnn_param_specs`` for GraphCast
  (``d_feat`` 100, ``n_out`` its variables: the reference's
  ``graphcast/ogb_products`` cell), at the ``(16, 16)`` and ``(2, 16,
  16)`` production meshes under layouts ``"2d"`` and ``"dp"``: the port's
  ``Spec`` equals the reference's ``PartitionSpec`` leaf for leaf, by the
  same path.  The reference's side is ``jax.eval_shape`` of its init and a
  stand-in mesh (``shape`` and ``axis_names``), so no 256 devices are
  needed; the port's is its init on the ``meta`` device and a stand-in
  ``DeviceMesh`` (``mesh_dim_names`` and ``shape``).
* ``resolve`` / ``spec`` / ``axis_size`` equal the reference's; placements
  of a spec; the spec's local-shape arithmetic.
* ``constrain`` without a policy returns its input itself; under a
  policy a plain tensor raises.  (A policy over real ranks, the dropped
  non-dividing axis and the executed step: ``test_torch_mesh2d.py``.)
* ``make_production_mesh`` builds under a fake process group (``FakeStore``,
  backend ``"fake"``) at world size 256 and 512, in a subprocess (the
  group is process-global), every leaf's local shard of the five LM
  configs, DCN-v2 and GraphCast on ``meta`` equal to its spec's
  arithmetic; it raises, naming the shape and the world size, at any
  other world size or with no process group.
"""
import os
import subprocess
import sys
import types

import jax
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.distribution import sharding as jsh
from repro.models import dcn as jdcn
from repro.models import gnn as jgnn
from repro.models import transformer as jtf
from repro_torch.configs.registry import get_config
from repro_torch.distribution import sharding as sh
from repro_torch.models import dcn, gnn
from repro_torch.models import transformer as tf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_ARCHS = ("deepseek-v2-236b", "granite-moe-3b-a800m", "mistral-nemo-12b",
            "phi3-mini-3.8b", "smollm-360m")
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
GRAPHCAST_D_FEAT = 100          # GNN_SHAPES["ogb_products"]["d_feat"]
CASES = [(arch, None) for arch in LM_ARCHS]
CASES += [("granite-moe-3b-a800m", "tp"), ("deepseek-v2-236b", "ep"),
          ("dcn-v2", None), ("graphcast", None)]


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def _jmesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes)


class _Mesh:
    """The names and sizes of a ``DeviceMesh``: all the spec rules read."""

    def __init__(self, name):
        self.shape, self.mesh_dim_names = MESHES[name]


def _flatten(tree, is_leaf, path=""):
    if is_leaf(tree):
        return {path: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flatten(v, is_leaf, f"{path}/{k}" if path else str(k)))
    return out


def _replace(cfg, moe_shard):
    import dataclasses
    return cfg if moe_shard is None else dataclasses.replace(
        cfg, moe_shard=moe_shard)


def _specs_pair(arch, moe_shard, mesh_name, layout):
    """(reference specs, port specs), each flattened to path -> tuple."""
    jpol = jsh.make_policy(_jmesh(mesh_name), layout)
    tpol = sh.make_policy(_Mesh(mesh_name), layout)
    jcfg = _replace(jget_config(arch), moe_shard)
    tcfg = _replace(get_config(arch), moe_shard)
    key = jax.random.PRNGKey(0)
    if arch == "dcn-v2":
        jp = jax.eval_shape(lambda k: jdcn.init(k, jcfg), key)
        jspecs = jsh.recsys_param_specs(jp, jcfg, jpol)
        tspecs = sh.recsys_param_specs(dcn.init(0, tcfg, device="meta"),
                                       tcfg, tpol)
    elif arch == "graphcast":
        args = (GRAPHCAST_D_FEAT, jcfg.n_vars)
        jp = jax.eval_shape(lambda k: jgnn.init(k, jcfg, *args), key)
        jspecs = jsh.gnn_param_specs(jp, jcfg, jpol)
        tspecs = sh.gnn_param_specs(gnn.init(0, tcfg, *args, device="meta"),
                                    tcfg, tpol)
    else:
        jp = jax.eval_shape(lambda k: jtf.init(k, jcfg), key)
        jspecs = jsh.lm_param_specs(jp, jcfg, jpol)
        tspecs = sh.lm_param_specs(tf.init(0, tcfg, device="meta"), tcfg,
                                   tpol)
    want = _flatten(jspecs, lambda x: isinstance(x, jsh.P))
    got = _flatten(tspecs, lambda x: isinstance(x, sh.Spec))
    return ({k: tuple(v) for k, v in want.items()},
            {k: tuple(v) for k, v in got.items()})


@pytest.mark.parametrize("layout", ("2d", "dp"))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch,moe_shard", CASES,
                         ids=[f"{a}-{m or 'cfg'}" for a, m in CASES])
def test_param_specs_match_reference(arch, moe_shard, mesh_name, layout):
    want, got = _specs_pair(arch, moe_shard, mesh_name, layout)
    assert sorted(got) == sorted(want)
    for path in want:
        assert got[path] == want[path], (path, got[path], want[path])
    # the rules shard something at full width (a tree of None would pass
    # the comparison only if both packages sharded nothing)
    assert any(any(e is not None for e in s) for s in got.values())


def test_moe_rules_differ_between_ep_and_expert_tp():
    """deepseek-v2's experts go over "model" under ``"ep"``, their inner
    dims under ``"tp"`` (its 160 experts divide 16)."""
    _, ep = _specs_pair("deepseek-v2-236b", "ep", "pod", "2d")
    _, etp = _specs_pair("deepseek-v2-236b", "tp", "pod", "2d")
    assert ep["layers/ffn/w_gate"] == (None, "model", "data", None)
    assert etp["layers/ffn/w_gate"] == (None, None, "data", "model")
    assert ep["layers/ffn/w_down"] == (None, "model", None, "data")


@pytest.mark.parametrize("layout", ("2d", "dp"))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_policy_matches_reference(mesh_name, layout):
    jpol = jsh.make_policy(_jmesh(mesh_name), layout)
    tpol = sh.make_policy(_Mesh(mesh_name), layout)
    assert (tpol.batch_axes, tpol.fsdp_axis, tpol.tp_axis) == \
        (jpol.batch_axes, jpol.fsdp_axis, jpol.tp_axis)
    for logical in (None, "batch", "fsdp", "tp", "ep", "all"):
        assert tpol.resolve(logical) == jpol.resolve(logical)
        if logical is not None:
            assert tpol.axis_size(logical) == jpol.axis_size(logical)
    spec = ("batch", None, "tp")
    assert tuple(tpol.spec(*spec)) == tuple(jpol.spec(*spec))
    with pytest.raises(ValueError, match="unknown logical axis"):
        tpol.resolve("heads")
    with pytest.raises(ValueError, match="unknown layout"):
        sh.make_policy(_Mesh(mesh_name), "3d")


def test_placements_and_local_shape():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _Mesh("multipod")
    assert sh.to_placements(sh.Spec(("pod", "data"), None), mesh) == \
        (Shard(0), Shard(0), Replicate())
    assert sh.to_placements(sh.Spec("model", "data"), mesh) == \
        (Replicate(), Shard(1), Shard(0))
    assert sh.to_placements(sh.Spec(None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        sh.to_placements(sh.Spec(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="shards two dims"):
        sh.to_placements(sh.Spec("data", "data"), mesh)
    sizes = dict(pod=2, data=16, model=16)
    assert sh.local_shape((64, 48), sh.Spec(("pod", "data"), "model"),
                          sizes) == (2, 3)
    # torch.chunk's cut: 10 rows over 4 -> 3, 3, 3, 1
    assert [sh.local_shape((10,), sh.Spec("data"), dict(data=4),
                           dict(data=c))[0] for c in range(4)] == [3, 3, 3, 1]


def test_constrain_without_policy_is_identity():
    x = torch.randn(4, 6)
    assert sh.current_policy() is None
    assert sh.constrain(x, "batch", "tp") is x
    assert sh.replicate(x) is x
    assert sh.like(x, torch.zeros(2)) is x


def test_constrain_refuses_plain_tensor_under_policy():
    pol = sh.make_policy(_Mesh("pod"))
    with sh.use_policy(pol):
        assert sh.current_policy() is pol
        with pytest.raises(TypeError, match="takes a DTensor"):
            sh.constrain(torch.zeros(32, 4), "batch", None)
    assert sh.current_policy() is None


PRODUCTION_CHILD = """
import sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
sys.path.insert(0, {src!r})
from repro_torch.launch import mesh as mesh_mod
world, multi_pod = {world}, {multi_pod}
dist.init_process_group("fake", store=FakeStore(), rank=0,
                        world_size=world)
try:
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod, device="cpu")
except RuntimeError as e:
    print("RAISED", e)
else:
    print("BUILT", tuple(mesh.shape), mesh.mesh_dim_names)
    sys.path.insert(0, {repo!r})
    import chip_smoke
    n = chip_smoke.production_shapes_check(torch, mesh)
    print("LEAVES", n)
dist.destroy_process_group()
"""


def _production_child(world, multi_pod):
    code = PRODUCTION_CHILD.format(src=os.path.join(REPO, "src"), repo=REPO,
                                   world=world, multi_pod=multi_pod)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.mark.parametrize("world,multi_pod,shape", [
    (256, False, (16, 16)), (512, True, (2, 16, 16))])
def test_production_mesh_builds_under_fake_group(world, multi_pod, shape):
    out = _production_child(world, multi_pod)
    assert f"BUILT {shape}" in out, out
    leaves = int(out.split("LEAVES")[1].split()[0])
    assert leaves > 100, out


@pytest.mark.parametrize("world,multi_pod", [(255, False), (512, False),
                                             (256, True)])
def test_production_mesh_refuses_other_world_sizes(world, multi_pod):
    out = _production_child(world, multi_pod)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    assert f"RAISED production mesh {shape}" in out, out
    assert f"has {world}" in out, out


def test_production_mesh_needs_a_process_group():
    from repro_torch.launch import mesh as mesh_mod
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match=r"\(16, 16\).*has none"):
        mesh_mod.make_production_mesh(device="cpu")


def test_sharded_stream_takes_a_device_or_a_sharding():
    from repro_torch.data import pipeline
    pol = sh.make_policy(_Mesh("pod"))
    with pytest.raises(ValueError, match="not both"):
        pipeline.ShardedStream(iter([]), device="cpu",
                               sharding=pol.sharding("batch"))
    batch = {"tokens": torch.arange(6).reshape(2, 3)}
    got = next(pipeline.ShardedStream(iter([batch]), device="cpu"))
    assert torch.equal(got["tokens"], batch["tokens"])


def test_under_current_policy_carries_the_policy_to_another_thread():
    """A checkpointed layer's recompute runs on autograd's device thread
    for CUDA tensors, where the caller's contextvar is unset."""
    import threading
    pol = sh.make_policy(_Mesh("pod"))
    seen = []
    with sh.use_policy(pol):
        wrapped = sh.under_current_policy(sh.current_policy)
        t = threading.Thread(target=lambda: seen.extend(
            [sh.current_policy(), wrapped()]))
        t.start()
        t.join()
    assert seen == [None, pol]
