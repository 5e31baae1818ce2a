"""Shared helpers of the ``test_torch_*.py`` parity tests.

The port (``repro_torch``) and the JAX package (``repro``) are fed the same
numpy-built inputs; these helpers carry states between the two through the
port's numpy converter (keyed by the JAX pytree's leaf names) and compare
results: keys, nnz, spills, overflow and counters exactly, values exactly
or within the registry's merge rtol (1e-4) where float sums may be taken in
another order.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import hier as thier

RTOL = 1e-4   # registry merge rtol: float sums are taken in another order


def jax_state_to_numpy(h) -> dict:
    """A JAX ``HierAssoc`` (single or batched) as the converter's dict."""
    d = {}
    for i, l in enumerate(h.layers):
        for f in ("hi", "lo", "val", "nnz"):
            d[f"layers[{i}].{f}"] = np.asarray(getattr(l, f))
    d["spills"] = np.asarray(h.spills)
    d["overflow"] = np.asarray(h.overflow)
    d["n_updates"] = np.asarray(h.n_updates)
    d["n_updates_hi"] = np.asarray(h.n_updates_hi)
    d["cuts"] = tuple(h.cuts)
    return d


def to_torch(h):
    """A JAX state carried into the port, on the CPU."""
    return thier.state_from_numpy(jax_state_to_numpy(h), device="cpu")


def assert_vals(got, want, exact: bool, what: str = "val") -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if exact or got.dtype.kind != "f":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=what)
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=what)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=1e-6,
                               err_msg=what)


def assert_segment_equal(tseg, jseg, exact: bool = True) -> None:
    """A port ``AssocSegment`` against a JAX one."""
    for f in ("hi", "lo", "nnz"):
        np.testing.assert_array_equal(getattr(tseg, f).numpy(),
                                      np.asarray(getattr(jseg, f)),
                                      err_msg=f)
    assert_vals(tseg.val.numpy(), np.asarray(jseg.val), exact)


def assert_states_equal(tstate, jstate, exact: bool = True) -> None:
    """Every leaf of a port state against a JAX state."""
    a = thier.state_to_numpy(tstate)
    b = jax_state_to_numpy(jstate)
    assert a.keys() == b.keys()
    for k in a:
        if k.endswith(".val"):
            assert_vals(a[k], b[k], exact, k)
        elif k == "cuts":
            assert a[k] == b[k]
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def assert_telemetry_equal(ttel: dict, jtel: dict) -> None:
    assert ttel.keys() == jtel.keys()
    for k in ttel:
        if isinstance(ttel[k], dict):
            assert_telemetry_equal(ttel[k], jtel[k])
        else:
            np.testing.assert_array_equal(ttel[k].numpy(),
                                          np.asarray(jtel[k]), err_msg=k)


def stream(seed: int, shape, nkeys: int, integer_vals: bool = True):
    """A numpy COO block stream of ``shape`` (..., B): int32 keys in
    [0, nkeys), float32 values (integer-valued unless told otherwise)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, nkeys, shape).astype(np.int32)
    cols = rng.integers(0, nkeys, shape).astype(np.int32)
    vals = (rng.integers(1, 4, shape) if integer_vals
            else rng.normal(size=shape)).astype(np.float32)
    return rows, cols, vals


def both(*arrays):
    """numpy arrays -> (jax arrays, torch CPU tensors)."""
    import jax.numpy as jnp
    return (tuple(jnp.asarray(a) for a in arrays),
            tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays))


def _numpy_tree(x):
    """Tensors (nested in dicts) as numpy arrays."""
    if isinstance(x, dict):
        return {k: _numpy_tree(v) for k, v in x.items()}
    return x.cpu().numpy()


def run_fleet_jobs(mesh, jobs):
    """A rank's body for ``launch.mesh.spawn_fleet``: run every job of
    ``jobs`` (``(kind, knobs, inputs)``; fleet-wide numpy inputs, the
    state as the converter's dict) on this rank's block through the port's
    sharded functions, in order, so every rank makes the same collectives.
    Returns one numpy result per job."""
    from repro_torch.core import distributed as tdist
    from repro_torch.core import semiring as tsr
    torch.set_num_threads(1)
    axes = ("data",)
    out = []
    for kind, knobs, inputs in jobs:
        states = tdist.shard(mesh, thier.state_from_numpy(
            inputs["states"], device=mesh.device))
        knobs = dict(knobs)
        if "sr" in knobs:
            knobs["sr"] = tsr.get(knobs["sr"])
        if kind == "ingest":
            rows, cols, vals = (tdist.shard(mesh, torch.from_numpy(x))
                                for x in inputs["stream"])
            got, tel = tdist.sharded_ingest_fn(mesh, axes, **knobs)(
                states, rows, cols, vals)
            out.append((thier.state_to_numpy(got), _numpy_tree(tel)))
        elif kind == "query":
            q_rows, q_cols = map(torch.from_numpy, inputs["queries"])
            out.append(tdist.sharded_query_fn(mesh, axes, **knobs)(
                states, q_rows, q_cols).numpy())
        elif kind == "histogram":
            out.append(tdist.global_degree_histogram_fn(mesh, axes, **knobs)(
                states).numpy())
        elif kind == "count":
            out.append(tdist.aggregate_update_counts_fn(mesh, axes)(states))
        else:
            raise ValueError(f"unknown fleet job {kind!r}")
    return out


def run_mesh_jobs(fleet, jobs):
    """A rank's body for ``launch.mesh.spawn_fleet`` running the sharding
    layer's jobs in order (every rank makes the same collectives); each
    job is ``(kind, inputs)``:

    * ``"lm_step"``: one ``transformer.make_train_step`` step of
      ``inputs["arch"]``'s smoke config on a (2, 2) ``("data", "model")``
      CPU mesh under ``make_policy``, from the numpy parameter tree
      ``inputs["tree"]`` placed by ``to_shardings(lm_param_specs(...))``
      and the batch placed under ``batch_sharding`` by ``ShardedStream``;
      returns the loss, gnorm, the batch's local shape,
      every parameter gathered (numpy, by path) and every leaf's
      (path, local shape, spec's local shape);
    * ``"constrain"``: ``constrain`` of a replicated [6, 4] and a [5, 4]
      DTensor under the policy; returns their placements and whether the
      values held; then whether ``sharding.place`` keeps the same block as
      DTensor's own ``distribute_tensor`` for even and uneven shapes
      under every spec of a (2, 2) mesh;
    * ``"restore_params"``: ``checkpoint.restore(..., shardings=)`` of an
      LM checkpoint at ``inputs["dir"]`` onto ``init(..., device="meta")``
      under ``to_shardings(lm_param_specs(...))`` on a (2, 2) mesh;
      returns each leaf gathered whole (numpy, by path) and whether each
      local block is the leaf's slice the rank owns;
    * ``"elastic"``: ``checkpoint.restore(..., shardings=)`` of the fleet
      at ``inputs["dir"]`` under ``Shard(0)`` of the fleet's mesh (with
      ``REPRO_CHECK=1``: the contracts walk the rank's blocks), then
      ``rebalance_instances(..., inputs["n_new"], sharding=)``; returns the
      restored block's instance count and the rank's block (the
      converter's dict).
    """
    import dataclasses
    import os

    from torch.distributed.tensor import (DTensor, Replicate,
                                          distribute_tensor)

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core import distributed as tdist
    from repro_torch.data import pipeline
    from repro_torch.distribution import sharding as sh
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import common
    from repro_torch.models import transformer as ttf
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.runtime import rebalance_instances
    torch.set_num_threads(1)
    out = []
    for kind, inputs in jobs:
        if kind == "lm_step":
            mesh = mesh_mod.make_test_mesh((2, 2), device="cpu")
            policy = sh.make_policy(mesh)
            cfg = dataclasses.replace(get_smoke_config(inputs["arch"]),
                                      dtype="float32")
            params = ttf.params_from_numpy(inputs["tree"], "cpu")
            specs = sh.lm_param_specs(params, cfg, policy)
            params = common.with_leaves(params, common.tree_map(
                sh.place, params, sh.to_shardings(specs, mesh)))
            bsh = pipeline.batch_sharding(mesh, policy.batch_axes)
            batch = next(pipeline.ShardedStream(iter([
                {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
            ]), sharding=bsh))
            step = ttf.make_train_step(cfg, AdamWConfig(lr=inputs["lr"]))
            with sh.use_policy(policy):
                params, opt, metrics = step(params, adamw_init(params),
                                            batch)
            coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
            sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
            spec_of = dict(sh.leaves_with_paths(specs))
            shapes, full = [], {}
            for path, p in sh.leaves_with_paths(params):
                shapes.append((path, tuple(p.to_local().shape),
                               sh.local_shape(tuple(p.shape), spec_of[path],
                                              sizes, coord)))
                full[path] = p.full_tensor().numpy()
            moments_placed = all(
                m.placements == p.placements for m, p in zip(
                    common.tree_leaves(opt["m"]), common.tree_leaves(params)))
            out.append(dict(loss=float(metrics["total"].full_tensor()),
                            batch_local=tuple(
                                batch["tokens"].to_local().shape),
                            gnorm=float(metrics["gnorm"]), params=full,
                            shapes=shapes, moments_placed=moments_placed))
        elif kind == "constrain":
            mesh = mesh_mod.make_test_mesh((2, 2), device="cpu")
            rep = (Replicate(), Replicate())
            got = []
            with sh.use_policy(sh.make_policy(mesh)):
                for rows in (6, 5):
                    x = torch.arange(rows * 4.0).reshape(rows, 4)
                    y = sh.constrain(DTensor.from_local(x, mesh, rep),
                                     "batch", "tp")
                    got.append((rows, tuple(y.placements),
                                bool((y.full_tensor() == x).all())))
            same = []
            for shape, spec in (((10, 6), sh.Spec("data", "model")),
                                ((7, 5), sh.Spec(("data", "model"), None)),
                                ((3, 9), sh.Spec("model", "data")),
                                ((5,), sh.Spec(None))):
                x = torch.arange(float(np.prod(shape))).reshape(shape)
                s = sh.to_shardings(spec, mesh)
                want = distribute_tensor(x, mesh, s.placements,
                                         src_data_rank=None).to_local()
                same.append(torch.equal(sh.place(x, s).to_local(), want))
            out.append((got, same))
        elif kind == "restore_params":
            mesh = mesh_mod.make_test_mesh((2, 2), device="cpu")
            cfg = get_smoke_config(inputs["arch"])
            template = ttf.init(0, cfg, device="meta")
            shardings = sh.to_shardings(sh.lm_param_specs(
                template, cfg, sh.make_policy(mesh)), mesh)
            restored = ckpt.restore(inputs["dir"], inputs["step"], template,
                                    shardings=shardings)
            full, blocks = {}, []
            for path, p in sh.leaves_with_paths(restored):
                whole = p.full_tensor()
                full[path] = whole.numpy()
                s = sh.Sharding(mesh, tuple(p.placements))
                blocks.append(torch.equal(
                    p.to_local(), whole[sh.local_slices(whole.shape, s)]))
            out.append(dict(params=full, blocks=blocks))
        elif kind == "elastic":
            dmesh = mesh_mod.fleet_device_mesh(fleet)
            sharding = sh.to_shardings(sh.Spec("data"), dmesh)
            template = tdist.create_instances(
                inputs["instances"], inputs["cuts"], inputs["block"],
                device="meta")
            os.environ["REPRO_CHECK"] = "1"
            try:
                restored = ckpt.restore(inputs["dir"], inputs["step"],
                                        template, shardings=sharding)
            finally:
                del os.environ["REPRO_CHECK"]
            grown = rebalance_instances(restored, inputs["n_new"],
                                        sharding=sharding)
            out.append(dict(
                restored=restored.spills.to_local().shape[0],
                sharded=isinstance(grown.spills, DTensor),
                state=thier.state_to_numpy(thier.map_state(
                    lambda x: x.to_local(), grown))))
        elif kind == "gnn_steps":
            out.append(_gnn_mesh_steps(inputs))
        elif kind == "dcn":
            out.append(_dcn_mesh_job(inputs))
        else:
            raise ValueError(f"unknown mesh job {kind!r}")
    return out


def _shards_and_params(params, specs, mesh) -> tuple:
    """Every leaf gathered (numpy, by path) and each leaf's (path, local
    shape, spec's local shape)."""
    from repro_torch.distribution import sharding as sh
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    spec_of = dict(sh.leaves_with_paths(specs))
    shapes, full = [], {}
    for path, p in sh.leaves_with_paths(params):
        shapes.append((path, tuple(p.to_local().shape),
                       sh.local_shape(tuple(p.shape), spec_of[path], sizes,
                                      coord)))
        full[path] = p.full_tensor().numpy()
    return full, shapes


def _placed_batch(batch: dict, mesh, policy) -> dict:
    from repro_torch.distribution import sharding as sh
    from repro_torch.launch.cells import _bsh
    return {k: sh.place(torch.from_numpy(v), _bsh(mesh, policy.batch_axes,
                                                  torch.from_numpy(v)))
            for k, v in batch.items()}


def _gnn_mesh_steps(inputs: dict) -> dict:
    """``inputs["steps"]`` ``gnn.make_train_step`` steps of
    ``inputs["arch"]``'s smoke config on a (2, 2) CPU mesh under
    ``make_policy(mesh, "dp")`` (the GNN cells' layout), from the numpy
    parameter tree placed by ``gnn_param_specs``, the graph by the cells'
    ``_bsh``; returns each step's loss, the parameters gathered, every
    leaf's local and spec shape, the batch's local shapes and whether the
    moments follow their parameters' placements."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.distribution import sharding as sh
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import common
    from repro_torch.models import gnn as tgnn
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    mesh = mesh_mod.make_test_mesh((2, 2), device="cpu")
    policy = sh.make_policy(mesh, "dp")
    cfg = get_smoke_config(inputs["arch"])
    params = tgnn.params_from_numpy(inputs["tree"], cfg, device="cpu")
    specs = sh.gnn_param_specs(params, cfg, policy)
    params = common.with_leaves(params, common.tree_map(
        sh.place, params, sh.to_shardings(specs, mesh)))
    batch = _placed_batch(inputs["batch"], mesh, policy)
    step = tgnn.make_train_step(cfg, AdamWConfig(lr=inputs["lr"]),
                                inputs["task"], inputs["seed_count"])
    opt, losses = adamw_init(params), []
    with sh.use_policy(policy):
        for _ in range(inputs["steps"]):
            params, opt, metrics = step(params, opt, batch)
            losses.append(float(metrics["loss"].full_tensor()))
    full, shapes = _shards_and_params(params, specs, mesh)
    return dict(losses=losses, params=full, shapes=shapes,
                batch_local={k: tuple(v.to_local().shape)
                             for k, v in batch.items()},
                moments_placed=all(
                    m.placements == p.placements for m, p in zip(
                        common.tree_leaves(opt["m"]),
                        common.tree_leaves(params))))


def _dcn_mesh_job(inputs: dict) -> dict:
    """DCN-v2's smoke config on a (2, 2) CPU mesh under ``make_policy(mesh,
    "dp")``, the parameters placed by ``recsys_param_specs`` (the table's
    rows over every axis): ``serve_scores`` of the batch, ``retrieval_topk``
    of its first query against candidates sharded over every axis, then one
    ``make_train_step`` step; returns the scores, the top-k, the loss, the
    parameters gathered and every leaf's local and spec shape."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.distribution import sharding as sh
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import common
    from repro_torch.models import dcn as tdcn
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    mesh = mesh_mod.make_test_mesh((2, 2), device="cpu")
    policy = sh.make_policy(mesh, "dp")
    cfg = get_smoke_config("dcn-v2")

    def placed():
        params = tdcn.params_from_numpy(inputs["tree"], cfg, device="cpu")
        specs = sh.recsys_param_specs(params, cfg, policy)
        return specs, common.with_leaves(params, common.tree_map(
            sh.place, params, sh.to_shardings(specs, mesh)))

    specs, params = placed()
    batch = _placed_batch(inputs["batch"], mesh, policy)
    query = {k: sh.place(torch.from_numpy(inputs["batch"][k][:1]),
                         sh.Sharding(mesh, (sh.Replicate(),) * 2))
             for k in ("dense", "sparse")}
    cands = sh.place(torch.from_numpy(inputs["cands"]), sh.to_shardings(
        sh.Spec(("data", "model"), None), mesh))
    step = tdcn.make_train_step(cfg, AdamWConfig(lr=inputs["lr"]))
    with sh.use_policy(policy):
        scores = tdcn.serve_scores(params, batch, cfg).full_tensor()
        values, indices = tdcn.retrieval_topk(params, query, cands, cfg,
                                              k=inputs["k"])
        params, _, metrics = step(params, adamw_init(params), batch)
    full, shapes = _shards_and_params(params, specs, mesh)
    return dict(scores=scores.numpy(),
                values=values.full_tensor().numpy(),
                indices=indices.full_tensor().numpy(),
                loss=float(metrics["loss"].full_tensor()), params=full,
                shapes=shapes)


# --------------------------------------------------------------- dry runs ---

DENSE_ARCHS = ("smollm-360m", "phi3-mini-3.8b", "mistral-nemo-12b")
MOE_ARCHS = ("granite-moe-3b-a800m", "deepseek-v2-236b")
DRY_BATCH, DRY_SEQ = 8, 32


def smoke_variant(arch: str, **over) -> str:
    """The ``variant`` string that turns ``arch``'s full config into its
    smoke config (then ``over``'s fields): a cell of the smoke widths
    through ``cells.lower_cell``."""
    import dataclasses

    from repro_torch.configs.registry import get_config, get_smoke_config
    full = dataclasses.asdict(get_config(arch))
    smoke = dataclasses.asdict(get_smoke_config(arch))
    smoke.update(over)
    return ",".join(f"{k}={'+'.join(map(str, v)) if isinstance(v, tuple) else v}"
                    for k, v in smoke.items()
                    if k != "family" and v != full[k])


def _fake_group(world: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _unsharded_cost(arch: str, variant: str) -> dict:
    """The cost of the unsharded train step of ``arch`` at ``variant``, on
    ``meta``, recorded as any plain call is."""
    from repro_torch import stages
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.cells import apply_variant, sds
    from repro_torch.models import transformer as ttf
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    cfg = apply_variant(get_config(arch), variant)
    params = ttf.init(0, cfg, device="meta")
    tok = sds((DRY_BATCH, DRY_SEQ), torch.int32)
    w = stages.wrap(ttf.make_train_step(cfg, AdamWConfig()),
                    "test.unsharded_step",
                    stages.signature_of(extra=(("arch", arch),)))
    comp = w.lower(params, adamw_init(params), dict(tokens=tok, labels=tok),
                   keep_args=True).compile()
    return dict(comp.cost_analysis(), matrix_flops=_matrix_flops(comp))


def _expected_arg_bytes(arch: str, variant: str, mesh) -> int:
    """The train cell's argument bytes on one rank by the specs' local
    shapes: parameters, two float32 moments, the int32 count and the
    batch."""
    import math

    from repro_torch.configs.registry import get_config
    from repro_torch.distribution import sharding as sh
    from repro_torch.launch.cells import apply_variant
    from repro_torch.models import transformer as ttf
    cfg = apply_variant(get_config(arch), variant)
    policy = sh.make_policy(mesh, cfg.layout)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    params = ttf.init(0, cfg, device="meta")
    specs = dict(sh.leaves_with_paths(sh.lm_param_specs(params, cfg,
                                                        policy)))
    total = 4                                        # the step count
    for path, p in sh.leaves_with_paths(params):
        n = math.prod(sh.local_shape(tuple(p.shape), specs[path], sizes))
        total += n * (p.element_size() + 2 * 4)
    rows = sh.local_shape((DRY_BATCH, DRY_SEQ),
                          sh.Spec(policy.batch_axes), sizes)
    return total + 2 * math.prod(rows) * 4


def _matrix_flops(comp) -> int:
    """The matrix products' flops of a recorded call (``mm``, ``bmm``,
    ``addmm``, ``baddbmm``: 2 x the product's multiply-adds), from its
    ops' shapes: the part of ``flops`` that ``FlopCounterMode``'s table
    counts."""
    comp.cost_analysis()                 # records the call if it was not
    total = 0
    for op in comp.recorded.ops:
        if op.name.split(".")[1] in ("mm", "bmm", "addmm", "baddbmm"):
            a, b = (shape for _, shape in op.ins[-2:])
            total += 2 * math.prod(a) * b[-1]
    return total


def _cost_row(low) -> dict:
    from repro_torch.roofline.hlo import parse_hlo_collectives
    comp = low.compile()
    mem = comp.memory_analysis()
    return dict(cost=comp.cost_analysis(), matrix_flops=_matrix_flops(comp),
                collectives=parse_hlo_collectives(comp.as_text()),
                arg_bytes=mem.argument_size_in_bytes,
                peak_bytes=mem.temp_size_in_bytes)


def dryrun_recorder_checks() -> dict:
    """Under a fake group of 4 ranks: the recorder on a (2, 2) sharded
    matmul (on the CPU and on ``meta``), ``signature_of`` on a
    ``DeviceMesh``, ``replicate_grad``'s backward."""
    import types

    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch import stages
    from repro_torch.distribution import sharding as sh
    from repro_torch.launch import diagnose
    from repro_torch.launch import mesh as mesh_mod
    _fake_group(4)
    m22 = mesh_mod.make_test_mesh((2, 2), device="cpu")
    m41 = mesh_mod.make_test_mesh((4, 1), device="cpu")
    out = dict(sig22=stages.signature_of(mesh=m22,
                                         data_axes=("data",)).mesh,
               sig41=stages.signature_of(mesh=m41).mesh)
    out["matmul"] = {}
    for dev in ("cpu", "meta"):
        a = DTensor.from_local(torch.ones(32, 8, device=dev), m22,
                               (Shard(0), Shard(1)), run_check=False)
        b = DTensor.from_local(torch.ones(8, 16, device=dev), m22,
                               (Shard(0), Replicate()), run_check=False)
        w = stages.wrap(lambda x, y: x @ y, f"test.matmul_{dev}",
                        stages.signature_of(mesh=m22))
        row = _cost_row(w.lower(a, b))
        row["text"] = w.lower(a, b).compile().as_text()
        row["analysis"] = diagnose.analyze(row["text"], top=3)
        out["matmul"][dev] = row
    g = DTensor.from_local(torch.ones(2, 3), m22, (Shard(0), Replicate()),
                           run_check=False)
    x = DTensor.from_local(torch.ones(4, 3), m22, (Replicate(), Replicate()),
                           run_check=False)
    with sh.use_policy(sh.make_policy(m22)):
        y = sh.replicate_grad(x)
        z = sh.grad_as_forward(g)
    back = sh._GradTo.backward(
        types.SimpleNamespace(placements=(Replicate(), Replicate())), g)[0]
    out["grad_to"] = dict(
        forward=[str(p) for p in y.placements] + [str(p) for p in
                                                  z.placements],
        same=isinstance(y, DTensor) and y.shape == x.shape,
        backward=[str(p) for p in back.placements],
        plain=sh.replicate_grad(g.to_local()) is not None)
    return out


# (arch, shape) of the GNN and recsys cells recorded on a (2, 2) mesh at
# smoke widths; DCN-v2's smoke table given the six largest fields of the
# full config, so that the table outweighs every batch-sized collective
GNN_CELLS = (("gat-cora", "full_graph_sm"), ("gin-tu", "molecule"),
             ("gatedgcn", "full_graph_sm"), ("graphcast", "minibatch_lg"))
RECSYS_CELLS = (("dcn-v2", "train_batch"), ("dcn-v2", "serve_p99"),
                ("dcn-v2", "retrieval_cand"))


def recsys_smoke_variant() -> str:
    from repro_torch.configs.registry import get_config
    return smoke_variant("dcn-v2",
                         table_sizes=get_config("dcn-v2").table_sizes[:6])


def _local_bytes(shape, spec, sizes, itemsize: int) -> int:
    import math

    from repro_torch.distribution import sharding as sh
    return math.prod(sh.local_shape(tuple(shape), spec, sizes)) * itemsize


def _expected_cell_arg_bytes(arch: str, shape: str, variant: str,
                             mesh) -> dict:
    """A GNN or recsys cell's argument bytes on one rank by the specs'
    local shapes (the parameters, for a train cell the two float32 moments
    and the int32 count, then the batch: dim 0 over every axis where they
    divide it, the retrieval query whole, its candidates over every axis),
    and the table's bytes on one rank."""
    import math

    from repro_torch.configs import GNN_SHAPES, RECSYS_SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.distribution import sharding as sh
    from repro_torch.launch import cells
    from repro_torch.models import dcn, gnn
    cfg = cells.apply_variant(get_config(arch), variant)
    policy = sh.make_policy(mesh, "dp")
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    every = tuple(mesh.mesh_dim_names)
    if arch == "dcn-v2":
        info = RECSYS_SHAPES[shape]
        params = dcn.init(0, cfg, device="meta")
        specs = sh.recsys_param_specs(params, cfg, policy)
        b = info["batch"]
        batch = [((b, cfg.n_dense), 4), ((b, cfg.n_sparse), 4)]
        if info["kind"] == "train":
            batch.append(((b,), 4))
        train = info["kind"] == "train"
    else:
        info = GNN_SHAPES[shape]
        n_out = cfg.n_vars if cfg.kind == "graphcast" else info["n_classes"]
        params = gnn.init(0, cfg, info["d_feat"], n_out, device="meta")
        specs = sh.gnn_param_specs(params, cfg, policy)
        graph, _ = cells._gnn_batch(cfg, info, n_out, torch.device("meta"),
                                    0)
        batch = [(tuple(v.shape), v.element_size()) for v in graph.values()]
        train = True
    spec_of = dict(sh.leaves_with_paths(specs))
    total, table = 0, 0
    for path, p in sh.leaves_with_paths(params):
        n = _local_bytes(p.shape, spec_of[path], sizes, p.element_size())
        total += n + (2 * n // p.element_size() * 4 if train else 0)
        if path == "table":
            table = n
    total += 4 if train else 0                      # the AdamW count
    if arch == "dcn-v2" and info["kind"] == "retrieval":
        nc = cells._pad256(info["n_candidates"])
        total += sum(math.prod(s) * i for s, i in batch)   # the query whole
        total += _local_bytes((nc, cfg.mlp[-1]), sh.Spec(every, None), sizes,
                              4)
    else:
        for s, i in batch:
            split = s[0] % math.prod(sizes.values()) == 0
            spec = sh.Spec(every if split else None, *([None] * (len(s) - 1)))
            total += _local_bytes(s, spec, sizes, i)
    return dict(args=total, table=table)


def dryrun_train_cells() -> dict:
    """Under a fake group of 4 ranks: the LM train cells of the five archs
    (smoke widths) on a (4, 1) data-only mesh against their unsharded
    steps, the D4M cells on (2, 2), the GNN and recsys cells at smoke
    widths on (2, 2), and the ``hier`` variant refused."""
    from repro_torch.launch import cells, probes
    from repro_torch.launch import mesh as mesh_mod
    _fake_group(4)
    m22 = mesh_mod.make_test_mesh((2, 2), device="cpu")
    m41 = mesh_mod.make_test_mesh((4, 1), device="cpu")
    out = dict(train41={}, d4m={})
    for arch in DENSE_ARCHS + MOE_ARCHS:
        variant = smoke_variant(arch)
        low, _ = cells.lower_cell(arch, "train_4k", m41, variant,
                                  batch=DRY_BATCH, seq=DRY_SEQ)
        row = _cost_row(low)
        row["unsharded"] = _unsharded_cost(arch, variant)
        row["expected_arg_bytes"] = _expected_arg_bytes(arch, variant, m41)
        out["train41"][arch] = row
    for shape in ("ingest_small", "query"):
        low, meta = cells.lower_cell("d4m-stream", shape, m22,
                                     device="cpu")
        out["d4m"][shape] = dict(_cost_row(low), meta=meta)
        out["d4m"][shape]["raw"] = probes.extract(low.compile())
    out["gnn"] = {}
    for arch, shape in GNN_CELLS + RECSYS_CELLS:
        variant = recsys_smoke_variant() if arch == "dcn-v2" \
            else smoke_variant(arch)
        low, meta = cells.lower_cell(arch, shape, m22, variant)
        out["gnn"][f"{arch}:{shape}"] = dict(
            _cost_row(low), meta=meta,
            expected=_expected_cell_arg_bytes(arch, shape, variant, m22))
    try:
        cells.lower_cell("dcn-v2", "train_batch", m22, "hier")
    except ValueError as e:
        out["hier"] = str(e)
    return out


def dryrun_probe_checks() -> dict:
    """Under a fake group of 4 ranks, on a (2, 2) mesh: the probes'
    extrapolation and the full recording of LM cells at 5 layers (smoke
    widths) and of the D4M ingest cell."""
    from repro_torch.launch import cells, probes
    from repro_torch.launch import mesh as mesh_mod
    _fake_group(4)
    m22 = mesh_mod.make_test_mesh((2, 2), device="cpu")
    out = {}
    for arch, shape in (("smollm-360m", "train_4k"),
                        ("granite-moe-3b-a800m", "train_4k"),
                        ("phi3-mini-3.8b", "prefill_32k"),
                        ("deepseek-v2-236b", "decode_32k")):
        variant = smoke_variant(arch, n_layers=5)
        low, _ = cells.lower_cell(arch, shape, m22, variant,
                                  batch=DRY_BATCH, seq=DRY_SEQ)
        corr = probes.corrected_metrics(arch, shape, m22, variant,
                                        batch=DRY_BATCH, seq=DRY_SEQ)
        out[f"{arch}:{shape}"] = dict(raw=probes.extract(low.compile()),
                                      **corr)
    low, _ = cells.lower_cell("d4m-stream", "ingest_small", m22,
                              device="cpu")
    out["d4m-stream:ingest_small"] = dict(
        raw=probes.extract(low.compile()),
        **probes.corrected_metrics("d4m-stream", "ingest_small", m22,
                                   device="cpu"))
    return out


def dryrun_tiny_production() -> dict:
    """The counterpart of the reference's tiny production mesh lowering:
    mistral-nemo's smoke config at ``num_microbatches=2`` on a (2, 2, 2)
    ``("pod", "data", "model")`` mesh under a fake group of 8, through
    ``cells.lower_cell``; its per-device collectives."""
    from repro_torch.launch import cells
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.roofline.hlo import collective_bytes_by_type
    _fake_group(8)
    mesh = mesh_mod.make_test_mesh((2, 2, 2), ("pod", "data", "model"),
                                   device="cpu")
    low, meta = cells.lower_cell(
        "mistral-nemo-12b", "train_4k", mesh,
        smoke_variant("mistral-nemo-12b", num_microbatches=2),
        batch=DRY_BATCH, seq=DRY_SEQ)
    total, by_type = collective_bytes_by_type(low.compile().as_text())
    return dict(total=total, by_type=by_type, tokens=meta["tokens"])


def dryrun_cells_run(outdir: str) -> dict:
    """``dryrun.run_cell`` on the (16, 16) production mesh (a fake group of
    256, started by ``run_cell``), on the CPU and with the probes' check:
    the D4M ``ingest_small`` cell and a ``long_500k`` skip."""
    from repro_torch.launch import dryrun
    return {f"{arch}:{shape}": dryrun.run_cell(arch, shape, "single",
                                               "baseline", outdir,
                                               verbose=False, device="cpu",
                                               probes=True)
            for arch, shape in (("d4m-stream", "ingest_small"),
                                ("smollm-360m", "long_500k"))}


def dryrun_metas(cell_list) -> dict:
    """``cells.lower_cell``'s ``meta`` of each (arch, shape[, variant]) on
    a (1, 1) mesh under a fake group of 1, lowered on ``meta`` (no
    recording); keyed by the cell's fields joined with ``:``."""
    from repro_torch.launch import cells
    from repro_torch.launch import mesh as mesh_mod
    _fake_group(1)
    mesh = mesh_mod.make_test_mesh((1, 1), device="cpu")
    return {":".join(c): cells.lower_cell(*c[:2], mesh, *c[2:],
                                          device="meta")[1]
            for c in cell_list}


def run_child(name: str, *args, timeout: int = 600):
    """Run one of the functions above in a fresh process (the fake group
    is process-global, and no test worker may keep one); its result
    comes back pickled."""
    import os
    import pickle
    import subprocess
    import sys
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "out.pkl")
        code = (f"import sys, pickle\nsys.path[:0] = [{src!r}, {here!r}]\n"
                f"import torch_parity\n"
                f"out = torch_parity.{name}(*{args!r})\n"
                f"pickle.dump(out, open({path!r}, 'wb'))\n")
        res = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True,
                             timeout=timeout)
        assert res.returncode == 0, res.stderr[-4000:]
        with open(path, "rb") as f:
            return pickle.load(f)


# the two packages' monitors: the reference's and the port's copy
MONITORS = ("repro.launch.monitor", "repro_torch.launch.monitor")


def run_monitor(module: str, obs_dir: str, out_dir, *flags: str):
    """``python -m <module> --once --obs-dir obs_dir --summary-out ...``
    as its own command; returns the finished process and the path of its
    summary."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    out = os.path.join(str(out_dir), f"{module}.summary.json")
    res = subprocess.run(
        [sys.executable, "-m", module, "--once", *flags, "--obs-dir",
         obs_dir, "--summary-out", out],
        env=dict(os.environ, PYTHONPATH=src), cwd=str(out_dir),
        capture_output=True, text=True, timeout=120)
    return res, out


def monitor_summaries(obs_dir: str, out_dir) -> list:
    """Both packages' monitors under ``--strict`` on ``obs_dir``, each as
    its own command: their ``OBS_SUMMARY.json``s, the reference's first.
    Every field is computed from the records (the monitor reads no clock
    in ``--once`` mode), so the two are equal key for key, but for the
    port's ``spans``: its aggregate of the ``span`` records, which the
    reference's monitor counts under ``events`` and does not aggregate.
    That key is checked against the count here and left out of what is
    returned."""
    import json
    out = []
    for module in MONITORS:
        res, path = run_monitor(module, obs_dir, out_dir, "--strict")
        assert res.returncode == 0, (module, res.stderr)
        with open(path) as f:
            out.append(json.load(f))
    ref, port = out
    spans = port.pop("spans", {})
    assert sum(d["count"] for d in spans.values()) \
        == ref["events"].get("span", 0)
    return out
