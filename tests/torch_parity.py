"""Shared helpers of the ``test_torch_*.py`` parity tests.

The port (``repro_torch``) and the JAX package (``repro``) are fed the same
numpy-built inputs; these helpers carry states between the two through the
port's numpy converter (keyed by the JAX pytree's leaf names) and compare
results: keys, nnz, spills, overflow and counters exactly, values exactly
or within the registry's merge rtol (1e-4) where float sums may be taken in
another order.
"""
from __future__ import annotations

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
        else:
            raise ValueError(f"unknown mesh job {kind!r}")
    return out
