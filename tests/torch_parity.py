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
