"""Distributed placement of D4M instances — paper §III scaled out.

The paper runs 34,000 independent database instances across 1,100 nodes
with no coordination on the update path.  On one rank the share-nothing
instances are a leading batch axis ``[I, ...]`` on every tensor of a
``HierAssoc`` (``core/stream.py`` runs them); across ranks they are laid
over a ``launch.mesh.FleetMesh`` of P ranks, rank r holding instances
``[r*I/P, (r+1)*I/P)`` — the block ``shard_map`` over the leading axis
gives device r in the JAX package.  ``shard`` cuts that block out of a
fleet-wide tensor or state, and refuses a count P does not divide.

The sharded functions take ``(mesh, data_axes, ...)`` as the JAX
package's do and return a callable over the rank's LOCAL block:

    update path: ``sharded_ingest_fn`` — no collective (share-nothing);
    query path:  ``sharded_query_fn``, ``global_degree_histogram_fn``,
                 ``aggregate_update_counts_fn`` — a local reduction over
                 the rank's instances, then ONE ``all_reduce`` over the
                 group, so every rank holds the fleet's answer.

Each returned callable is a ``stages.Wrapped`` (eager) under the
reference's entry name (``distributed.sharded_ingest_fn``, ...), keyed
by its mesh too.

The local reduce then ``all_reduce`` adds floats in another order than
the reference's vmap sum then ``psum``: sums agree exactly on
integer-valued streams, within the registry rtol otherwise.

``instance_assignment`` is the rendezvous hash that places instances on
devices for an elastic restart.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch import stages
from repro_torch.core import assoc, hier, stream
from repro_torch.core import semiring as sr_mod
from repro_torch.core.hier import HierAssoc
from repro_torch.core.semiring import Semiring


def instance_assignment(n_instances: int, n_devices: int) -> torch.Tensor:
    """Rendezvous (highest-random-weight) assignment instance -> device,
    int32 [n_instances], bit-equal to the JAX package's.

    device(i) = argmax_d hash(i, d): stable across runs, and when the
    fleet grows from N to N+k devices only the instances whose new device
    wins move (~k/(N+k) in expectation).  The hash is uint32 arithmetic;
    torch's uint32 lacks it, so it runs in int64 with every product and
    xor-shift masked back to 32 bits (ties go to the lowest device, as
    ``jnp.argmax`` breaks them).
    """
    ids = torch.arange(n_instances, dtype=torch.int64)[:, None]
    devs = torch.arange(n_devices, dtype=torch.int64)[None, :]
    h = _mul32(ids, 2654435761) ^ _mul32(devs, 40503)
    h = h ^ (h >> 16)
    h = _mul32(h, 2246822519)
    h = h ^ (h >> 13)
    return torch.argmax(h, dim=1).to(torch.int32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32): by 16-bit halves
    of ``c``, so no product leaves int64's range."""
    m = 0xFFFFFFFF
    return ((x * (c & 0xFFFF)) + (((x * (c >> 16)) & 0xFFFF) << 16)) & m


def create_instances(n_instances: int, cuts: Tuple[int, ...], block_size: int,
                     dtype=torch.float32, sr: Semiring = sr_mod.PLUS_TIMES,
                     device=None) -> HierAssoc:
    """Instance-batched hierarchy (leading axis = instance), on the CUDA
    device unless ``device`` says otherwise."""
    one = hier.create(cuts, block_size, dtype, sr, device=device)
    return hier.map_state(
        lambda x: x.expand((n_instances,) + x.shape).contiguous(), one)


def local_block(mesh, n_instances: int) -> slice:
    """The rank's block ``[r*I/P, (r+1)*I/P)`` of a fleet of
    ``n_instances``; a count that the mesh size P does not divide raises
    (as ``shard_map`` does)."""
    if n_instances % mesh.size:
        raise stages._invalid(
            f"{n_instances} instances do not divide over the "
            f"{mesh.size} ranks of mesh axis {mesh.axis_names[0]!r}")
    n = n_instances // mesh.size
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def shard(mesh, x):
    """The rank's block of a fleet-wide tensor or ``HierAssoc`` (leading
    axis = instance), as a view on its own device."""
    if isinstance(x, HierAssoc):
        block = local_block(mesh, x.spills.shape[0])
        return hier.map_state(lambda t: t[block], x)
    return x[local_block(mesh, x.shape[0])]


def _all_reduce(mesh, data_axes, x: torch.Tensor, op) -> torch.Tensor:
    """``x`` reduced in place over the ranks when the data axis is
    sharded (the port's one mesh axis), as the reference's loop of psums
    over ``data_axes``."""
    if data_axes:
        import torch.distributed as dist
        dist.all_reduce(x, op=getattr(dist.ReduceOp, op), group=mesh.group)
    return x


def sharded_ingest_fn(mesh, data_axes: Tuple[str, ...],
                      sr: Semiring = sr_mod.PLUS_TIMES,
                      lazy_l0: bool = False,
                      use_kernel: bool = False,
                      fused: bool = True,
                      chunk: int = 1,
                      batch_mode: str = "grouped"):
    """The distributed ingest step: ``fn(states, rows, cols, vals) ->
    (states, telemetry)`` over the rank's local block (states ``[I/P,
    ...]``, streams ``[I/P, T, B]``).  No collective on the update path —
    the paper's share-nothing design; every knob is
    ``stream.ingest_instances``'s."""
    sig = stages.signature_of(sr=sr, use_kernel=use_kernel, lazy_l0=lazy_l0,
                              fused=fused, chunk=chunk, batch_mode=batch_mode,
                              mesh=mesh, data_axes=data_axes)

    def dist_ingest(states, rows, cols, vals):
        return stream.ingest_instances(states, rows, cols, vals, sr=sr,
                                       use_kernel=use_kernel, lazy_l0=lazy_l0,
                                       fused=fused, chunk=chunk,
                                       batch_mode=batch_mode)

    return stages.wrap(dist_ingest, "distributed.sharded_ingest_fn", sig,
                       static=(("mesh", mesh),), donate_argnums=(0,))


def _mesh_semiring_combine(sr: Semiring, x: torch.Tensor, mesh,
                           data_axes) -> torch.Tensor:
    """Mesh reduction matching the semiring's add: SUM for plus.times,
    MAX / MIN for the idempotent tropical semirings (``reduce_kind`` raises
    on an unknown semiring).  The tropical zeros (+-inf) pass through
    MAX / MIN unchanged."""
    op = {"sum": "SUM", "max": "MAX", "min": "MIN"}[sr_mod.reduce_kind(sr)]
    return _all_reduce(mesh, data_axes, x, op)


def sharded_query_fn(mesh, data_axes: Tuple[str, ...],
                     sr: Semiring = sr_mod.PLUS_TIMES,
                     use_kernel: bool = False,
                     l0_mode: str = "auto",
                     per_instance: bool = False):
    """Fleet-wide point queries: ``fn(states, q_rows, q_cols)``.

    The ``[Q]`` queries are the same on every rank; each rank answers them
    against its local instances with one batched ``engine.point_lookup``
    (no flush, no merge), combines them with ``sr.add`` over its instances
    (``engine.reduce_axis``), then over the ranks (one ``all_reduce``):
    every rank returns the ``[Q]`` values the whole fleet's merged array
    holds.  ``per_instance=True`` skips both combines and returns the
    rank's ``[I/P, Q]`` block, instance-major.  With ``use_kernel`` and
    ``l0_mode="canon"`` each rank launches ``merge_multi`` once per local
    instance (the layer-0 canonicalization).
    """
    from repro_torch.query import engine

    sig = stages.signature_of(sr=sr, use_kernel=use_kernel, l0_mode=l0_mode,
                              mesh=mesh, data_axes=data_axes,
                              extra=(("per_instance", per_instance),))

    def dist_query(states, q_rows, q_cols):
        local = engine.point_lookup(states, q_rows, q_cols, sr=sr,
                                    use_kernel=use_kernel, l0_mode=l0_mode)
        if per_instance:
            return local
        local = engine.reduce_axis(sr, local, axis=0)
        return _mesh_semiring_combine(sr, local, mesh, data_axes)

    return stages.wrap(dist_query, "distributed.sharded_query_fn", sig,
                       static=(("mesh", mesh),))


def _local_degree_histogram(states: HierAssoc, num_rows: int,
                            num_bins: int, sr: Semiring = sr_mod.PLUS_TIMES
                            ) -> torch.Tensor:
    """int32 ``[num_bins]`` histogram of the out-degrees of every instance
    of ``states``: per instance ``query_all``, ``assoc.reduce_rows``, and
    the degrees above 0 binned by ``floor(log2(deg))`` clipped into
    ``[0, num_bins)``; summed over the instances.  Every row counts whose
    total is above 0, as in the reference: under min.plus an empty row's
    +inf too."""
    counts = torch.zeros((num_bins,), dtype=torch.int32,
                         device=states.device)
    for i in range(states.spills.shape[0]):
        merged = hier.query_all(stream.instance(states, i), sr)
        deg = assoc.reduce_rows(merged, num_rows, sr)
        # clipped before the int cast: a +inf degree (min.plus's zero on
        # an empty row) lands in the top bin, as XLA's saturating cast
        # puts it, where torch's cast of inf is undefined
        bins = torch.clamp(torch.floor(torch.log2(torch.clamp(deg, min=1))),
                           0, num_bins - 1).to(torch.int32)
        counts.index_add_(0, bins, (deg > 0).to(torch.int32))
    return counts


def global_degree_histogram_fn(mesh, data_axes: Tuple[str, ...],
                               num_rows: int, num_bins: int,
                               sr: Semiring = sr_mod.PLUS_TIMES):
    """Query path: the out-degree histogram of every instance of the
    fleet, ``fn(states) -> int32 [num_bins]`` on every rank: the rank's
    own histogram then one ``all_reduce(SUM)`` — the "reduce globally"
    analytics pattern of §II."""
    sig = stages.signature_of(sr=sr, mesh=mesh, data_axes=data_axes,
                              extra=(("num_rows", int(num_rows)),
                                     ("num_bins", int(num_bins))))

    def histogram(states):
        local = _local_degree_histogram(states, num_rows, num_bins, sr)
        return _all_reduce(mesh, data_axes, local, "SUM")

    return stages.wrap(histogram, "distributed.global_degree_histogram",
                       sig, static=(("mesh", mesh),))


def aggregate_update_counts_fn(mesh, data_axes: Tuple[str, ...]):
    """Total updates ingested across the fleet (throughput accounting):
    ``fn(states) -> np.int64`` on every rank.  The counter is one int64 per
    instance (``hier.exact_update_count``), so the local sum and the
    ``all_reduce`` stay in int64 and the total is exact past 2**31, 2**32
    and 2**33 (the reference rebuilds it from 32-bit words)."""
    def count_parts(states):
        total = states.n_updates.sum().reshape(1)
        return _all_reduce(mesh, data_axes, total, "SUM")

    parts = stages.wrap(count_parts, "distributed.aggregate_update_counts",
                        stages.signature_of(mesh=mesh, data_axes=data_axes),
                        static=(("mesh", mesh),))

    def count(states):
        return np.int64(parts(states).item())

    return count
