"""Elastic scaling of D4M instance fleets.

Node loss or a fleet resize changes the instance count from N_old to
N_new.  Checkpoints are device-agnostic numpy trees
(``checkpoint/ckpt.py``), so an elastic restart is:

  1. restore the checkpoint (each leaf on the template's device, or the
     ``device`` asked for, or each rank's block of it under ``shardings``);
  2. resize the fleet with ``rebalance_instances``;
  3. resume the step loop.

``rebalance_instances`` changes the INSTANCE count: a grown fleet gets
fresh empty hierarchies for the new ids; a shrunk fleet folds its surplus
instances' state into the survivors by semiring merge (no update is lost —
associativity is exactly what makes this legal).  It resizes the whole
fleet: a fleet of DTensors sharded on the instance dim (a restore under
``shardings``) is first joined on every rank.  With ``sharding`` (a
``distribution.sharding.Sharding``, ``Shard(0)`` over the fleet's
``("data",)`` mesh) each rank then keeps its block of the result, a
DTensor on the mesh's device, as the reference ``device_put``s it.
The join is one ``all_reduce`` a leaf over the mesh (each rank adds its
block into zeros; exact, as every other element it adds is 0): gloo,
which lets ranks share a card, takes ``all_reduce`` on CUDA tensors but
not ``all_gather``.  ``core.distributed.instance_assignment`` keeps the
rendezvous hash for a fleet spread over devices.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.core import assoc, hier, stream
from repro_torch.core import semiring as sr_mod
from repro_torch.core.assoc import SENTINEL, AssocSegment
from repro_torch.core.hier import HierAssoc
from repro_torch.core.semiring import Semiring
from repro_torch.distribution import sharding as sharding_mod


def _grow_last_layer(states: HierAssoc, extra: int,
                     sr: Semiring) -> HierAssoc:
    """Every instance's deepest layer with ``extra`` more sentinel slots
    (a new tensor; the other leaves are the caller's)."""
    last = states.layers[-1]
    n_inst = last.hi.shape[0]
    pad_i = torch.full((n_inst, extra), SENTINEL, dtype=torch.int32,
                       device=last.hi.device)
    pad_v = sr.zeros((n_inst, extra), last.val.dtype, last.val.device)
    grown = AssocSegment(hi=torch.cat([last.hi, pad_i], 1),
                         lo=torch.cat([last.lo, pad_i], 1),
                         val=torch.cat([last.val, pad_v], 1),
                         nnz=last.nnz)
    return dataclasses.replace(states, layers=states.layers[:-1] + (grown,))


def _merge_instance_into(states: HierAssoc, src: int, dst: int,
                         sr: Semiring) -> None:
    """Fold instance ``src``'s hierarchy into instance ``dst``, in place:
    every src layer semiring-merges into dst's deepest layer (associative,
    exact); overflow and the update counters add."""
    s, d = stream.instance(states, src), stream.instance(states, dst)
    last, overflow = d.layers[-1], d.overflow
    for layer in s.layers:
        last, ovf = assoc.merge(last, layer, last.capacity, sr)
        overflow = overflow + ovf
    for f in ("hi", "lo", "val", "nnz"):
        getattr(d.layers[-1], f).copy_(getattr(last, f))
    d.overflow.copy_(overflow)
    d.n_updates.copy_(d.n_updates + s.n_updates)


def _joined(x: DTensor) -> torch.Tensor:
    """The whole tensor of a DTensor sharded over a one-axis mesh, on
    every rank: each rank's block added into zeros by one
    ``all_reduce``."""
    import torch.distributed as dist
    mesh = x.device_mesh
    if mesh.ndim != 1:
        raise ValueError(f"a sharded fleet lives on a one-axis mesh, not "
                         f"{mesh.mesh_dim_names}")
    local = x.to_local()
    if x.placements[0] == Replicate():
        return local
    whole = torch.zeros(x.shape, dtype=x.dtype, device=local.device)
    sharding = sharding_mod.Sharding(mesh, tuple(x.placements))
    whole[sharding_mod.local_slices(x.shape, sharding)] = local
    dist.all_reduce(whole, group=mesh.get_group())
    return whole


def rebalance_instances(states: HierAssoc, n_new: int,
                        sr: Semiring = sr_mod.PLUS_TIMES,
                        sharding=None) -> HierAssoc:
    """Resize an instance-batched fleet to ``n_new`` instances; returns a
    new state on the fleet's device, or under ``sharding`` (each rank's
    block, DTensors).  A fleet of DTensors is joined first (one
    ``all_reduce`` a leaf; every rank must call).

    Grow: append empty hierarchies (new ids start cold).
    Shrink: surplus instance i >= n_new folds into instance i % n_new by
    semiring merge — associativity makes the fold exact.
    """
    if isinstance(states.spills, DTensor):
        states = hier.map_state(_joined, states)
    out = _resize(states, n_new, sr)
    if sharding is not None:
        out = hier.map_state(lambda x: sharding_mod.place(x, sharding), out)
    return out


def _resize(states: HierAssoc, n_new: int, sr: Semiring) -> HierAssoc:
    n_old = states.layers[0].hi.shape[0]
    if n_new == n_old:
        return states
    if n_new > n_old:
        one = hier.create(states.cuts,
                          states.layers[0].capacity - states.cuts[0],
                          states.layers[0].dtype, sr, device=states.device)
        return hier.map_state(
            lambda a, b: torch.cat(
                [a, b.expand((n_new - n_old,) + b.shape)]), states, one)
    # a survivor absorbs ceil(n_old/n_new - 1) whole hierarchies: give
    # every instance's DEEPEST layer that much extra capacity first, so
    # the fold is lossless (shapes stay uniform across the batch)
    folds = -(-n_old // n_new) - 1
    extra = folds * sum(states.capacities)
    out = hier.map_state(torch.clone, _grow_last_layer(states, extra, sr))
    for src in range(n_new, n_old):
        _merge_instance_into(out, src, src % n_new, sr)
    return hier.map_state(lambda x: x[:n_new].clone(), out)
