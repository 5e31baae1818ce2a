"""Elastic scaling of D4M instance fleets.

Node loss or a fleet resize changes the instance count from N_old to
N_new.  Checkpoints are device-agnostic numpy trees
(``checkpoint/ckpt.py``), so an elastic restart is:

  1. restore the checkpoint (each leaf on the template's device, or the
     ``device`` asked for);
  2. resize the fleet with ``rebalance_instances``;
  3. resume the step loop.

``rebalance_instances`` changes the INSTANCE count: a grown fleet gets
fresh empty hierarchies for the new ids; a shrunk fleet folds its surplus
instances' state into the survivors by semiring merge (no update is lost —
associativity is exactly what makes this legal).  The fleet lives on one
card, so the reference's ``sharding`` argument (re-placing the result on a
mesh) has no counterpart here; ``core.distributed.instance_assignment``
keeps the rendezvous hash for a fleet spread over devices.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import assoc, hier, stream
from repro_torch.core import semiring as sr_mod
from repro_torch.core.assoc import SENTINEL, AssocSegment
from repro_torch.core.hier import HierAssoc
from repro_torch.core.semiring import Semiring


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


def rebalance_instances(states: HierAssoc, n_new: int,
                        sr: Semiring = sr_mod.PLUS_TIMES) -> HierAssoc:
    """Resize an instance-batched fleet to ``n_new`` instances; returns a
    new state on the fleet's device.

    Grow: append empty hierarchies (new ids start cold).
    Shrink: surplus instance i >= n_new folds into instance i % n_new by
    semiring merge — associativity makes the fold exact.
    """
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
