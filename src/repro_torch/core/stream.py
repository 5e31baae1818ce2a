"""Streaming ingestion engine — the paper's measured workload loop (§III).

The benchmark workload is "1,000 sets of 100,000 entries" ingested per
instance.  ``ingest`` runs one hierarchy over a [T, B] block stream; the
production multi-instance layout is ``ingest_instances`` over an instance
batch ([I, ...] state, [I, T, B] stream).

``chunk=T_inner`` pre-combines T_inner consecutive stream blocks into one
larger block per hierarchy update, so their dedup/merge happens in a single
sort.  ``fused=True`` (the default) routes each block through the
single-sort fused spill cascade (core/hier.py); ``fused=False`` selects the
layered reference path (the equivalence oracle).

``ingest_instances``' default ``batch_mode="grouped"`` steps the whole fleet
one block at a time: every instance's spill depth is planned first (scalar
arithmetic on [I] counters) and read to the host with ONE ``.tolist()`` per
step; the depth-0 cohort (the overwhelmingly common case) then runs as one
batched append with zero sorts, and each deeper cohort member runs its own
merge sized to layers [0, d] — a step costs sum_i W(depth_i).
``batch_mode="bucketed"`` sizes every instance's merge to the deepest
planned depth of the step; ``"branchfree"`` and ``"switch"`` run each
instance through ``ingest`` on its own.  All four give identical states and
telemetry.

The fleet state is cloned once per ``ingest_instances`` /
``update_instances`` call and then updated in place, member by member: the
caller's state is never modified.

Every public entry dispatches through ``stages`` under the reference's
entry names (``stream.ingest``, ``stream.ingest_jit``,
``stream.update_instances``, ``stream.ingest_instances``), all eager: a
step reads its depth plan on the host, so it cannot be captured.

With tracing on (``obs.trace``), each block-step of ``ingest_instances`` is
a ``stream.step`` span (``t``, ``cohorts``: the members planned to each
depth) holding ``stream.plan`` (the plan and its read to the host, which
the ``stream.plan`` host-read site counts, tracing on or off),
``stream.append`` (the depth-0 cohort, ``members``) and one
``stream.member`` span a member run on its own (``instance``, ``depth``,
``width``: the slots its merge takes in).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch import stages
from repro_torch.analysis import contracts
from repro_torch.core import hier
from repro_torch.core import semiring as sr_mod
from repro_torch.core.hier import HierAssoc
from repro_torch.core.semiring import Semiring
from repro_torch.obs import trace as obs_trace

Tensor = torch.Tensor

BATCH_MODES = stages.BATCH_MODES


def _chunk_stream(rows: Tensor, cols: Tensor, vals: Tensor, chunk: int,
                  fused: bool, layer0_headroom: int):
    """Reshape a [..., T, B] stream to [..., T/chunk, chunk*B]."""
    T, B = rows.shape[-2], rows.shape[-1]
    if T % chunk:
        raise ValueError(f"stream length {T} not divisible by chunk "
                         f"{chunk}")
    if not fused and chunk * B > layer0_headroom:
        raise ValueError(
            f"chunk*B = {chunk * B} exceeds layer-0 headroom "
            f"{layer0_headroom}; use fused=True or a "
            f"hierarchy created with block_size >= {chunk * B}")
    shape = rows.shape[:-2] + (T // chunk, chunk * B)
    return rows.reshape(shape), cols.reshape(shape), vals.reshape(shape)


def _normalize_chunked_telemetry(telem: dict, chunk: int,
                                 time_axis: int = 0) -> dict:
    """Make telemetry comparable across ``chunk`` settings: each update's
    snapshot repeated ``chunk`` times (per-INPUT-block units), with the raw
    per-update view kept under ``telem["per_update"]``.  ``time_axis`` is 0
    for single-instance telemetry and 1 for the [I, T, ...] batched layout.
    """
    if chunk <= 1:
        return telem
    out = {k: torch.repeat_interleave(v, chunk, dim=time_axis)
           for k, v in telem.items()}
    out["per_update"] = telem
    return out


def _snapshot(s: HierAssoc) -> dict:
    return dict(nnz0=s.layers[0].nnz.clone(), spills=s.spills.clone(),
                overflow=s.overflow.clone())


def _stack_telemetry(snaps: List[dict], dim: int) -> dict:
    return {k: _stack_telemetry([s[k] for s in snaps], dim)
            if isinstance(v, dict) else torch.stack([s[k] for s in snaps], dim)
            for k, v in snaps[0].items()}


def ingest(h: HierAssoc, rows, cols, vals,
           sr: Semiring = sr_mod.PLUS_TIMES,
           use_kernel: bool = False,
           lazy_l0: bool = False,
           fused: bool = True,
           chunk: int = 1,
           batch_mode: str = "switch",
           ) -> Tuple[HierAssoc, dict]:
    """Feed a [T, B] stream of update blocks into one hierarchy.

    Returns the final state plus per-step telemetry (layer-0 nnz and
    cumulative spill/overflow counts), in per-INPUT-block units regardless
    of ``chunk``.
    """
    sig = stages.signature_for_state(
        h, sr=sr, use_kernel=use_kernel, lazy_l0=lazy_l0, fused=fused,
        chunk=chunk, batch_mode=batch_mode,
        allowed_batch_modes=("switch", "branchfree"))
    rows, cols, vals = (torch.as_tensor(x, device=h.device)
                        for x in (rows, cols, vals))
    return _ingest_wrapped(sig)(h, rows, cols, vals)


def _ingest_wrapped(sig: stages.Signature) -> stages.Wrapped:
    """Keyed single-instance ingest program for one config signature."""
    def run(h, rows, cols, vals):
        if sig.chunk > 1:
            rows, cols, vals = _chunk_stream(
                rows, cols, vals, sig.chunk, sig.fused,
                h.layers[0].capacity - h.cuts[0])
        snaps = []
        for t in range(rows.shape[0]):
            h = hier.update(h, rows[t], cols[t], vals[t], sr=sig.sr,
                            use_kernel=sig.use_kernel, lazy_l0=sig.lazy_l0,
                            fused=sig.fused, batch_mode=sig.batch_mode)
            snaps.append(_snapshot(h))
        return h, _normalize_chunked_telemetry(_stack_telemetry(snaps, 0),
                                               sig.chunk)

    return stages.wrap(run, "stream.ingest", sig)


def ingest_jit(cuts: Tuple[int, ...], block_size: int, dtype=torch.float32,
               sr: Semiring = sr_mod.PLUS_TIMES, *,
               use_kernel: bool = False,
               lazy_l0: bool = False,
               fused: bool = True,
               chunk: int = 1,
               batch_mode: str = "switch") -> stages.Wrapped:
    """A staged (state, [T, B] stream) -> (state, telemetry) ingest
    program pinned to one geometry: knobs validate through
    ``stages.signature_of``, and a state or stream of another geometry
    fails with ``stages.check_state``'s message."""
    sig = stages.signature_of(
        cuts=cuts, block_size=block_size, dtype=dtype, sr=sr,
        use_kernel=use_kernel, lazy_l0=lazy_l0, fused=fused, chunk=chunk,
        batch_mode=batch_mode,
        allowed_batch_modes=("switch", "branchfree"))

    def run(h, rows, cols, vals):
        stages.check_state(sig, h, block=rows.shape[-1])
        return ingest(h, rows, cols, vals, sr=sig.sr,
                      use_kernel=sig.use_kernel, lazy_l0=sig.lazy_l0,
                      fused=sig.fused, chunk=sig.chunk,
                      batch_mode=sig.batch_mode)

    return stages.wrap(run, "stream.ingest_jit", sig)


def clone_state(states: HierAssoc) -> HierAssoc:
    return hier.map_state(torch.clone, states)


def instance(states: HierAssoc, i: int) -> HierAssoc:
    """Instance ``i`` of a batched state (views, no copy)."""
    return hier.map_state(lambda x: x[i], states)


def stack_states(states: List[HierAssoc]) -> HierAssoc:
    return hier.map_state(lambda *xs: torch.stack(xs), *states)


def _put_instance(states: HierAssoc, i: int, one: HierAssoc,
                  up_to: int) -> None:
    """Write a single-instance result into row ``i`` of the batched state,
    in place, for layers [0, up_to] and the ledgers."""
    for j in range(up_to + 1):
        dst, src = states.layers[j], one.layers[j]
        for f in ("hi", "lo", "val", "nnz"):
            d, s = getattr(dst, f)[i], getattr(src, f)
            if d.data_ptr() != s.data_ptr():
                d.copy_(s)
    states.spills[i].copy_(one.spills)
    states.overflow[i].copy_(one.overflow)
    states.n_updates[i].copy_(one.n_updates)


def _run_member(states: HierAssoc, i: int, rows, cols, vals, n_live,
                depth: int, up_to: int, **kw) -> None:
    with obs_trace.span("stream.member", instance=i, depth=depth) as sp:
        if sp.on:
            sp.set(width=rows.shape[-1]
                   + sum(states.capacities[:up_to + 1]))
        out = hier._fused_execute_planned(
            instance(states, i), rows[i], cols[i], vals[i], n_live[i],
            depth, up_to=up_to, **kw)
        _put_instance(states, i, out, up_to)


def _select_depth0_leaves(states: HierAssoc, s0: HierAssoc, take0: Tensor
                          ) -> HierAssoc:
    """Keep the depth-0 executor's result for cohort members, the original
    state for everyone else — touching ONLY the leaves a depth-0 step can
    change (layer 0 and the scalar ledgers)."""
    def sel(a: Tensor, b: Tensor) -> Tensor:
        m = take0.reshape(take0.shape + (1,) * (a.dim() - 1))
        return torch.where(m, a, b)

    l0, a0 = states.layers[0], s0.layers[0]
    layer0 = dataclasses.replace(
        l0, hi=sel(a0.hi, l0.hi), lo=sel(a0.lo, l0.lo),
        val=sel(a0.val, l0.val), nnz=sel(a0.nnz, l0.nnz))
    return dataclasses.replace(
        states,
        layers=(layer0,) + states.layers[1:],
        spills=sel(s0.spills, states.spills),
        overflow=sel(s0.overflow, states.overflow),
        n_updates=sel(s0.n_updates, states.n_updates))


def _grouped_execute(states: HierAssoc, rows: Tensor, cols: Tensor,
                     vals: Tensor, n_live: Tensor, depths: List[int], *,
                     sr: Semiring, use_kernel: bool, lazy_l0: bool,
                     may_not_fit: bool) -> HierAssoc:
    """Depth-cohort grouped executor: per-step cost = sum_i W(depth_i).

    The depth-0 cohort runs as one batched append (zero sorts with
    ``lazy_l0``), selected per instance; without the append fast path its
    members merge into layer 0 one by one.  Each deeper cohort d runs member
    by member, each member's merge sized to exactly its layers [0, d].
    Deep members update ``states`` in place.
    """
    kw = dict(sr=sr, use_kernel=use_kernel, lazy_l0=lazy_l0)
    take0 = [i for i, d in enumerate(depths) if d == 0]
    if take0:
        with obs_trace.span("stream.append") as sp:
            if sp.on:
                sp.set(members=len(take0))
            if lazy_l0 and rows.shape[-1] <= states.cuts[0] \
                    and not may_not_fit:
                s0 = hier._fused_execute_planned(
                    states, rows, cols, vals, n_live, 0, up_to=0, **kw)
                if len(take0) < len(depths):
                    mask = torch.tensor([d == 0 for d in depths],
                                        device=states.device)
                    s0 = _select_depth0_leaves(states, s0, mask)
                states = s0
            else:
                for i in take0:
                    _run_member(states, i, rows, cols, vals, n_live, 0, 0,
                                may_not_fit=may_not_fit, **kw)
    for d in range(1, len(states.cuts)):
        for i, di in enumerate(depths):
            if di == d:
                _run_member(states, i, rows, cols, vals, n_live, d, d, **kw)
    return states


def update_instances(states: HierAssoc, rows, cols, vals,
                     sr: Semiring = sr_mod.PLUS_TIMES,
                     use_kernel: bool = False,
                     lazy_l0: bool = False,
                     batch_mode: str = "grouped",
                     mask=None) -> HierAssoc:
    """One fused update of a whole instance batch ([I, B] blocks).

    Plan-then-execute across the batch: every instance's spill depth comes
    first, read to the host once, then ``batch_mode`` picks how the planned
    depths execute:

      * ``"grouped"`` (production default) — per-depth-cohort execution
        (``_grouped_execute``): step cost is sum_i W(depth_i).
      * ``"bucketed"`` — every instance's merge sized to the deepest planned
        depth of the step (I x W(max depth)); an all-depth-0 step is the
        batched append.

    ``mask`` ([I, B] bool) blanks per-entry updates exactly like
    ``hier.update``'s mask.  Equivalent per instance to
    ``hier.update(fused=True)``; returns a new state.  Under
    ``REPRO_CHECK=1`` the input and output states, the planned depths and
    every merge are checked (``analysis/contracts.py``).
    """
    sig = contracts.front_door_signature(stages.signature_for_state(
        states, sr=sr, use_kernel=use_kernel, lazy_l0=lazy_l0,
        batch_mode=batch_mode, allowed_batch_modes=("grouped", "bucketed"),
        extra=(("masked", mask is not None),)))
    rows, cols, vals, mask = hier._as_block(states, rows, cols, vals, mask)
    return stages.dispatch("stream.update_instances", sig,
                           lambda: _update_instances_impl(sig),
                           states, rows, cols, vals, mask)


def _update_instances_impl(sig: stages.Signature):
    sr = sr_mod.get(sig.sr)

    def run(states, rows, cols, vals, mask):
        return _update_instances_(clone_state(states), rows, cols, vals, sr,
                                  sig.use_kernel, sig.lazy_l0,
                                  sig.batch_mode, mask)

    if not contracts.sig_debug(sig):
        return run

    def checked(states, rows, cols, vals, mask):
        return contracts.checked(
            "stream.update_instances", states, sr,
            lambda: run(states, rows, cols, vals, mask),
            l0_sorted=not sig.lazy_l0)
    return checked


def _update_instances_(states, rows, cols, vals, sr, use_kernel, lazy_l0,
                       batch_mode, mask, step=obs_trace.NO_SPAN
                       ) -> HierAssoc:
    """``update_instances`` on a state this call may update in place; a
    kept ``step`` span takes the cohort sizes."""
    B = rows.shape[-1]
    caps0 = states.layers[0].capacity
    # mirrors hier._update_fused: only a MASKED block wider than the
    # creation block size can physically clobber on the append fast path
    may_not_fit = mask is not None and B > caps0 - states.cuts[0]
    rows, cols, vals, n_live = hier._prepare_block(states, rows, cols, vals,
                                                   mask, sr)
    # the plan, read on the host once a block, picks the layers to merge
    with obs_trace.span("stream.plan"):
        obs_trace.host_read("stream.plan")
        # tracekit: allow(J004) entry=*ingest* the reference's lax.switch
        depths = hier._plan_spill_depth(states, n_live).tolist()
    if step.on:
        step.set(cohorts=[depths.count(d) for d in range(len(states.cuts))])
    if contracts.deep_checks_active():
        # the plan the executor trusts to slice layers, bound-checked
        # against the hierarchy's depth
        contracts.check_plan(depths, states.cuts,
                             name="stream.update_instances")
    kw = dict(sr=sr, use_kernel=use_kernel, lazy_l0=lazy_l0,
              may_not_fit=may_not_fit)
    if batch_mode == "grouped":
        return _grouped_execute(states, rows, cols, vals, n_live, depths,
                                **kw)
    dmax = max(depths)
    if dmax == 0:
        return _grouped_execute(states, rows, cols, vals, n_live, depths,
                                **kw)
    for i, d in enumerate(depths):
        _run_member(states, i, rows, cols, vals, n_live, d, dmax, **kw)
    return states


def ingest_instances(states: HierAssoc, rows, cols, vals,
                     sr: Semiring = sr_mod.PLUS_TIMES,
                     use_kernel: bool = False,
                     lazy_l0: bool = False,
                     fused: bool = True,
                     chunk: int = 1,
                     batch_mode: str = "grouped",
                     with_telemetry: bool = True):
    """Instance-batched ingest: ``states`` is an instance-batched
    ``HierAssoc`` and the stream tensors are [I, T, B].

    ``batch_mode`` (fused path only; the layered oracle always runs each
    instance on its own): ``"grouped"`` (production default), ``"bucketed"``,
    ``"branchfree"`` or ``"switch"`` — see the module docstring.  All modes
    return identical states and per-instance telemetry ([I, T, ...],
    per-input-block units under ``chunk``).  Returns a new state.
    ``with_telemetry=False`` returns ``None`` for the telemetry, and the
    grouped and bucketed modes then take no per-step snapshot (the
    service's hot path).  Under ``REPRO_CHECK=1`` the input and output
    states, every step's planned depths and every merge are checked
    (``analysis/contracts.py``).
    """
    sig = stages.signature_for_state(
        states, sr=sr, use_kernel=use_kernel, lazy_l0=lazy_l0, fused=fused,
        chunk=chunk, batch_mode=batch_mode)
    rows, cols, vals = (torch.as_tensor(x, device=states.device)
                        for x in (rows, cols, vals))
    out = ingest_instances_jit(contracts.front_door_signature(sig),
                               with_telemetry=with_telemetry)(
        states, rows, cols, vals)
    return out if with_telemetry else (out, None)


def ingest_instances_jit(sig: stages.Signature = None, *,
                         with_telemetry: bool = True, donate: bool = False,
                         **knobs) -> stages.Wrapped:
    """Staged (states, [I, T, B] stream) -> (states[, telemetry]) program.

    The one builder behind every instance-batched ingest dispatch —
    ``ingest_instances``, ``launch/ingest.py`` and
    ``query.service.make_ingest_fn`` (``with_telemetry=False,
    donate=True``: the state alone is returned) — so they share one cache
    entry per signature and ``stages.precompile_fleet`` makes exactly the
    programs the CLIs dispatch.  Build it from a ``Signature`` or from
    knob keywords.  Eager: each step reads its depth plan on the host.  A
    signature carrying ``contracts.DEBUG_EXTRA`` keys the checked build.
    """
    if sig is None:
        sig = stages.signature_of(**knobs)
    sr = sr_mod.get(sig.sr)

    def run(states, rows, cols, vals):
        out = _ingest_instances(states, rows, cols, vals, sr,
                                sig.use_kernel, sig.lazy_l0, sig.fused,
                                sig.chunk, sig.batch_mode or "grouped",
                                with_telemetry)
        return out if with_telemetry else out[0]

    fn = run
    if contracts.sig_debug(sig):
        def fn(states, rows, cols, vals):
            return contracts.checked(
                "stream.ingest_instances", states, sr,
                lambda: run(states, rows, cols, vals),
                l0_sorted=not sig.lazy_l0)
    return stages.wrap(fn, "stream.ingest_instances", sig,
                       static=(("telemetry", with_telemetry),),
                       donate_argnums=(0,) if donate else None)


def _ingest_instances(states, rows, cols, vals, sr, use_kernel, lazy_l0,
                      fused, chunk, batch_mode, with_telemetry):
    I = rows.shape[0]
    if not fused or batch_mode in ("switch", "branchfree"):
        mode = batch_mode if batch_mode in ("switch", "branchfree") \
            else "switch"
        outs = [ingest(instance(states, i), rows[i], cols[i], vals[i], sr=sr,
                       use_kernel=use_kernel, lazy_l0=lazy_l0, fused=fused,
                       chunk=chunk, batch_mode=mode) for i in range(I)]
        return (stack_states([o[0] for o in outs]),
                _stack_telemetry([o[1] for o in outs], 0)
                if with_telemetry else None)

    if chunk > 1:
        rows, cols, vals = _chunk_stream(
            rows, cols, vals, chunk, fused,
            states.layers[0].capacity - states.cuts[0])
    # a clone: the caller's state stays valid (make_ingest_fn's contract)
    # tracekit: allow(J003) entry=service.ingest one state copy a round
    s = clone_state(states)
    snaps = []
    for t in range(rows.shape[1]):
        with obs_trace.span("stream.step", t=t) as step:
            s = _update_instances_(s, rows[:, t], cols[:, t], vals[:, t],
                                   sr, use_kernel, lazy_l0, batch_mode,
                                   None, step)
        if with_telemetry:
            snaps.append(_snapshot(s))
    if not with_telemetry:
        return s, None
    return s, _normalize_chunked_telemetry(_stack_telemetry(snaps, 1), chunk,
                                           time_axis=1)
