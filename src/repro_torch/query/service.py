"""Read-while-ingest service loop: serve queries AGAINST the live fleet.

The point of sustaining a billion updates per second is to *analyze* the
streaming network data while it flows — so the read path must run while
the write path streams, without draining the hierarchy.  This module
interleaves ingest rounds (``stream.ingest_instances``, the production
depth-cohort grouped layout) with query batches (``engine`` point lookups
and ``analytics`` top-k reductions over every local instance at once) and
reports both sides of the ledger: sustained updates/s, queries/s and
per-batch query latency.  The engine never mutates or merges state, so the
only coupling between the two paths is the device itself.

Every round and batch is timed on the host clock and ended by
``torch.cuda.synchronize()`` when the fleet is on the card.
``launch/query.py`` is its command line.

The three steps are ``stages`` entries under the reference's names:
``service.ingest`` (``stream.ingest_instances``' program without
telemetry) and ``service.analytics`` dispatch eagerly; on the card
``service.point_query`` is a captured CUDA graph (its ``merge_multi``
launches replay with it).  The warm-up before the timed rounds dispatches
each until it is steady — for the point query, its eager warm-up and its
capture — so the timed batches are replays.
"""
from __future__ import annotations

import time
from typing import Tuple

import torch

from repro_torch import stages
from repro_torch.core import semiring as sr_mod
from repro_torch.core import stream
from repro_torch.core.semiring import Semiring
from repro_torch.obs import slo as obs_slo
from repro_torch.obs import trace as obs_trace
from repro_torch.query import analytics, engine

Tensor = torch.Tensor


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_ingest_fn(sr: Semiring = sr_mod.PLUS_TIMES, *,
                   use_kernel: bool = False, lazy_l0: bool = False,
                   fused: bool = True, chunk: int = 1,
                   batch_mode: str = "grouped"):
    """Staged (states, [I, T, B] stream) -> states round step, the
    per-step telemetry dropped: ``stream.ingest_instances_jit``'s program,
    so the service shares its cache entry with every other ingest entry
    point.  Returns a new state (the argument is not modified)."""
    sig = stages.signature_of(sr=sr, use_kernel=use_kernel, lazy_l0=lazy_l0,
                              fused=fused, chunk=chunk,
                              batch_mode=batch_mode)
    return stream.ingest_instances_jit(sig, with_telemetry=False,
                                       donate=True)


def make_point_query_fn(sr: Semiring = sr_mod.PLUS_TIMES, *,
                        use_kernel: bool = False, l0_mode: str = "auto"):
    """Staged (states, q_rows [Q], q_cols [Q]) -> values [I, Q]: one
    engine program answers the whole query vector for every local
    instance.  A ``"graph"`` entry: captured on the card, where its result
    stays valid until the next dispatch of the same shapes (the engine's
    body, unchecked, as the reference's vmapped lookup is)."""
    sig = stages.signature_of(sr=sr, use_kernel=use_kernel, l0_mode=l0_mode)
    sr = sr_mod.get(sig.sr)

    def run(states, q_rows, q_cols):
        return engine._point_lookup(states, q_rows, q_cols, sr,
                                    sig.use_kernel, sig.l0_mode)
    return stages.wrap(run, "service.point_query", sig, kind="graph")


def make_analytics_fn(num_rows: int, k: int,
                      sr: Semiring = sr_mod.PLUS_TIMES):
    """Staged states -> (top-k totals [I, k], top-k row ids [I, k])."""
    sig = stages.signature_of(sr=sr, extra=(("num_rows", int(num_rows)),
                                            ("k", int(k))))
    sr = sr_mod.get(sig.sr)

    def run(states):
        return analytics.top_k_rows(states, int(num_rows), int(k), sr=sr)
    return stages.wrap(run, "service.analytics", sig)


def run_service(states, rows: Tensor, cols: Tensor, vals: Tensor,
                q_rows: Tensor, q_cols: Tensor, *,
                rounds: int,
                sr: Semiring = sr_mod.PLUS_TIMES,
                use_kernel: bool = False, lazy_l0: bool = False,
                fused: bool = True, chunk: int = 1,
                batch_mode: str = "grouped",
                l0_mode: str = "auto",
                queries_per_round: int = 1,
                analytics_num_rows: int = 0, analytics_k: int = 8,
                with_queries: bool = True,
                slo_p99_ms: float | None = None) -> Tuple[object, dict]:
    """Interleave ``rounds`` ingest rounds with query batches.

    ``rows``/``cols``/``vals`` are the full [I, T, B] stream (T must divide
    by ``rounds``); ``q_rows``/``q_cols`` are [Q] query vectors reissued
    every batch.  Round 0 is the untimed warm-up (the kernels' first calls
    included).  ``with_queries=False`` runs the identical ingest schedule
    with no read path — the ingest-only baseline.  Returns (final states,
    stats dict).

    Query-batch latency goes through the shared mergeable ``obs.metrics``
    histogram: ``latency_p50_s``/``latency_p95_s``/``latency_p99_s`` are
    interpolated percentiles and ``latency_max_s`` is exact.
    ``slo_p99_ms`` arms the per-batch SLO check (``slo_attainment``,
    ``slo_breaches``; each breach emits an ``slo_breach`` obs event when
    tracing is on).  Ingest rounds run under a non-raising
    ``obs.slo.StallDetector`` (``stalled_rounds``).
    """
    I, T, B = rows.shape
    if rounds < 2:
        # round 0 is the untimed warm-up round: with rounds=1 the WHOLE
        # stream ingests inside it and the loop below never runs, so the
        # reported rates would be 0.0 — refuse instead.
        raise ValueError(
            f"rounds must be >= 2 (round 0 is the untimed warmup round; "
            f"rounds={rounds} would ingest the whole stream in it and "
            f"report zero rates)")
    if T % rounds:
        raise ValueError(f"stream length {T} not divisible by rounds "
                         f"{rounds}")
    per = T // rounds
    device = states.device
    ingest = make_ingest_fn(sr, use_kernel=use_kernel, lazy_l0=lazy_l0,
                            fused=fused, chunk=chunk, batch_mode=batch_mode)
    query = make_point_query_fn(sr, use_kernel=use_kernel, l0_mode=l0_mode)
    analytic = (make_analytics_fn(analytics_num_rows, analytics_k, sr)
                if analytics_num_rows else None)

    # warm-up outside the timed region (the service's steady state is what
    # the rates describe, not the first calls): each step dispatched until
    # it is steady, so the point query's capture is not timed
    states = ingest(states, rows[:, :per], cols[:, :per], vals[:, :per])
    if with_queries:
        query.steady(states, q_rows, q_cols)
        if analytic is not None:
            analytic.steady(states)
    _sync(device)

    ingest_wall = 0.0
    query_wall = 0.0          # point-lookup batches only
    analytics_wall = 0.0      # top-k batches, kept separate so queries/s
    n_queries = 0             # is the point-lookup rate, not a blend
    tracker = obs_slo.SLOTracker(target_p99_ms=slo_p99_ms, name="query")
    stall = obs_slo.StallDetector(name="service.ingest")
    for rnd in range(1, rounds):
        sl = slice(rnd * per, (rnd + 1) * per)
        t0 = time.perf_counter()
        states = ingest(states, rows[:, sl], cols[:, sl], vals[:, sl])
        _sync(device)
        dt = time.perf_counter() - t0
        ingest_wall += dt
        stall.observe(dt)
        if with_queries:
            for _ in range(queries_per_round):
                t0 = time.perf_counter()
                query(states, q_rows, q_cols)
                _sync(device)
                dt = time.perf_counter() - t0
                query_wall += dt
                tracker.observe(dt)
                n_queries += I * q_rows.shape[0]
            if analytic is not None:
                t0 = time.perf_counter()
                analytic(states)
                _sync(device)
                analytics_wall += time.perf_counter() - t0
    query.release()
    timed_rounds = rounds - 1
    n_updates = I * timed_rounds * per * B
    hist = tracker.hist
    stats = dict(
        updates_per_s=n_updates / ingest_wall if ingest_wall else 0.0,
        queries_per_s=n_queries / query_wall if query_wall else 0.0,
        ingest_wall_s=ingest_wall,
        query_wall_s=query_wall,
        analytics_wall_s=analytics_wall,
        n_updates=n_updates,
        n_queries=n_queries,
        latency_p50_s=hist.percentile(50) if tracker.n else 0.0,
        latency_p95_s=hist.percentile(95) if tracker.n else 0.0,
        latency_p99_s=hist.percentile(99) if tracker.n else 0.0,
        latency_max_s=hist.vmax if tracker.n else 0.0,
        slo_p99_ms=slo_p99_ms,
        slo_attainment=tracker.attainment(),
        slo_breaches=tracker.breaches,
        stalled_rounds=stall.stalls,
        rounds=timed_rounds,
    )
    obs_trace.emit("service_summary", n_updates=n_updates,
                   ingest_wall_s=ingest_wall, n_queries=n_queries,
                   query_wall_s=query_wall,
                   stalled_rounds=stall.stalls,
                   slo=tracker.summary() if tracker.n else None)
    return states, stats
