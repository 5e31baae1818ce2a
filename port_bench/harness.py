"""Drives one cell: set-up, the measured window, the comparison with the
reference, and the result line's numbers.

The window is a loop on the host clock.  Each turn makes one
``stream.ingest_instances`` call of ``blocks_per_call`` blocks an
instance (closed loop, back to back) and synchronizes; an epoch's last
call is followed by a reset of the fleet to empty, inside the window.
With queries on, each turn then answers every batch that has fallen due
by a Poisson schedule fixed before the window.  A batch's answer is read
to the host, and its latency runs from when it was due to then.

Everything the readers of ``metrics/`` need is kept in a ``Record``.
"""
from __future__ import annotations

import dataclasses
import importlib
import shutil
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from port_bench import gen, judge, spec

clock = time.perf_counter
ARRIVAL_HORIZON = 1.5       # an open loop's schedule, in windows


class Program:
    """The system under test: ``repro_torch``'s instance-batched ingest
    (``stream.ingest_instances`` through its ``stages`` front door) and
    the staged point query (``service.make_point_query_fn``)."""

    entries = ("stream.ingest_instances", "service.point_query")

    def __init__(self, cfg: dict, device, value_dtype=None):
        from repro_torch.core import distributed, semiring, stream
        from repro_torch.kernels import registry
        from repro_torch.query import service
        self._distributed, self._stream = distributed, stream
        self._registry = registry
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = value_dtype or getattr(torch, cfg["value_dtype"])
        sr = semiring.get(cfg["semiring"])
        self.knobs = dict(sr=sr, use_kernel=cfg["use_kernel"],
                          lazy_l0=cfg["lazy_l0"], fused=cfg["fused"],
                          batch_mode=cfg["batch_mode"])
        self.query_fn = service.make_point_query_fn(
            sr, use_kernel=cfg["use_kernel"], l0_mode=cfg["query_l0_mode"])
        self._obs_dir = None

    def empty(self):
        c = self.cfg
        return self._distributed.create_instances(
            c["instances"], tuple(c["cuts"]), c["block"], dtype=self.dtype,
            device=self.device)

    def ingest(self, states, rows, cols, vals):
        """(new states, per-step telemetry)."""
        return self._stream.ingest_instances(states, rows, cols, vals,
                                             **self.knobs)

    def query(self, states, q_rows, q_cols):
        return self.query_fn(states, q_rows, q_cols)

    def warm_query(self, states, q_rows, q_cols) -> None:
        self.query_fn.steady(states, q_rows, q_cols)

    def launches(self) -> dict:
        return self._registry.launches()

    def annotate(self, on: bool) -> None:
        """Nest every ``stages`` dispatch in a profiler range of its entry's
        name (``obs.enable(annotate=True)``; its records go to a
        directory under the temporary directory, removed at the end)."""
        from repro_torch import obs
        if on:
            self._obs_dir = tempfile.mkdtemp(prefix="port_bench_obs")
            obs.enable(self._obs_dir, annotate=True)
        elif self._obs_dir is not None:
            obs.disable()
            shutil.rmtree(self._obs_dir, ignore_errors=True)
            self._obs_dir = None

    def release(self) -> None:
        self.query_fn.release()


@dataclasses.dataclass
class Record:
    """What a run measured, for the metric readers."""
    cell: str
    config: dict
    traffic: dict
    seconds: float
    setup_s: float = 0.0
    window_s: float = 0.0
    updates: int = 0
    due: int = 0
    calls: list = dataclasses.field(default_factory=list)
    batches: list = dataclasses.field(default_factory=list)
    trace: object = None
    device_name: str = ""
    peaks: Optional[dict] = None


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _Range:
    """A profiler range opened only while a trace is running."""

    def __init__(self, name: str, on: bool):
        self.cm = torch.profiler.record_function(name) if on else None

    def __enter__(self):
        if self.cm is not None:
            self.cm.__enter__()

    def __exit__(self, *exc):
        if self.cm is not None:
            self.cm.__exit__(*exc)


def run_cell(name: str, cfg: dict, traffic: dict, metric_entries: list, *,
             seed: int, seconds: float, trace: bool, device,
             t_start: Optional[float] = None, value_dtype=None,
             on_record=None) -> dict:
    """One run of a cell; returns the result line's fields (``checks``
    last).  ``value_dtype`` replaces the configuration's value type (the
    program's lower-precision path, the control).

    A traced run measures two windows of at most ``trace_seconds`` each:
    the first untraced, from which the metrics whose ``source`` is
    ``host_clock`` are read (the profiler slows the host), the second
    traced, from which every other metric is read."""
    t_start = clock() if t_start is None else t_start
    if trace:
        seconds = min(seconds, float(traffic["trace_seconds"]))
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    I, B, T = cfg["instances"], cfg["block"], cfg["epoch_blocks"]
    k, scale = cfg["blocks_per_call"], cfg["rmat_scale"]
    queries = traffic.get("queries")
    ref = importlib.import_module(
        "port_bench." + Path(cfg["reference"]).stem)

    # ---------------------------------------------------------- set-up --
    rows, cols, vals = gen.streams(seed, traffic["streams"], I, T, B, scale,
                                   cfg["values"], device, cfg["rmat_params"])
    if queries:
        q_rows, q_cols = gen.key_sets(seed, queries["key_sets"],
                                      cfg["query_batch"],
                                      queries["rmat_share"], scale, device,
                                      cfg["rmat_params"])
        # the captured query copies a batch's keys into its inputs, so
        # every batch passes these two buffers, never a view of the sets
        qr_buf, qc_buf = q_rows[0].clone(), q_cols[0].clone()
        # the schedule runs on past the window, so the last turn's drain
        # meets arrivals at the rate every other turn does
        arrivals = gen.poisson_arrivals(queries["rate_per_s"],
                                        seconds * ARRIVAL_HORIZON)
    program = Program(cfg, device, value_dtype)

    def block_range(s, b0, n):
        return (rows[s][:, b0:b0 + n], cols[s][:, b0:b0 + n],
                vals[s][:, b0:b0 + n])

    w = program.empty()
    for b0 in range(0, int(traffic["warmup_blocks"]), k):
        w, _ = program.ingest(w, *block_range(0, b0, k))
    if queries:
        program.warm_query(w, qr_buf, qc_buf)
    del w
    state = program.empty()
    _sync(device)

    kept = []            # (stream, blocks, key set, answers [I, K])
    epoch, b = 0, 0

    def measure(rec: Record, traced: bool) -> None:
        """One window of ``seconds``: ingest calls back to back, and
        after each the batches that fell due; then the batches due inside
        the window wait, as long as it takes."""
        nonlocal state, epoch, b
        t0 = clock()

        def answer(j: int) -> None:
            due = t0 + float(arrivals[j])
            s_idx = j % queries["key_sets"]
            with _Range("bench.query", traced):
                td = clock()
                qr_buf.copy_(q_rows[s_idx])
                qc_buf.copy_(q_cols[s_idx])
                ans = program.query(state, qr_buf, qc_buf).to("cpu")
                ta = clock()
            rec.batches.append(dict(due=due - t0, dispatch=td - t0,
                                    answer=ta - t0))
            kept.append((epoch % traffic["streams"], b, s_idx,
                         ans.to(torch.float64)))

        nq = 0
        t_end = t0 + seconds
        while clock() < t_end:
            if b == T:
                with _Range("bench.reset", traced):
                    state = program.empty()
                    _sync(device)
                epoch, b = epoch + 1, 0
            s = epoch % traffic["streams"]
            before = None
            if traced:
                before = (_layer_nnz(state), state.spills.to("cpu"))
            with _Range("bench.ingest", traced):
                l0 = program.launches()["assoc.sort_route"]
                ti = clock()
                state, telem = program.ingest(state, *block_range(s, b, k))
                _sync(device)
                te = clock()
                l1 = program.launches()["assoc.sort_route"]
            call = dict(start=ti - t0, end=te - t0, blocks=k,
                        updates=I * k * B, sort_route=l1 - l0)
            if before is not None:
                call["merge"] = _merge_traffic(before, state, telem, B)
            rec.calls.append(call)
            rec.updates += I * k * B
            b += k
            while queries and nq < arrivals.size \
                    and t0 + arrivals[nq] <= clock():
                answer(nq)
                nq += 1
        while queries and nq < arrivals.size and arrivals[nq] < seconds:
            answer(nq)
            nq += 1
        _sync(device)
        rec.window_s = clock() - t0
        if queries:
            rec.due = int((arrivals < seconds).sum())

    # --------------------------------------------------------- windows --
    rec = Record(cell=name, config=cfg, traffic=traffic, seconds=seconds)
    rec.setup_s = clock() - t_start
    plain = rec
    tr = None
    if trace:
        measure(plain, traced=False)
        from port_bench import tracing
        tr = tracing.Trace(program.entries)
        program.annotate(True)
        rec = Record(cell=name, config=cfg, traffic=traffic,
                     seconds=seconds, setup_s=plain.setup_s)
        tr.start()
        with torch.profiler.record_function(tracing.WINDOW):
            measure(rec, traced=True)
        tr.stop()
        program.annotate(False)
        rec.trace = tr
    else:
        measure(rec, traced=False)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    program.release()
    windows = [plain] if plain is rec else [plain, rec]

    # ----------------------------------------------------- comparison --
    checks = _compare(ref, state, rows, cols, vals, cfg, traffic, kept,
                      q_rows if queries else None,
                      q_cols if queries else None,
                      s_now=epoch % traffic["streams"], b_now=b)
    due = sum(r.due for r in windows)
    if queries:
        answered = sum(int(x["due"] < seconds) for r in windows
                       for x in r.batches)
        checks["unanswered"] = (due - answered, 0)
    del state, rows, cols, vals

    # --------------------------------------------------------- result --
    if device.type == "cuda":
        from port_bench import arith
        name_ = torch.cuda.get_device_name(device)
        for r in windows:
            r.device_name, r.peaks = name_, arith.peaks(name_)
    if on_record is not None:
        on_record(rec)
    metrics = {}
    for m in metric_entries:
        run = plain if m["source"] == "host_clock" else rec
        value = spec.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=rec.device_name or device.type, count=1,
               memory_peak_bytes=int(peak))
    out = dict(correct=all(v <= lim for v, lim in checks.values()),
               attempted=sum(len(r.calls) for r in windows) + due,
               failed=checks["unanswered"][0] if queries else 0,
               metrics=metrics, device=dev)
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
    out["checks"] = {n: {"value": int(v), "limit": lim}
                     for n, (v, lim) in checks.items()}
    return out


def _layer_nnz(state) -> np.ndarray:
    """``[I, L]`` live-slot counts of every layer, on the host."""
    return torch.stack([l.nnz for l in state.layers], -1).to("cpu").numpy()


def _merge_traffic(before, state, telem, block: int):
    """(appended, read, written) entries of one call, from the layers'
    counts before and after it and its per-step telemetry."""
    from port_bench import arith
    nnz_start, spills_start = before
    spills = torch.cat([spills_start.unsqueeze(1),
                        telem["spills"].to("cpu")], 1)
    # a depth-d step bumps the spill counters of layers 0..d-1; the last
    # layer's counter moves only under pressure and says nothing of depth
    depth = (spills[:, 1:, :-1] - spills[:, :-1, :-1]).sum(-1).numpy()
    return arith.merge_traffic(nnz_start, _layer_nnz(state),
                               telem["nnz0"].to("cpu").numpy(), depth, block)


def _compare(ref, state, rows, cols, vals, cfg, traffic, kept, q_rows,
             q_cols, *, s_now: int, b_now: int) -> dict:
    """The numbers compared with the reference, each with its limit."""
    I, B, scale = cfg["instances"], cfg["block"], cfg["rmat_scale"]
    counts, overflow = judge.counters(state)
    checks = {"update_count_gap": (int((counts - b_now * B).abs().sum()), 0),
              "overflow": (int(overflow.sum()), 0)}
    groups = {}
    for s, b, s_idx, ans in kept:
        groups.setdefault(s, []).append((b, s_idx, ans))
    asked = {}
    for s, items in groups.items():
        sets = torch.tensor([x[1] for x in items], device=q_rows.device)
        keys = ref.pack(q_rows[sets], q_cols[sets], scale)
        blocks = torch.tensor([x[0] for x in items], device=keys.device)
        asked[s] = (keys.reshape(-1),
                    blocks.unsqueeze(1).expand(keys.shape).reshape(-1),
                    torch.stack([x[2] for x in items]).to(keys.device))
    wrong_entries = wrong_answers = 0
    for i in range(I):
        for s in sorted(set(asked) | {s_now}):
            ps = ref.PrefixSums(rows[s, i], cols[s, i], vals[s, i], scale)
            if s == s_now:
                got = judge.contents(state, i, scale)
                wrong_entries += ref.mismatches(*got, *ps.contents(b_now))
            if s in asked:
                keys, blocks, ans = asked[s]
                want = ps.answers(keys, blocks).reshape(ans[:, i].shape)
                wrong_answers += int((ans[:, i] != want).sum())
            del ps
    checks["wrong_entries"] = (wrong_entries, 0)
    if traffic.get("queries"):
        checks["wrong_answers"] = (wrong_answers, 0)
    return checks
