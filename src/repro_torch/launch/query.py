"""Query-serving CLI: answer queries against the fleet WHILE it ingests.

    PYTHONPATH=src python -m repro_torch.launch.query --instances 32 \\
        --blocks 128 --block-size 1024 --cuts 2048,16384,131072 \\
        --scale 22 --rounds 8 --queries 256 --use-kernel

The read-side companion of ``launch/ingest.py``: every instance ingests its
own R-MAT stream through the production fused path, and between ingest
rounds the query engine answers Q-vector point lookups plus a top-k
heavy-hitter analytic against the LIVE hierarchies — no flush, no merge.
Reports sustained updates/s NEXT TO queries/s and per-batch query latency,
plus the ingest-only baseline rate so read-path interference is visible.
Runs on the CUDA device unless ``--device cpu``.

Defaults for the query knobs come from ``configs/d4m_stream.py``
(``query_batch``/``query_l0_mode``/``queries_per_round``).
``--precompile`` makes the dispatch set up front at the service's shapes
(``stages.precompile_fleet``); ``--stages-cache DIR`` keeps the kernel
libraries under ``DIR/build``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device, stages
from repro_torch.configs import get_config
from repro_torch.core import distributed
from repro_torch.data.powerlaw import instance_streams
from repro_torch.kernels import registry
from repro_torch.query import service


def run_with_states(args):
    """Run the ingest-only baseline, then the service with queries, on the
    same stream.  Returns ``(stats, baseline final states, final states)``;
    ``stats`` is the run with queries plus ``ingest_only_updates_per_s``,
    ``ingest_interference``, and the kernel launches of each run
    (``launches``, ``ingest_only_launches``: the registry's counters'
    increase over the run)."""
    device = resolve_device(args.device)
    cuts = tuple(int(c) for c in args.cuts.split(","))
    kwargs = dict(
        rounds=args.rounds,
        lazy_l0=not args.no_lazy_l0,
        use_kernel=args.use_kernel,
        fused=not args.layered,
        chunk=args.chunk,
        batch_mode=args.batch_mode,
        l0_mode=args.l0_mode,
        queries_per_round=args.queries_per_round,
        analytics_num_rows=0 if args.no_analytics else 1 << args.scale,
        analytics_k=args.top_k,
        slo_p99_ms=args.slo_p99_ms,
    )
    if args.stages_cache:
        stages.set_cache_dir(args.stages_cache)
    if args.obs:
        from repro_torch import obs
        obs.enable(args.obs_dir or None)
    if args.precompile:
        # run_service slices the stream into blocks // rounds blocks a
        # round: precompile exactly that shape
        sig = stages.signature_of(
            cuts=cuts, block_size=args.block_size,
            fused=not args.layered, lazy_l0=not args.no_lazy_l0,
            chunk=args.chunk, use_kernel=args.use_kernel,
            batch_mode=args.batch_mode, l0_mode=args.l0_mode)
        stages.precompile_fleet(
            sig, instances=args.instances,
            blocks=args.blocks // args.rounds, queries=args.queries,
            analytics_num_rows=kwargs["analytics_num_rows"],
            analytics_k=args.top_k, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    rows, cols, vals = instance_streams(
        gen, args.instances, args.blocks, args.block_size, scale=args.scale)
    n_keys = 1 << args.scale
    q_rows, q_cols = (torch.randint(0, n_keys, (args.queries,), generator=gen,
                                    device=device, dtype=torch.int32)
                      for _ in range(2))

    def serve(with_queries):
        before = registry.launches()
        states = distributed.create_instances(
            args.instances, cuts, args.block_size, device=device)
        states, stats = service.run_service(
            states, rows, cols, vals, q_rows, q_cols,
            with_queries=with_queries, **kwargs)
        after = registry.launches()
        stats["launches"] = {k: after[k] - before[k] for k in after}
        return states, stats

    base_states, base = serve(False)
    states, stats = serve(True)
    stats["ingest_only_launches"] = base["launches"]
    stats["ingest_only_updates_per_s"] = base["updates_per_s"]
    stats["ingest_interference"] = (
        1.0 - stats["updates_per_s"] / base["updates_per_s"]
        if base["updates_per_s"] else 0.0)
    if args.obs:
        from repro_torch.obs import metrics as obs_metrics
        from repro_torch.obs import trace as obs_trace
        obs_trace.emit("fleet", **obs_metrics.fleet_sample(states))
        obs_metrics.export_stages_gauges()
        obs_trace.emit("metrics", **obs_metrics.REGISTRY.snapshot())
    return stats, base_states, states


def run(args) -> dict:
    return run_with_states(args)[0]


def parser() -> argparse.ArgumentParser:
    cfg = get_config("d4m-stream")
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--instances", type=int, default=8)
    ap.add_argument("--blocks", type=int, default=64)
    ap.add_argument("--block-size", type=int, default=2048)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--cuts", default="4096,32768,262144")
    ap.add_argument("--scale", type=int, default=18)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queries", type=int, default=cfg.query_batch,
                    help="Q-vector width per engine call")
    ap.add_argument("--queries-per-round", dest="queries_per_round",
                    type=int, default=cfg.queries_per_round)
    ap.add_argument("--l0-mode", dest="l0_mode",
                    choices=stages.L0_MODES, default=cfg.query_l0_mode,
                    help="layer-0 query strategy: masked raw scan vs one "
                    "canonicalization of the buffer per instance")
    ap.add_argument("--top-k", dest="top_k", type=int, default=8,
                    help="heavy-hitter rows per analytics batch")
    ap.add_argument("--no-analytics", action="store_true",
                    help="point lookups only (skip the top-k reduction)")
    ap.add_argument("--layered", action="store_true",
                    help="reference per-layer cascade on the write side")
    ap.add_argument("--no-lazy-l0", action="store_true",
                    help="canonical layer 0 instead of the append buffer")
    ap.add_argument("--chunk", type=int, default=1)
    ap.add_argument("--use-kernel", dest="use_kernel", action="store_true",
                    help="hand-written CUDA merge kernels (their plain "
                    "PyTorch versions on the CPU)")
    ap.add_argument("--batch-mode", dest="batch_mode",
                    choices=stages.BATCH_MODES, default=cfg.batch_mode)
    ap.add_argument("--stages-cache", dest="stages_cache", default="",
                    help="persistent compile-cache directory "
                    "(repro.stages.set_cache_dir)")
    ap.add_argument("--precompile", action="store_true",
                    help="compile the whole dispatch set up front "
                    "(stages.precompile_fleet) before serving")
    ap.add_argument("--obs", action="store_true",
                    help="emit obs.jsonl events; aggregate with python -m "
                    "repro_torch.launch.monitor")
    ap.add_argument("--obs-dir", dest="obs_dir", default="",
                    help="observability output directory (default 'obs' "
                    "or REPRO_OBS_DIR)")
    ap.add_argument("--slo-p99-ms", dest="slo_p99_ms", type=float,
                    default=None,
                    help="query-batch latency SLO target: breaches are "
                    "counted (and emitted as obs events) per batch, and "
                    "slo_attainment lands in the stats")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the fleet (default cuda; the run "
                    "fails when it is absent)")
    return ap


def main():
    out = run(parser().parse_args())
    print(f"ingest  {out['updates_per_s']:,.0f} upd/s "
          f"(ingest-only {out['ingest_only_updates_per_s']:,.0f}, "
          f"interference {out['ingest_interference']:+.1%})")
    print(f"queries {out['queries_per_s']:,.0f} q/s over "
          f"{out['n_queries']:,} lookups; "
          f"latency p50 {out['latency_p50_s']*1e3:.2f} / "
          f"p95 {out['latency_p95_s']*1e3:.2f} / "
          f"p99 {out['latency_p99_s']*1e3:.2f} ms "
          f"(max {out['latency_max_s']*1e3:.2f} ms)")
    if out.get("slo_p99_ms") is not None:
        print(f"SLO     p99 target {out['slo_p99_ms']:g} ms: "
              f"attainment {out['slo_attainment']:.2%} "
              f"({out['slo_breaches']} breaches)")


if __name__ == "__main__":
    main()
