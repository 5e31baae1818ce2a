"""The paper's experiment: N hierarchical D4M instances x R-MAT edge streams.

    PYTHONPATH=src python -m repro_torch.launch.ingest --instances 32 \\
        --blocks 128 --rounds 16 --block-size 1024 --scale 22 \\
        --cuts 2048,16384,131072 --use-kernel

Reproduces §III of the paper on one device: every instance ingests its own
power-law stream, there is NO cross-instance traffic on the update path,
and the reported metric is sustained updates/second.  Telemetry verifies
the hierarchy claim: the fraction of updates that never leave layer 0.
Runs on the CUDA device unless ``--device cpu``; each round is timed
between ``torch.cuda.synchronize()`` calls.

Fault tolerance: the whole fleet state (every instance's hierarchy) is
checkpointed atomically every ``--ckpt-every`` rounds in the JAX
package's format (``checkpoint/ckpt.py``), ``--resume`` restarts from the
latest checkpoint, and a restored fleet can change its instance count
(``runtime/elastic.py``).  Round r's stream comes from a generator seeded
from (seed, r), so a resumed run draws the rounds it missed exactly as an
uninterrupted run does.

``--precompile`` makes the config's whole dispatch set up front
(``stages.precompile_fleet``), so the run itself adds no compile;
``--stages-cache DIR`` keeps the kernel libraries under ``DIR/build``
(``stages.set_cache_dir``).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device, stages
from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.core import distributed, hier, stream
from repro_torch.data.powerlaw import instance_streams


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def signature(args) -> stages.Signature:
    """The validated knobs of a parsed command line."""
    fused = not args.layered
    # "auto" couples the append buffer to the fused default; "on"/"off"
    # decouple the two knobs for A/B runs
    lazy_l0 = fused if args.lazy_l0 == "auto" else args.lazy_l0 == "on"
    return stages.signature_of(
        cuts=tuple(int(c) for c in args.cuts.split(",")),
        block_size=args.block_size, fused=fused, lazy_l0=lazy_l0,
        chunk=args.chunk, use_kernel=args.use_kernel,
        batch_mode=args.batch_mode)


def ingest_knobs(sig: stages.Signature) -> dict:
    """``stream.ingest_instances`` keyword arguments of a signature."""
    return dict(use_kernel=sig.use_kernel, lazy_l0=sig.lazy_l0,
                fused=sig.fused, chunk=sig.chunk, batch_mode=sig.batch_mode)


def round_generator(seed: int, rnd: int, device) -> torch.Generator:
    """Round ``rnd``'s generator, seeded from ``(seed, rnd)``: the port's
    counterpart of ``jax.random.fold_in(key, rnd)``, so any round can be
    drawn again on its own."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) << 32) | int(rnd))
    return gen


def run_with_state(args):
    """Run the ingest; returns ``(result dict, final fleet state)``."""
    device = resolve_device(args.device)
    sig = signature(args)
    states = distributed.create_instances(
        args.instances, sig.cuts, args.block_size, device=device)
    stages.check_state(sig, states, block=args.block_size)
    if args.stages_cache:
        stages.set_cache_dir(args.stages_cache)
    if args.obs:
        from repro_torch import obs
        from repro_torch.obs import metrics as obs_metrics
        from repro_torch.obs import trace as obs_trace
        obs.enable(args.obs_dir or None)
    blocks_per_round = max(args.blocks // args.rounds, 1)
    if args.precompile:
        report = stages.precompile_fleet(
            sig, instances=args.instances, blocks=blocks_per_round,
            device=device)
        if args.verbose:
            for entry, how in report.items():
                print(f"[precompile] {entry}: {how}")

    start_round = 0
    if args.ckpt_dir and args.resume:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            states = restore(args.ckpt_dir, last, states)
            start_round = last
            print(f"[resume] round {last}")
    # spill counters in the state are cumulative since CREATION; remember
    # the restored baseline so the fast-layer fraction below only accounts
    # for this run's updates.
    spills_l0_baseline = int(torch.sum(states.spills[:, 0]))

    total_updates = 0
    wall = 0.0
    spill_counts = None
    if args.obs:
        # baseline fleet sample BEFORE the stream: the monitor's rate is
        # the exact counter delta over the summed round walls
        obs_trace.emit("fleet", **obs_metrics.fleet_sample(states))
    for rnd in range(start_round, args.rounds):
        rows, cols, vals = instance_streams(
            round_generator(args.seed, rnd, device), args.instances,
            blocks_per_round, args.block_size, scale=args.scale)
        _sync(device)
        t0 = time.perf_counter()
        states, telem = stream.ingest_instances(states, rows, cols, vals,
                                                **ingest_knobs(sig))
        _sync(device)
        dt = time.perf_counter() - t0
        wall += dt
        n = args.instances * blocks_per_round * args.block_size
        total_updates += n
        spill_counts = telem["spills"][:, -1]     # final cumulative spills
        if args.obs:
            # one ingest_round span + one fleet snapshot, both outside the
            # timed region
            obs_trace.emit("ingest_round", round=rnd, updates=n,
                           wall_s=dt, rate=n / dt)
            obs_trace.emit("fleet", **obs_metrics.fleet_sample(states))
        if args.verbose:
            print(f"round {rnd}: {n/dt:,.0f} updates/s "
                  f"(total {total_updates:,})")
        if args.ckpt_dir and (rnd + 1) % args.ckpt_every == 0:
            save(args.ckpt_dir, rnd + 1, states)

    # hierarchy telemetry: how much traffic stayed in fast memory?  A spill
    # can occur at most once per hierarchy UPDATE, and chunking folds
    # ``chunk`` stream blocks into one update — normalize by updates.
    n_updates_total = ((args.rounds - start_round) * blocks_per_round
                       // sig.chunk)
    spills_l0 = (int(torch.sum(spill_counts[:, 0])) - spills_l0_baseline) \
        if spill_counts is not None else 0
    frac_fast = 1.0 - spills_l0 / max(args.instances * n_updates_total, 1)
    rate = total_updates / wall if wall else 0.0
    out = dict(updates_per_s=rate, total_updates=total_updates,
               wall_s=wall, frac_blocks_layer0=frac_fast,
               n_updates_counter=hier.exact_update_count(states),
               overflow=int(torch.sum(states.overflow)))
    if args.obs:
        obs_metrics.export_stages_gauges()
        obs_trace.emit("metrics", **obs_metrics.REGISTRY.snapshot())
        obs_trace.emit("run_summary", kind="ingest", **out)
    return out, states


def run(args) -> dict:
    return run_with_state(args)[0]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--instances", type=int, default=8)
    ap.add_argument("--blocks", type=int, default=64)
    ap.add_argument("--block-size", type=int, default=4096)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--cuts", default="2048,16384,131072")
    ap.add_argument("--scale", type=int, default=18)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=4)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--layered", action="store_true",
                    help="reference per-layer cascade instead of the fused "
                    "default (A/B oracle)")
    ap.add_argument("--lazy-l0", dest="lazy_l0",
                    choices=("auto", "on", "off"), default="auto",
                    help="layer-0 append buffer; auto = follow the fused "
                    "default")
    ap.add_argument("--chunk", type=int, default=1,
                    help="stream blocks pre-combined per hierarchy update "
                    "(fused only; must divide blocks/rounds)")
    ap.add_argument("--use-kernel", dest="use_kernel", action="store_true",
                    help="hand-written CUDA merge kernels (their plain "
                    "PyTorch versions on the CPU)")
    ap.add_argument("--batch-mode", dest="batch_mode",
                    choices=stages.BATCH_MODES, default="grouped",
                    help="instance-batched execution strategy: grouped = "
                    "plan all depths, execute per depth cohort so one deep "
                    "instance pays only its own merge (production default); "
                    "bucketed = every merge sized to the step's deepest; "
                    "branchfree / switch = each instance on its own")
    ap.add_argument("--stages-cache", dest="stages_cache", default="",
                    help="persistent compile-cache directory "
                    "(repro.stages.set_cache_dir)")
    ap.add_argument("--precompile", action="store_true",
                    help="compile the whole dispatch set up front "
                    "(stages.precompile_fleet) before streaming")
    ap.add_argument("--obs", action="store_true",
                    help="emit obs.jsonl observability events (per-round "
                    "fleet samples and spans, the run summary); aggregate "
                    "with python -m repro_torch.launch.monitor")
    ap.add_argument("--obs-dir", dest="obs_dir", default="",
                    help="observability output directory (default 'obs' "
                    "or REPRO_OBS_DIR)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the fleet (default cuda; the run "
                    "fails when it is absent)")
    return ap


def main():
    out = run(parser().parse_args())
    print(f"sustained {out['updates_per_s']:,.0f} updates/s over "
          f"{out['total_updates']:,} updates "
          f"({out['wall_s']:.1f}s); counter={out['n_updates_counter']:,} "
          f"overflow={out['overflow']}")


if __name__ == "__main__":
    main()
