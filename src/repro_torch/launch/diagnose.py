"""Diagnosis of one recorded cell for the perf loop: the biggest tensors
and the collective census — the port of ``repro/launch/diagnose.py``.

    PYTHONPATH=src python -m repro_torch.launch.diagnose \\
        --arch deepseek-v2-236b --shape train_4k --mesh single \\
        [--variant k=v,...] [--probe]

The reference reads post-partitioning HLO; the port reads
``stages.Compiled.as_text()`` of a cell recorded for one rank on the
production mesh (a fake process group, ``launch/dryrun.py``).  It prints
the top-N largest per-device tensors with the op that produces each, the
per-kind collective bytes and the op census.  ``--probe`` records the
cell at 2 layers (``launch/probes.py``'s layer probe) instead of the full
config; ``--audit`` runs the tracekit fleet audit
(``repro_torch.analysis.tracekit --check``).
"""
from __future__ import annotations

import argparse
from collections import Counter, defaultdict

from repro_torch.roofline.hlo import collective_kind, parse_op, shape_bytes


def analyze(text: str, top: int = 20):
    """Print (and return) the biggest per-device tensors of a recorded
    call with the op producing each, the collective census and the op
    census."""
    tensors = []
    coll = defaultdict(lambda: [0, 0])
    opcount = Counter()
    for line in text.splitlines():
        parsed = parse_op(line)
        if parsed is None:
            continue
        ns, op, _, outs = parsed
        opcount[op] += 1
        kind = collective_kind(ns, op)
        for dtype, dims in outs:
            b = shape_bytes(dtype, dims)
            tensors.append((b, f"{dtype}[{dims}]", op))
            if kind is not None:
                coll[kind][0] += b
        if kind is not None:
            coll[kind][1] += 1
    tensors.sort(reverse=True)
    print(f"== top {top} tensors (per-device) ==")
    seen = set()
    shown = []
    for b, shape, op in tensors:
        if (shape, op) in seen:
            continue
        seen.add((shape, op))
        print(f"  {b/2**30:8.3f} GiB  {shape:<32s} {op}")
        shown.append((b, shape, op))
        if len(shown) >= top:
            break
    print("== collectives (per-device result bytes) ==")
    for c, (b, n) in sorted(coll.items()):
        print(f"  {c:<20s} {b/2**30:8.3f} GiB over {n} ops")
    census = dict(opcount.most_common(12))
    print("== op census ==", census)
    return dict(tensors=shown, collectives={k: tuple(v) for k, v in
                                            coll.items()}, ops=census)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--audit", action="store_true",
                    help="tracekit fleet audit instead of a single-program "
                    "diagnosis: J001-J006 + cost budgets over the whole "
                    "stages dispatch set; no --arch needed")
    ap.add_argument("--audit-config", default="smoke",
                    choices=("smoke", "production"),
                    help="fleet config for --audit (entry set is identical, "
                    "only shapes differ)")
    args = ap.parse_args(argv)

    if args.audit:
        from repro_torch.analysis import tracekit
        raise SystemExit(tracekit.main(["--check",
                                        "--config", args.audit_config]))
    if not args.arch or not args.shape:
        ap.error("--arch and --shape are required unless --audit")

    from repro_torch.launch import dryrun
    from repro_torch.launch.cells import lower_cell
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.probes import probe_variant

    dryrun.start_fake_group(dryrun.world_of(args.mesh))
    mesh = make_production_mesh(multi_pod=(args.mesh == "multi"),
                                device="cpu")
    variant = (probe_variant(args.variant, n_layers=2) if args.probe
               else args.variant)
    lowered, _ = lower_cell(args.arch, args.shape, mesh, variant)
    co = lowered.compile()
    cost = co.cost_analysis()
    if args.probe:
        print("probe L=2 recorded; cost:",
              {k: f"{cost[k]:.3e}" for k in ("flops", "bytes accessed")})
    else:
        print("temp GiB:", co.memory_analysis().temp_size_in_bytes / 2**30)
    analyze(co.as_text(), args.top)


if __name__ == "__main__":
    main()
