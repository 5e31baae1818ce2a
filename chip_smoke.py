#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero; nothing is
caught and passed over):

1. environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions; no CUDA device -> exit 2 with no result;
2. build: every CUDA source of the port, compiled with ``nvcc`` into
   ``build/``;
3. kernels vs plain: both hier_merge kernels against their plain PyTorch
   versions (and the sort-based oracle) on the card, at every registry job
   and at the main path's shapes, all four semirings; keys and nnz exact,
   values exact for integer inputs and within rtol 1e-4 for float inputs
   (the order of float sums differs); per shape, the kernel's, the plain
   version's and the sort route's milliseconds;
4. the main path at the full ``d4m_stream`` geometry: 32 instances, cuts
   (2048, 16384, 131072), block 1024, R-MAT scale 22, fused, lazy layer 0,
   grouped, ``--use-kernel``, 128 blocks in 16 rounds (4,194,304 updates),
   through ``repro_torch.launch.ingest``; then 4096 canon-mode and 32
   scan-mode point lookups per instance against the unflushed hierarchy,
   held against lookups after ``flush``;
5. the same stream with ``use_kernel=False``: every layer, spill, overflow
   and counter equal;
6. the layered oracle (8 instances, 32 blocks, ``--layered --lazy-l0 off
   --use-kernel``), which launches the pairwise kernel: its ``query_all``
   equals the fused run's on the same stream.

It prints the card line, one JSON line with every kernel's numbers, and as
its last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
OPS_PER_S = 67e12              # H100 SXM float32 rate outside the tensor cores
TOL = 1e-4                     # registry merge rtol


def phase(name):
    print(f"\n== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warm: int = 3) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(got, want, exact_vals: bool, what: str) -> float:
    """Keys and nnz exact, values exact or within TOL; returns the largest
    absolute value difference over finite entries."""
    import torch
    for j, name in ((0, "hi"), (1, "lo"), (3, "nnz")):
        if not torch.equal(got[j], want[j]):
            raise AssertionError(f"{what}: {name} differs")
    g, w = got[2].double(), want[2].double()
    fin = torch.isfinite(w)
    if not torch.equal(torch.isfinite(g), fin) or \
            not torch.equal(g[~fin], w[~fin]):
        raise AssertionError(f"{what}: non-finite values differ")
    err = float((g[fin] - w[fin]).abs().max()) if fin.any() else 0.0
    if exact_vals and err != 0.0:
        raise AssertionError(f"{what}: integer values differ by {err}")
    if not torch.allclose(g[fin], w[fin], rtol=TOL, atol=1e-6):
        raise AssertionError(f"{what}: values differ by {err}")
    return err


def merge_bound(sizes, first_sorted: bool, val_bytes: int = 4):
    """Least time for one merge of operands ``sizes`` (entries): each input
    read once and each output written once at the card's memory rate,
    against the sorting network's compare-exchanges (about 4 integer
    operations each) plus the scan and compaction (about 4 per entry) at
    its operation rate.  Returns (ms, "bytes" | "operations")."""
    import math
    n = sum(sizes)
    entry = 8 + val_bytes
    nbytes = n * entry + n * entry + 4
    cx, cum = 0, sizes[0]
    if not first_sorted and cum > 1:
        lg = int(math.log2(cum))
        cx += cum // 2 * lg * (lg + 1) // 2
    for s in sizes[1:]:
        cum += s
        cx += cum // 2 * int(math.log2(cum))
    ops = 4 * cx + 4 * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, registry, hm, assoc, sr_mod):
    """Phase 3; returns per-kernel numbers at the main path's shapes."""
    import numpy as np

    def cuda(x):
        return torch.as_tensor(np.ascontiguousarray(x), device="cuda")

    results = {"hier_merge.merge_multi": {}, "hier_merge.merge": {}}
    for job in registry.jobs():
        args = job.make_inputs(0)
        if job.counter == "hier_merge.merge_multi":
            bh, bl, bv, runs = args
            dev_args = (cuda(bh), cuda(bl), cuda(bv),
                        [tuple(cuda(x) for x in r) for r in runs])
        else:
            dev_args = tuple(cuda(x) for x in args)
        got = job.fn(*dev_args)
        exact = dev_args[2].dtype == torch.int32
        compare(got, job.plain(*dev_args), exact, f"{job.name} vs plain")
        compare(got, job.oracle(*dev_args), exact, f"{job.name} vs oracle")
        torch.cuda.synchronize()
        print(f"{job.name}: kernel == plain == oracle "
              f"(nnz {int(got[3][0])})", flush=True)

    rng = np.random.default_rng(7)

    def block(n, nkeys, dtype):
        h = rng.integers(0, nkeys, n).astype(np.int32)
        lo = rng.integers(-nkeys, nkeys, n).astype(np.int32)   # negative lo
        v = (rng.integers(1, 4, n) if dtype == np.int32
             else rng.normal(size=n)).astype(dtype)
        return cuda(h), cuda(lo), cuda(v)

    def canon(cap, nkeys, dtype, sr_name):
        maker_sr = "max.plus" if sr_name == "max.min" else sr_name
        return tuple(cuda(x) for x in registry._canonical_segment(
            rng, cap, nkeys, dtype, maker_sr))

    # (kernel, label, operands, first_sorted, semiring, dtype)
    cases = []
    for sr_name in ("plus.times", "max.plus", "min.plus", "max.min"):
        cases.append(("hier_merge.merge_multi", f"k1 4096+28672 {sr_name}",
                      [block(4096, 1 << 14, np.float32),
                       canon(28672, 1 << 14, np.float32, sr_name)],
                      False, sr_name, np.float32))
    cases.append(("hier_merge.merge_multi", "k1 4096+28672 int32",
                  [block(4096, 1 << 14, np.int32),
                   canon(28672, 1 << 14, np.int32, "plus.times")],
                  False, "plus.times", np.int32))
    cases.append(("hier_merge.merge_multi", "k0 4096",
                  [block(4096, 1 << 10, np.float32)], False, "plus.times",
                  np.float32))
    cases.append(("hier_merge.merge", "pair 3072+1024",
                  [canon(3072, 1 << 12, np.float32, "plus.times"),
                   canon(1024, 1 << 12, np.float32, "plus.times")],
                  True, "plus.times", np.float32))
    cases.append(("hier_merge.merge", "pair 19456+13312",
                  [canon(19456, 1 << 14, np.float32, "plus.times"),
                   canon(13312, 1 << 14, np.float32, "plus.times")],
                  True, "plus.times", np.float32))

    for kname, label, ops, first_sorted, sr_name, dtype in cases:
        if first_sorted:
            def kern(ops=ops, sr_name=sr_name):
                return hm.merge_cuda(*ops[0], *ops[1], sr_name=sr_name)

            def plain(ops=ops, sr_name=sr_name):
                return hm.merge_plain(*ops[0], *ops[1], sr_name=sr_name)
        else:
            def kern(ops=ops, sr_name=sr_name):
                return hm.merge_multi_cuda(ops[0], ops[1:], sr_name=sr_name)

            def plain(ops=ops, sr_name=sr_name):
                return hm.merge_multi_plain(ops[0], ops[1:], sr_name=sr_name)
        n = sum(o[0].shape[0] for o in ops)
        sr = sr_mod.get(sr_name)

        def sort_route(ops=ops, sr=sr, n=n):
            return assoc._canonicalize(torch.cat([o[0] for o in ops]),
                                       torch.cat([o[1] for o in ops]),
                                       torch.cat([o[2] for o in ops]), n, sr)

        got = kern()
        err = compare(got, plain(), dtype == np.int32, f"{label} vs plain")
        seg, _ = sort_route()
        compare(got, (seg.hi, seg.lo, seg.val, seg.nnz.reshape(1)),
                dtype == np.int32, f"{label} vs sort route")
        ms, plain_ms, sort_ms = time_ms(kern), time_ms(plain, 5, 1), \
            time_ms(sort_route)
        bound_ms, bound_by = merge_bound([o[0].shape[0] for o in ops],
                                         first_sorted)
        print(f"{kname} {label}: N={n} kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sort route {sort_ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms ({bound_by}), max_abs_err {err:.3g}",
              flush=True)
        rec = results[kname]
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err)
        # the row reported for each kernel: its main-path shape
        if label in ("k1 4096+28672 plus.times", "pair 19456+13312"):
            rec.update(shape=label, N=n, ms=ms, plain_ms=plain_ms,
                       sort_route_ms=sort_ms, bound_ms=bound_ms,
                       bound_by=bound_by)
    return results


def ingest_args(**kw):
    from repro_torch.launch import ingest
    args = ingest.parser().parse_args([])
    knobs = dict(instances=32, blocks=128, rounds=16, block_size=1024,
                 cuts="2048,16384,131072", scale=22, seed=0, use_kernel=True,
                 batch_mode="grouped", device="cuda", lazy_l0="auto",
                 layered=False)
    for k, v in {**knobs, **kw}.items():
        setattr(args, k, v)
    return args


def states_equal(a, b, what: str) -> None:
    import numpy as np
    from repro_torch.core import hier
    na, nb = hier.state_to_numpy(a), hier.state_to_numpy(b)
    for k in na:
        if not np.array_equal(np.asarray(na[k]), np.asarray(nb[k])):
            raise AssertionError(f"{what}: {k} differs")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()

    from repro_torch.core import assoc, hier, stream
    from repro_torch.core import semiring as sr_mod
    from repro_torch.kernels import build, registry
    from repro_torch.kernels.hier_merge import hier_merge as hm
    from repro_torch.kernels.hier_merge import ops as hm_ops
    from repro_torch.launch import ingest
    from repro_torch.query import engine

    phase("1 environment")
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}", flush=True)
    print(card, flush=True)

    phase("2 build")
    secs = build.build_all()
    print(f"built {list(registry.AUDITED_FILES)} in {secs:.1f} s", flush=True)
    for src, log in build.LOG.items():
        usage = dict.fromkeys(line.split(":", 1)[-1].strip()
                              for line in log.splitlines()
                              if "registers" in line or "spill" in line)
        for line in usage:
            print(f"  {src}: {line}")

    phase("3 kernels vs plain on the card")
    numbers = kernel_phase(torch, registry, hm, assoc, sr_mod)

    phase("4 main path: d4m_stream geometry, fused, lazy layer 0, grouped, "
          "kernel")
    registry.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out, states = ingest.run_with_state(ingest_args())
    main_launches = registry.launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    spills = states.spills.sum(0).tolist()
    n_steps = 32 * 128
    hist = {"depth0": n_steps - spills[0], "depth1": spills[0] - spills[1],
            "depth2": spills[1]}
    print(json.dumps({k: out[k] for k in out}), flush=True)
    print(f"updates_per_s on the card: {out['updates_per_s']:.1f}; spill "
          f"depth histogram over {n_steps} instance-blocks: {hist}; "
          f"spills per layer {spills}; launches {main_launches}; layer nnz "
          f"{[int(l.nnz.sum()) for l in states.layers]}; peak device "
          f"memory {peak_gib:.3f} GiB", flush=True)
    if out["n_updates_counter"] != 4194304 or out["total_updates"] != 4194304:
        raise AssertionError(f"update counter {out['n_updates_counter']} "
                             f"!= 4194304")
    if out["overflow"] != 0:
        raise AssertionError(f"overflow {out['overflow']} != 0")
    # a depth-d merge takes the kernel iff its padded width fits the ceiling
    # (on d4m_stream: depth 1 -> 32768 does, depth 2 -> 262144 does not)
    caps = states.capacities
    by_route = {"hier_merge.merge_multi": 0, "assoc.sort_route": 0}
    for d in (1, 2):
        width = hm_ops.multi_padded_capacity(1024 + caps[0], caps[1:d + 1])
        by_route["hier_merge.merge_multi"
                 if width <= hm_ops.MAX_KERNEL_CAPACITY
                 else "assoc.sort_route"] += hist[f"depth{d}"]
    for route, want in by_route.items():
        if main_launches[route] != want:
            raise AssertionError(f"{route}: {main_launches[route]} calls, "
                                 f"{want} merges planned for it")
    if main_launches["hier_merge.merge_multi"] == 0:
        raise AssertionError("the main path never launched merge_multi")

    registry.reset_launches()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    n_inst = states.spills.shape[0]
    live = []
    for i in range(n_inst):
        h = stream.instance(states, i)
        # queries: live keys of every layer plus random keys
        n0 = int(h.layers[0].nnz)
        rand = [torch.randint(0, 1 << 22, (4096,), generator=gen,
                              device="cuda", dtype=torch.int32)
                for _ in range(2)]
        qr = torch.cat([h.layers[2].hi[:2048], h.layers[1].hi[:1024],
                        h.layers[0].hi[:min(n0, 512)], rand[0]])[:4096]
        qc = torch.cat([h.layers[2].lo[:2048], h.layers[1].lo[:1024],
                        h.layers[0].lo[:min(n0, 512)], rand[1]])[:4096]
        canon = engine.point_lookup(h, qr, qc, use_kernel=True,
                                    l0_mode="canon")
        scan = engine.point_lookup(h, qr[-32:], qc[-32:], use_kernel=True,
                                   l0_mode="scan")
        live.append((qr, qc, canon, scan))
    query_launches = registry.launches()
    if query_launches["hier_merge.merge_multi"] != n_inst:
        raise AssertionError("canon-mode queries did not launch merge_multi "
                             "once each")
    for i, (qr, qc, canon, scan) in enumerate(live):
        flushed = hier.flush(stream.instance(states, i), lazy_l0=True,
                             use_kernel=True)
        want = engine.point_lookup(flushed, qr, qc, l0_mode="scan")
        if not torch.equal(canon, want) or not torch.equal(scan, want[-32:]):
            raise AssertionError(f"instance {i}: live lookups != lookups "
                                 f"after flush")
    print(f"point lookups: {n_inst} x (4096 canon + 32 scan) == after flush; "
          f"launches of the lookups {query_launches}", flush=True)

    phase("5 kernel route == sort route, end to end")
    out_sort, states_sort = ingest.run_with_state(
        ingest_args(use_kernel=False))
    states_equal(states, states_sort, "kernel vs sort route")
    print(f"all layers, spills, overflow and counters equal; sort route "
          f"updates_per_s {out_sort['updates_per_s']:.1f}", flush=True)

    phase("6 layered oracle (pairwise kernel) == fused")
    small = dict(instances=8, blocks=32, rounds=4)
    registry.reset_launches()
    out_lay, states_lay = ingest.run_with_state(
        ingest_args(layered=True, lazy_l0="off", **small))
    layered_launches = registry.launches()
    _, states_fused = ingest.run_with_state(ingest_args(**small))
    for i in range(8):
        a = hier.query_all(stream.instance(states_lay, i))
        b = hier.query_all(stream.instance(states_fused, i))
        if not all(torch.equal(x, y) for x, y in
                   ((a.hi, b.hi), (a.lo, b.lo), (a.val, b.val),
                    (a.nnz, b.nnz))):
            raise AssertionError(f"instance {i}: layered != fused")
    print(f"layered == fused on 8 instances; layered updates_per_s "
          f"{out_lay['updates_per_s']:.1f}; launches {layered_launches}",
          flush=True)
    if layered_launches["hier_merge.merge"] == 0:
        raise AssertionError("the layered path did not launch merge")

    kernels = []
    for name, replaces, launches in (
            ("hier_merge.merge_multi",
             "src/repro/kernels/hier_merge/hier_merge.py:236",
             main_launches["hier_merge.merge_multi"]),
            ("hier_merge.merge",
             "src/repro/kernels/hier_merge/hier_merge.py:212",
             layered_launches["hier_merge.merge"])):
        rec = numbers[name]
        kernels.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/hier_merge/csrc/hier_merge.cu",
            replaces=replaces, launches=launches,
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=None,
            sort_route_ms=rec["sort_route_ms"], shape=rec["shape"]))
    print(f"\nchip_smoke wall {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
