"""Device time of the hier_merge kernels on the card: device µs and
kernels per call, and the host's own µs per call.

    python src/repro_torch/launch/profile_merge.py

measures the ``repro_torch`` of the checkout this file is in (its ``src/``
goes first on the import path), so a copy of the file placed at the same
path in another checkout measures that checkout's kernels.  At each shape
it prints one JSON line:

- ``device_us`` and ``kernels_per_call``: ``torch.profiler`` over 20
  calls, the summed device time of every kernel (and memset) per call and
  their count per call, with each kernel's name and count per call;
- ``host_us``: the host's clock around 200 back-to-back calls, read before
  the device is waited for (the wrapper, its allocations and its launches).

The wrapper shapes are power-of-two totals, which every version of the
kernels takes; the ``ops`` shapes are the main path's unpadded operands
through ``ops.merge_multi`` / ``ops.merge``, which pad as they need.
Host-paced milliseconds come from ``chip_smoke.py`` phase 3, which also
calls ``merge_profile``.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

CALLS = 20


def merge_profile(torch, fn, calls: int = CALLS) -> dict:
    """Device µs and device operations per call of ``fn`` under
    ``torch.profiler``, after one warm call.  The tracer can drop events
    (seen on the card: 21 kernels recorded for 20 calls of two), never
    invent them, so of two sessions the one that recorded more is kept."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and getattr(e, "device_time_total", 0) > 0]
        if best is None or sum(e.count for e in events) > \
                sum(e.count for e in best):
            best = events
    return dict(
        device_us=sum(e.device_time_total for e in best) / calls,
        kernels_per_call=sum(e.count for e in best) / calls,
        kernels={e.key[:80]: e.count / calls for e in best})


def host_us(torch, fn, calls: int = 200) -> float:
    """Host µs per call of ``fn``: its clock around ``calls`` back-to-back
    calls, stopped before the device is waited for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / calls * 1e6


def cases(torch, hm, hm_ops, registry, seed: int = 7):
    """(label, fn) at the measured shapes, operands drawn from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def cuda(x):
        return torch.as_tensor(np.ascontiguousarray(x), device="cuda")

    def block(n, nkeys=1 << 14):
        return (cuda(rng.integers(0, nkeys, n).astype(np.int32)),
                cuda(rng.integers(-nkeys, nkeys, n).astype(np.int32)),
                cuda(rng.normal(size=n).astype(np.float32)))

    def canon(cap, nkeys=1 << 14):
        return tuple(cuda(x) for x in registry._canonical_segment(
            rng, cap, nkeys, np.float32, "plus.times"))

    b4, r28 = block(4096), canon(28672)
    pa, pb = canon(19456), canon(13312)
    b3, r16 = block(3072), canon(16384)
    qa, qb = canon(19000), canon(13000)
    return [
        ("kernel merge_multi k1 4096+28672",
         lambda: hm.merge_multi_cuda(b4, [r28])),
        ("kernel merge pair 19456+13312",
         lambda: hm.merge_cuda(*pa, *pb)),
        ("ops.merge_multi k1 3072+16384 out 16384",
         lambda: hm_ops.merge_multi(*b3, *r16, out_capacity=16384)),
        ("ops.merge pair 19000+13000 out 32768",
         lambda: hm_ops.merge(*qa, *qb, out_capacity=32768)),
    ]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_merge: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from repro_torch.kernels import build, registry
    from repro_torch.kernels.hier_merge import hier_merge as hm
    from repro_torch.kernels.hier_merge import ops as hm_ops
    build.build_all()
    for label, fn in cases(torch, hm, hm_ops, registry):
        print(json.dumps(dict(shape=label, host_us=host_us(torch, fn),
                              **merge_profile(torch, fn))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
