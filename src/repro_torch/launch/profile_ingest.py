"""Where the main path's time goes on the card: device busy share and the
kernels that fill it.

    PYTHONPATH=src python -m repro_torch.launch.profile_ingest \\
        --instances 32 --blocks 16 --rounds 2 --block-size 1024 \\
        --scale 22 --cuts 2048,16384,131072 --use-kernel

Takes the ingest CLI's arguments (``launch/ingest.py``): the first round
warms up, the second runs under ``torch.profiler`` (CPU and CUDA
activities).  Prints one JSON object: the profiled round's wall seconds,
the summed device time of its kernels, their share of the wall (the rest
is the device idle, waiting on the host), and the ten kernels with the
most device time.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import resolve_device
from repro_torch.core import distributed, stream
from repro_torch.data.powerlaw import instance_streams
from repro_torch.launch import ingest


def main():
    args = ingest.parser().parse_args()
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("profile_ingest measures the card: --device cuda")
    sig = ingest.signature(args)
    knobs = ingest.ingest_knobs(sig)
    states = distributed.create_instances(args.instances, sig.cuts,
                                          args.block_size, device=device)
    blocks = max(args.blocks // args.rounds, 1)
    batches = [instance_streams(ingest.round_generator(args.seed, r, device),
                                args.instances, blocks, args.block_size,
                                args.scale)
               for r in range(2)]
    states, _ = stream.ingest_instances(states, *batches[0], **knobs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        states, _ = stream.ingest_instances(states, *batches[1], **knobs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.device_time_total)[:10]
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(device),
        updates=args.instances * blocks * args.block_size,
        wall_s=wall, device_busy_s=device_us / 1e6,
        device_busy_share=device_us / 1e6 / wall,
        kernels=[dict(name=e.key[:80], calls=e.count,
                      device_ms=e.device_time_total / 1e3) for e in top])))


if __name__ == "__main__":
    main()
