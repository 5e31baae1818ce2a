"""Device time of the segment_sum kernels and of ``ops.segment_sum`` on the
card: device µs and kernels per call, and the host's own µs per call.

    python src/repro_torch/launch/profile_segment.py

measures the ``repro_torch`` of the checkout this file is in (its ``src/``
goes first on the import path), so a copy of the file placed at the same
path in another checkout measures that checkout's kernels (with a copy of
``kernels/segment_agg/ref.py`` too where that checkout's lacks
``staged_operands``: its oracle is the same).  At GraphCast's
processor graph (the r = 6 multimesh: E = 327,660, D = 512, N = 40,962)
and GAT-Cora's (``full_graph_sm``: 2,708 nodes, 10,556 R-MAT edges,
D = 64), with random messages, it prints one JSON line per call:

- ``kernel staged``: ``segment_sum_cuda`` on the JAX kernel's staged
  operands (``ref.staged_operands``: sorted messages and ids padded to
  ceil(E/128)*128 + 128 rows, ``searchsorted`` tile starts), which every
  version of the wrapper takes;
- ``ops.segment_sum``: the whole call on the unsorted ids and messages.

The kernel reading the unsorted messages through the sort order is
profiled in ``chip_smoke.py`` phase 3.

Each line has ``device_us`` and ``kernels_per_call`` (``torch.profiler``
over 20 calls: the summed device time of every kernel and memset per call,
their count per call, and each kernel's name and count per call) and
``host_us`` (the host's clock around 200 back-to-back calls, read before
the device is waited for).  Host-paced milliseconds come from
``chip_smoke.py`` phase 3.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path


def cases(torch, sa, sa_ops, sa_ref, graphs, seed: int = 7):
    """(label, fn) at the measured shapes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    cora = graphs.random_graph(6, 2708, 10556, 8, 7, device="cuda")
    shapes = (("graphcast r6", 40962, 512,
               torch.as_tensor(graphs.icosahedral_multimesh(6)[2],
                               device="cuda")),
              ("gat-cora", 2708, 64, cora["edge_dst"]))
    out = []
    for name, n, d, dst in shapes:
        dst = dst.to(torch.int32)
        e = dst.shape[0]
        msg = torch.randn((e, d), generator=gen, device="cuda")
        m_pad, s_pad, starts, t = sa_ref.staged_operands(msg, dst, n)
        label = f"{name} E={e} D={d} N={n}"
        out.append((f"kernel staged {label}",
                    lambda m=m_pad, s=s_pad, st=starts, t=t:
                    sa.segment_sum_cuda(m, s, st, t)))
        out.append((f"ops.segment_sum {label}",
                    lambda m=msg, s=dst, n=n:
                    sa_ops.segment_sum(m, s, num_segments=n)))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_segment: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from repro_torch.data import graphs
    from repro_torch.kernels import build
    from repro_torch.kernels.segment_agg import ops as sa_ops
    from repro_torch.kernels.segment_agg import ref as sa_ref
    from repro_torch.kernels.segment_agg import segment_agg as sa
    from repro_torch.launch.profile_merge import host_us, merge_profile
    build.build_all()
    for label, fn in cases(torch, sa, sa_ops, sa_ref, graphs):
        print(json.dumps(dict(shape=label, host_us=host_us(torch, fn),
                              **merge_profile(torch, fn))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
