"""End-to-end run: the paper's §III experiment at container scale — the
port of ``examples/stream_ingest.py``.

    PYTHONPATH=src python -m repro_torch.examples.stream_ingest \\
        [--device cpu] [--use-kernel]

Multiple independent hierarchical D4M instances each ingest their own
power-law (R-MAT) edge stream — "thousands of processors each creating
many different graphs of 100,000,000 edges each" — with zero cross-
instance traffic on the update path.  Reports sustained updates/s,
checkpoint/restart, and a global degree-histogram query (the analytics
side of the paper's pipeline).

The ingest is ``launch/ingest.run`` with the reference's ``Args`` (and
the ingest CLI's defaults for the knobs it leaves out); ``use_kernel`` is
the CLI's ``--use-kernel``, off as in the reference.  The restart resumes
to 6 rounds at the same blocks a round, so the resumed fleet is the one an
uninterrupted 6-round run builds (the reference's sets ``rounds`` alone,
and its resumed rounds take ``32 // 6`` blocks each).  The histogram runs
on a one-rank fleet (``launch/mesh.FleetMesh``): the default process group
when one is initialized, else a one-rank group started here (gloo on the
CPU, nccl on the card, a ``file://`` rendezvous in a temporary directory)
and destroyed before ``main`` returns.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile

import torch

from repro_torch import generator, resolve_device
from repro_torch.core import assoc, distributed, hier, stream
from repro_torch.data.powerlaw import degree_tail_exponent, instance_streams
from repro_torch.launch import ingest
from repro_torch.launch import mesh as mesh_mod


class Args:
    """The reference's arguments of ``launch/ingest.run``."""
    instances = 8
    blocks = 32
    block_size = 4096
    rounds = 4
    cuts = "4096,32768,262144"
    scale = 18
    seed = 0
    ckpt_every = 2
    resume = False
    verbose = True
    ckpt_dir = ""


def ingest_args(**over) -> argparse.Namespace:
    """The ingest CLI's defaults, then ``Args``, then ``over``."""
    args = ingest.parser().parse_args([])
    vars(args).update({k: v for k, v in vars(Args).items()
                       if not k.startswith("_")})
    vars(args).update(over)
    return args


def ingest_and_resume(args, resume_rounds: int = 6) -> tuple:
    """``args``' run, checkpointed into a temporary directory, then the
    same fleet resumed from its last checkpoint and run to
    ``resume_rounds`` rounds at the same blocks a round.  Returns both
    runs' results and the resumed fleet."""
    with tempfile.TemporaryDirectory() as d:
        args.ckpt_dir = os.path.join(d, "ckpt")
        out = ingest.run(args)
        per_round = max(args.blocks // args.rounds, 1)
        args.resume, args.rounds = True, resume_rounds
        args.blocks = per_round * resume_rounds
        out2, states = ingest.run_with_state(args)
    return out, out2, states


@contextlib.contextmanager
def one_rank_fleet(device):
    """A ``FleetMesh``: over the default process group if one is
    initialized, else over a one-rank group started here and destroyed on
    exit (gloo on the CPU, nccl on the card)."""
    import torch.distributed as dist
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        yield mesh_mod.make_fleet_mesh(dist.get_backend(), dev)
        return
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(backend, init_method=f"file://{d}/store",
                                rank=0, world_size=1,
                                timeout=mesh_mod.TIMEOUT)
        try:
            yield mesh_mod.make_fleet_mesh(backend, dev)
        finally:
            dist.destroy_process_group()


def degree_analytics(mesh, rows, cols, vals, *, cuts=(1024, 8192),
                     num_rows: int = 1 << 16, num_bins: int = 16,
                     use_kernel: bool = False) -> tuple:
    """Every instance of the ``[I, T, B]`` streams ingested on the mesh
    rank's device, then the global out-degree histogram over the fleet
    (``log2`` bins, one ``all_reduce``) and the degree-tail exponent of
    instance 0's merged graph.  Returns ``(histogram, exponent)``."""
    n_inst, _, block = rows.shape
    states = distributed.create_instances(n_inst, cuts, block,
                                          device=mesh.device)
    states, _ = stream.ingest_instances(states, rows, cols, vals,
                                        use_kernel=use_kernel)
    hist_fn = distributed.global_degree_histogram_fn(
        mesh, ("data",), num_rows=num_rows, num_bins=num_bins)
    hist = hist_fn(distributed.shard(mesh, states))
    merged = hier.query_all(stream.instance(states, 0),
                            use_kernel=use_kernel)
    deg = assoc.reduce_rows(merged, num_rows)
    return hist, degree_tail_exponent(deg)


def main(device="cuda", *, use_kernel: bool = False, resume_rounds: int = 6,
         hist_instances: int = 4, hist_blocks: int = 16,
         hist_block: int = 512, hist_scale: int = 16, hist_cuts=(1024, 8192),
         num_rows: int = 1 << 16, num_bins: int = 16, **args) -> dict:
    """The run, the restart and the analytics; ``args`` overrides
    ``Args``' fields (the sizes).  Returns what it prints."""
    dev = resolve_device(device)
    a = ingest_args(device=str(dev), use_kernel=use_kernel, **args)
    out, out2, states = ingest_and_resume(a, resume_rounds)
    print(f"\nsustained: {out['updates_per_s']:,.0f} updates/s "
          f"across {a.instances} instances")
    print(f"fraction of blocks that never left layer 0: "
          f"{out['frac_blocks_layer0']:.2%}")
    print(f"updates counted: {out['n_updates_counter']:,} "
          f"(overflow={out['overflow']})")
    nnz = [l.nnz.tolist() for l in states.layers]
    print(f"\nafter restart+continue: counter="
          f"{out2['n_updates_counter']:,}; nnz per layer and instance {nnz}")

    # analytics: global degree histogram over all instances (query path)
    rows, cols, vals = instance_streams(generator(1, dev), hist_instances,
                                        hist_blocks, hist_block,
                                        scale=hist_scale)
    with one_rank_fleet(dev) as mesh:
        hist, tail = degree_analytics(
            mesh, rows, cols, vals, cuts=tuple(hist_cuts),
            num_rows=num_rows, num_bins=num_bins, use_kernel=use_kernel)
    print("\nglobal out-degree histogram (log2 bins):", hist)
    print(f"degree-tail exponent ~ {tail:.2f} (power-law graph confirmed)")
    return dict(device=str(dev), use_kernel=use_kernel,
                updates_per_s=out["updates_per_s"],
                frac_blocks_layer0=out["frac_blocks_layer0"],
                counter=out["n_updates_counter"], overflow=out["overflow"],
                resumed_counter=out2["n_updates_counter"],
                resumed_overflow=out2["overflow"],
                resumed_updates_per_s=out2["updates_per_s"],
                nnz_per_layer=nnz, histogram=hist.tolist(),
                tail_exponent=float(tail))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; the run fails when it "
                    "is absent)")
    ap.add_argument("--use-kernel", dest="use_kernel", action="store_true",
                    help="the hand-written CUDA merge kernels (the ingest "
                    "CLI's --use-kernel)")
    cli = ap.parse_args()
    main(cli.device, use_kernel=cli.use_kernel)
