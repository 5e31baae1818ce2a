"""Multi-pod dry run: lower and record every (arch x shape x mesh) cell —
the port of ``repro/launch/dryrun.py``.

For each cell:
    lowered, meta = cells.lower_cell(arch, shape, mesh)   # placed args
    compiled = lowered.compile()        # records one rank's call
    compiled.memory_analysis()          # proves it fits
    compiled.cost_analysis()            # flops / bytes
    parse(compiled.as_text())           # collective bytes

and write ``results/dryrun/<mesh>/<arch>__<shape>[__<variant>].json`` with
the reference's keys: the memory analysis, cost, collectives, the
recording (``raw``), the roofline at the H100's terms
(``roofline/terms.py``; a float32 cell at the float32 rate outside the
tensor cores), the useful fraction and ``fits_hbm`` (arguments plus the
recorded peak within ``HW_H100["hbm_bytes"]``).  The roofline, the useful
fraction and the fit come from the recording, which counts every layer,
microbatch and update block.  ``--probes`` also runs the reference's
layer or block probes (``launch/probes.py``) as a check of it and keeps
their extrapolation under the reference's ``corrected`` / ``probes`` /
``probe_s``; it replaces nothing.  ``flops`` counts every op as XLA's
cost analysis counts the reference's (``analysis/tracekit.py``), and the
useful fraction is ``model_flops / (flops x n_devices)`` for every cell,
as in the reference.  A failing cell records ``status: "error"`` and
makes the exit code 1; a documented skip records ``status: "skip"``.

The production meshes are ``launch/mesh.py``'s ``(16, 16)`` (``single``,
256 ranks) and ``(2, 16, 16)`` (``multi``, 512 ranks), built in one
process over a fake process group (``FakeStore``, backend ``"fake"``) —
the counterpart of the reference's forced host device count.  The group
is process-global, so ``main`` runs each mesh's cells in a child process
of its own (``run_mesh``).  An LM, GNN or recsys cell runs on ``meta``
(shapes, no memory); a D4M cell runs one rank's instances on
``--device``, the card unless the caller names the CPU (a rehearsal).
Here ``compile_s`` is the time of the recorded call.

Usage:
    python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --arch graphcast \\
        --shape ogb_products --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both --resume
    python -m repro_torch.launch.dryrun --arch d4m-stream \\
        --shape ingest_small --device cpu --probes
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

from repro_torch.launch.mesh import PRODUCTION_MESHES


def _cost_dict(compiled):
    try:
        c = compiled.cost_analysis()
    except Exception as e:                       # pragma: no cover
        return {"error": str(e)}
    return {k: float(v) for k, v in c.items()
            if isinstance(v, (int, float))}


def _memory_dict(compiled):
    out = {}
    try:
        m = compiled.memory_analysis()
    except Exception as e:                       # pragma: no cover
        return {"error": str(e)}
    for attr in ("argument_size_in_bytes", "output_size_in_bytes",
                 "temp_size_in_bytes", "alias_size_in_bytes",
                 "generated_code_size_in_bytes"):
        v = getattr(m, attr, None)
        if v is not None:
            out[attr] = int(v)
    return out


def hw_for(dtype: str) -> dict:
    """The H100's terms for a program in ``dtype``: the tensor cores'
    peak for 16-bit types, the float32 rate outside them for float32
    (TF32 stays off)."""
    from repro_torch.roofline.terms import H100_F32_FLOPS, HW_H100
    if dtype == "float32":
        return dict(HW_H100, peak_flops=H100_F32_FLOPS)
    return HW_H100


def tag_of(arch: str, shape: str, variant: str) -> str:
    return f"{arch}__{shape}" + ("" if variant == "baseline"
                                 else f"__{variant}")


def world_of(mesh_kind: str) -> int:
    shape, _ = PRODUCTION_MESHES[mesh_kind == "multi"]
    n = 1
    for s in shape:
        n *= s
    return n


def start_fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks in this process (this
    process is rank 0); one of another size raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of "
                               f"{dist.get_world_size()} ranks is up; the "
                               f"mesh needs {world}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def run_cell(arch: str, shape: str, mesh_kind: str, variant: str,
             outdir: str, save_hlo: bool = False, verbose: bool = True,
             device=None, probes: bool = False):
    """One cell on the production mesh ``mesh_kind`` (``"single"`` or
    ``"multi"``), under a fake group of its world size (started here when
    none is up); writes and returns its record.  ``device`` is where a
    D4M cell runs (default the card); ``probes`` adds the probes' check."""
    from repro_torch.configs import family
    from repro_torch.launch.cells import SkipCell, lower_cell
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.probes import corrected_metrics
    from repro_torch.roofline.hlo import collective_bytes_by_type, count_op
    from repro_torch.roofline.terms import (HW_H100, roofline_terms,
                                            useful_fraction)

    start_fake_group(world_of(mesh_kind))
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device="cpu")
    n_dev = mesh.size()
    tag = tag_of(arch, shape, variant)
    os.makedirs(os.path.join(outdir, mesh_kind), exist_ok=True)
    path = os.path.join(outdir, mesh_kind, tag + ".json")

    rec = dict(arch=arch, shape=shape, mesh=mesh_kind, variant=variant,
               n_devices=int(n_dev), status="ok")
    t0 = time.time()
    cell_kw = dict(device=device) if family(arch) == "d4m" else {}
    try:
        lowered, meta = lower_cell(arch, shape, mesh, variant, **cell_kw)
        rec["lower_s"] = round(time.time() - t0, 2)
        t1 = time.time()
        compiled = lowered.compile()
        cost = _cost_dict(compiled)          # the recorded call
        rec["compile_s"] = round(time.time() - t1, 2)

        rec["meta"] = {k: v for k, v in meta.items()
                       if isinstance(v, (int, float, str))}
        mem = _memory_dict(compiled)
        rec["memory_analysis"] = mem
        rec["cost_analysis"] = cost

        text = compiled.as_text()
        coll_total, coll_by_type = collective_bytes_by_type(text)
        rec["collective_bytes_per_device"] = int(coll_total)
        rec["collectives"] = coll_by_type
        rec["hlo_ops"] = dict(fusion=count_op(text, "fusion"),
                              transpose=count_op(text, "transpose"),
                              copy=count_op(text, "copy"))
        if save_hlo:
            import gzip
            with gzip.open(path.replace(".json", ".hlo.gz"), "wt") as f:
                f.write(text)

        flops_dev = cost.get("flops", 0.0)
        bytes_dev = cost.get("bytes accessed", 0.0)
        rec["raw"] = dict(flops=flops_dev, bytes=bytes_dev,
                          coll=float(coll_total))

        if probes:
            # the probes' extrapolation (launch/probes.py): a check of
            # the recording, which already counts every layer and block
            t2 = time.time()
            corr = corrected_metrics(arch, shape, mesh, variant, **cell_kw)
            rec["probe_s"] = round(time.time() - t2, 2)
            if corr["corrected"] is not None:
                rec["corrected"] = corr["corrected"]
                rec["probes"] = corr["probes"]

        terms = roofline_terms(flops_dev, bytes_dev, coll_total,
                               hw=hw_for(meta["dtype"]))
        rec["roofline"] = terms.as_dict()
        model_flops = meta.get("model_flops", 0.0)
        rec["model_flops"] = float(model_flops)
        rec["useful_fraction"] = useful_fraction(model_flops,
                                                 flops_dev * n_dev)
        # per-device HBM residency
        arg_b = mem.get("argument_size_in_bytes", 0)
        tmp_b = mem.get("temp_size_in_bytes", 0)
        out_b = mem.get("output_size_in_bytes", 0)
        rec["fits_hbm"] = bool(arg_b + tmp_b <= HW_H100["hbm_bytes"]) \
            if arg_b else None
        if verbose:
            print(f"[{mesh_kind}] {tag}: lower {rec['lower_s']}s "
                  f"record {rec['compile_s']}s "
                  f"probes {rec.get('probe_s', 0)}s")
            print(f"  memory: args={arg_b/2**30:.2f}GiB "
                  f"temp={tmp_b/2**30:.2f}GiB out={out_b/2**30:.2f}GiB "
                  f"fits_80GB={rec['fits_hbm']}")
            print(f"  cost: flops/dev={flops_dev:.3e} "
                  f"bytes/dev={bytes_dev:.3e} coll/dev={coll_total:.3e}")
            print(f"  roofline: compute={terms.compute_s:.4f}s "
                  f"memory={terms.memory_s:.4f}s "
                  f"collective={terms.collective_s:.4f}s "
                  f"-> {terms.dominant}-bound "
                  f"useful={rec['useful_fraction']}", flush=True)
    except SkipCell as e:
        rec["status"] = "skip"
        rec["reason"] = str(e)
        if verbose:
            print(f"[{mesh_kind}] {tag}: SKIP — {e}", flush=True)
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[{mesh_kind}] {tag}: ERROR — {type(e).__name__}: {e}",
                  flush=True)
    rec["total_s"] = round(time.time() - t0, 2)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def run_mesh(mesh_kind: str, cells, variant: str, outdir: str,
             resume: bool = False, save_hlo: bool = False, device=None,
             probes: bool = False) -> list:
    """Every cell of ``cells`` on one production mesh, in this process
    (which then holds the fake group); returns the records."""
    import torch.distributed as dist
    out = []
    try:
        for arch, shape in cells:
            path = os.path.join(outdir, mesh_kind,
                                tag_of(arch, shape, variant) + ".json")
            if resume and os.path.exists(path):
                with open(path) as f:
                    prev = json.load(f)
                if prev.get("status") in ("ok", "skip"):
                    print(f"[{mesh_kind}] {tag_of(arch, shape, variant)}: "
                          f"cached ({prev['status']})")
                    out.append(prev)
                    continue
            out.append(run_cell(arch, shape, mesh_kind, variant, outdir,
                                save_hlo=save_hlo, device=device,
                                probes=probes))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return out


def _mesh_child(mesh_kind, cells, variant, outdir, resume, save_hlo,
                device, probes):
    recs = run_mesh(mesh_kind, cells, variant, outdir, resume, save_hlo,
                    device, probes)
    sys.exit(1 if any(r["status"] == "error" for r in recs) else 0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="baseline",
                    help='config overrides, e.g. "num_microbatches=8"')
    ap.add_argument("--all", action="store_true",
                    help="run every cell")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose result JSON already exists")
    ap.add_argument("--save-hlo", action="store_true",
                    help="keep the recorded call's text beside the JSON")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--device", default=None,
                    help="where a D4M cell runs (default: the card; "
                         "'cpu' to rehearse); the other cells run on meta")
    ap.add_argument("--probes", action="store_true",
                    help="also run the layer / block probes as a check")
    args = ap.parse_args(argv)

    import multiprocessing

    from repro_torch.launch.cells import all_cells

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("--arch and --shape required unless --all")
    cells = all_cells() if args.all else [(args.arch, args.shape)]

    ctx = multiprocessing.get_context("spawn")
    failures = 0
    for mesh_kind in meshes:
        proc = ctx.Process(target=_mesh_child, args=(
            mesh_kind, cells, args.variant, args.out, args.resume,
            args.save_hlo, args.device, args.probes))
        proc.start()
        proc.join()
        failures += proc.exitcode != 0
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
