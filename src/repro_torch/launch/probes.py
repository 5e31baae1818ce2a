"""Layer and block probes of a dry-run cell — the port of
``repro/launch/probes.py``.

The reference needs them because XLA's cost analysis counts a
``lax.scan`` body once whatever its trip count: it compiles small unrolled
probes and extrapolates linearly.  The port's models loop in Python over
layers (``transformer.forward``) and microbatches (``make_train_step``),
and ingest over its updates, so a recorded call already counts every
layer, microbatch and block.  Here the probes CHECK that recording, with
the reference's probes and formulas:

  LM (train, prefill, decode)  the same cell at L' in {2, 3} layers;
                               total(L) = p3 + (L - 3)(p3 - p2)
  D4M ingest                   T' in {1, 2} updates of ``chunk * block``
                               rows on fresh instances;
                               total(T) = p1 + (T - 1)(p2 - p1)

An LM cell's layers are identical, so each adds the same ops and the same
collectives: the extrapolation equals the full recording exactly in
``flops``, ``bytes`` and ``coll`` (collective bytes;
``tests/test_torch_probes.py``).  Ingest is data-dependent — layer 0
fills and spills only after some updates — so its extrapolation from the
first two updates is not the whole stream's cost (``flops`` and
``bytes`` under-count; ingest has no collective).  ``corrected`` is the
extrapolation; ``dryrun --probes`` keeps it beside the full recording
(``raw``), from which the dry run's roofline always comes.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs import D4M_SHAPES, LM_SHAPES, family, get_config
from repro_torch.launch.cells import (apply_variant, lower_cell, mesh_shape,
                                      scaled_cuts)

METRICS = ("flops", "bytes", "coll")


def extract(compiled) -> Dict[str, float]:
    from repro_torch.roofline.hlo import collective_bytes_by_type
    c = compiled.cost_analysis()
    coll, _ = collective_bytes_by_type(compiled.as_text())
    return dict(flops=float(c.get("flops", 0.0)),
                bytes=float(c.get("bytes accessed", 0.0)),
                coll=float(coll))


def _combine(base: Dict[str, float], delta: Dict[str, float], n: float):
    """``base + n * delta`` for each metric (a negative delta counts 0)."""
    return {m: base[m] + n * max(delta[m], 0.0) for m in METRICS}


def probe_variant(variant: str, **over) -> str:
    """``variant`` with ``over``'s config fields set too."""
    extra = ",".join(f"{k}={v}" for k, v in over.items())
    return extra if variant == "baseline" else f"{variant},{extra}"


def lm_corrected(arch: str, shape: str, mesh, variant: str = "baseline",
                 **cell_kw) -> Dict:
    """The cell at 2 and 3 layers, extrapolated to its config's layers;
    ``cell_kw`` go to ``lower_cell`` (device, batch, seq, seed)."""
    cfg = get_config(arch)
    if variant != "baseline":
        cfg = apply_variant(cfg, variant)
    kind = LM_SHAPES[shape]["kind"]
    probes = {}
    for lp in (2, 3):
        low, _ = lower_cell(arch, shape, mesh,
                            probe_variant(variant, n_layers=lp), **cell_kw)
        probes[f"{kind}_L{lp}"] = extract(low.compile())
    p2, p3 = probes[f"{kind}_L2"], probes[f"{kind}_L3"]
    delta = {m: p3[m] - p2[m] for m in METRICS}
    corrected = _combine(p3, delta, cfg.n_layers - 3)
    return dict(corrected=corrected, probes=probes)


def d4m_corrected(arch: str, shape: str, mesh, variant: str = "baseline",
                  device=None, seed: int = 0) -> Dict:
    """Ingest's first 1 and 2 updates on one rank's fresh instances on
    ``device`` (default the card, as ``cells.lower_cell``), extrapolated
    to the cell's updates; no probe for the query cell."""
    from repro_torch.core import distributed
    from repro_torch.data import powerlaw
    from repro_torch.launch.ingest import round_generator

    dev = resolve_device(device)
    cfg = get_config(arch)
    if variant != "baseline":
        cfg = apply_variant(cfg, variant)
    info = D4M_SHAPES[shape]
    if info["kind"] != "ingest":
        return dict(corrected=None, probes={})
    axes = tuple(mesh_shape(mesh))
    n_local = cfg.instances_per_device
    block, blocks = info["block_size"], info["blocks"]
    cuts = scaled_cuts(cfg.cuts, block)
    chunk = cfg.effective_chunk(blocks)
    n_updates = blocks // chunk
    dtype = getattr(torch, cfg.dtype)
    fn = distributed.sharded_ingest_fn(
        mesh, axes, lazy_l0=cfg.lazy_l0, use_kernel=cfg.use_kernel,
        fused=cfg.fused, chunk=chunk, batch_mode=cfg.batch_mode)
    probes = {}
    for tp in (1, 2):
        states = distributed.create_instances(n_local, cuts, block, dtype,
                                              device=dev)
        rows, cols, vals = powerlaw.instance_streams(
            round_generator(seed, 0, dev), n_local, tp * chunk, block,
            cfg.rmat_scale)
        low = fn.lower(states, rows, cols, vals.to(dtype), keep_args=True)
        probes[f"ingest_T{tp}"] = extract(low.compile())
    p1, p2 = probes["ingest_T1"], probes["ingest_T2"]
    delta = {m: p2[m] - p1[m] for m in METRICS}
    corrected = _combine(p1, delta, n_updates - 1)
    return dict(corrected=corrected, probes=probes)


def corrected_metrics(arch: str, shape: str, mesh,
                      variant: str = "baseline", **cell_kw) -> Dict:
    fam = family(arch)
    if fam == "lm":
        return lm_corrected(arch, shape, mesh, variant, **cell_kw)
    if fam == "d4m":
        return d4m_corrected(arch, shape, mesh, variant,
                             device=cell_kw.get("device"),
                             seed=cell_kw.get("seed", 0))
    return dict(corrected=None, probes={})
