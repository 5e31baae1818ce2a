"""Dry-run cell builders: (arch x input-shape x mesh) -> ``stages.Lowered``
— the port of ``repro/launch/cells.py``.

Every builder returns ``(lowered, meta)``.  ``meta`` carries what the
roofline needs — token / update counts and MODEL_FLOPS estimates — with
the reference's keys and values.  ``lowered`` is a ``stages.Lowered``
keeping the arguments it was lowered with; its ``compile()`` gives the
``Compiled`` whose ``cost_analysis()`` / ``memory_analysis()`` /
``as_text()`` read one recorded call of it, counted for one rank
(``analysis/tracekit.py``).

**An LM cell** is the reference's: the parameters drawn on ``meta`` (no
allocation) and placed on the mesh by ``make_policy``,
``lm_param_specs`` / ``to_shardings`` and ``sharding.place``; AdamW's
moments, the batch (over the policy's batch axes) and the KV cache
(``lm_cache_spec``) placed likewise; the train step, ``prefill`` or
``decode_step`` wrapped by ``stages.wrap`` under ``use_policy`` (the
wrapped function enters the policy itself, since the port records the
call later, at ``compile()``).  On the production meshes (a fake process
group, ``launch/mesh.py``) everything stays on ``meta``; a caller that
names a device (``device="cuda"`` on a ``(1, 1)`` mesh) gets real
tensors — seeded random weights, Zipf tokens — whose call it can also
time, and may cut the shape's batch and sequence (``batch``, ``seq``).
``long_500k`` is a documented skip (``SkipCell``), as in the reference.

**A D4M cell** cannot be recorded on ``meta`` (a ``meta`` cell lowers,
for its ``meta`` dict, and nothing more): ingest reads its depth plan on
the host (``core/stream.py``).  The fleet shares nothing between ranks, so one
rank's share IS the cell: its ``instances_per_device`` instances, on real
tensors (on the card unless the caller names another device,
``resolve_device``), through the port's
``distributed.sharded_ingest_fn`` with the reference's ``scaled_cuts``,
``effective_chunk`` and knobs, on an R-MAT stream drawn from ``seed``.
``meta["n_instances"]`` and ``meta["updates"]`` are the reference's
global counts.  The query cell is ``global_degree_histogram_fn``'s one
``all_reduce`` on fresh instances, as the reference lowers it.  The mesh
is a ``DeviceMesh`` (its every axis is a data axis) or a
``launch.mesh.FleetMesh``.

**A GNN or recsys cell** is the reference's too, under the ``"dp"``
layout (no TP dim: the batch — nodes and edges, or examples — over every
mesh axis): the parameters placed by ``gnn_param_specs`` /
``recsys_param_specs``, AdamW's moments under their parameters'
placements (``adamw_init`` of the placed tree: the reference's
``_opt_shardings``; the count a plain 0-d tensor, as ``adamw_update``
takes it), the batch by ``_bsh`` (dim 0 over the batch axes where they
divide it), the GNN train step (``cells.gnn_train``) or
DCN-v2's train, serve or retrieval step (``cells.recsys_train``,
``cells.recsys_serve``, ``cells.recsys_retrieval``; the candidates over
every axis, the batch-1 query whole) wrapped as an LM cell's is.  On
``meta`` unless the caller names a device; then the graphs are seeded
``data/graphs`` builders at the shape's real counts, padded to
``_pad256`` (zero-feature nodes; extra edges from and to the first
padding node, so no real node receives their messages), and the recsys
batches ``data/synthetic.recsys_batch``.  The steps run sharded through
``sharding.gather_rows`` / ``scatter_rows`` (GNN) and the vocab-parallel
``sharding.lookup_rows`` (DCN-v2: the table is never gathered).  The
reference's ``hier`` variant cannot be reached (``apply_variant(cfg,
"hier")`` raises ``ValueError``, as the reference's does), so its branch
is not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch import resolve_device, stages
from repro_torch.configs import (D4M_SHAPES, GNN_SHAPES, LM_SHAPES,
                                 RECSYS_SHAPES, family, get_config)
from repro_torch.distribution import sharding as sh
from repro_torch.distribution.sharding import (gnn_param_specs,
                                               lm_param_specs, make_policy,
                                               recsys_param_specs,
                                               to_shardings, use_policy)

I32 = torch.int32
F32 = torch.float32


class SkipCell(Exception):
    """Cell documented as skipped (e.g. long_500k on full attention)."""


def sds(shape, dtype):
    """The counterpart of ``jax.ShapeDtypeStruct``: a ``meta`` tensor of
    ``shape`` and ``dtype`` (no memory)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` or of a ``FleetMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(n) for n in mesh.shape)))
    return {mesh.axis_names[0]: int(mesh.size)}


def _cell_sig(arch: str, shape: str, mesh, variant: str
              ) -> stages.Signature:
    """Signature for one dry-run cell: (arch, shape, variant) plus the mesh
    layout distinguish every lowered program."""
    return stages.signature_of(
        mesh=mesh, extra=(("arch", arch), ("shape", shape),
                          ("variant", variant)))


def _replicated(mesh) -> sh.Sharding:
    return sh.Sharding(mesh, (sh.Replicate(),) * mesh.ndim)


def _bsh(mesh, bax, arr) -> sh.Sharding:
    """Batch sharding on dim 0 when divisible, else replicated."""
    sizes = mesh_shape(mesh)
    if arr.shape[0] % math.prod(sizes[a] for a in bax) == 0:
        return to_shardings(sh.Spec(tuple(bax), *([None] * (arr.dim() - 1))),
                            mesh)
    return _replicated(mesh)


def _placed_tree(params, specs, mesh):
    """``params`` (a ``ParamTree``) with every leaf placed under its
    spec."""
    from repro_torch.models import common
    return common.with_leaves(params, common.tree_map(
        sh.place, params, to_shardings(specs, mesh)))


def _wrap(fn, entry: str, sig, policy, mesh, **kw):
    """``stages.wrap`` of ``fn`` run under ``policy`` wherever it is
    called (the recorded call comes later, at ``compile()``)."""
    with use_policy(policy):
        return stages.wrap(sh.under_current_policy(fn), entry, sig,
                           static=(("mesh", mesh),), **kw)


# ------------------------------------------------------------------- LM -----

def _lm_cell(arch: str, shape: str, mesh, variant: str, device, batch,
             seq, seed) -> Tuple[Any, Dict]:
    from repro_torch.data import pipeline
    from repro_torch.data.synthetic import token_batch
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    cfg = get_config(arch)
    if variant != "baseline":
        cfg = apply_variant(cfg, variant)
    info = LM_SHAPES[shape]
    if info.get("requires_subquadratic"):
        raise SkipCell(
            f"{arch} is full softmax attention (quadratic prefill); "
            f"long_500k requires sub-quadratic attention — documented skip "
            f"(DESIGN.md §Arch-applicability)")
    dev = torch.device(device or "meta")
    policy = make_policy(mesh, cfg.layout)
    B, S = batch or info["batch"], seq or info["seq"]
    sizes = mesh_shape(mesh)
    n_tokens = B * S

    meta = dict(arch=arch, shape=shape, family="lm", kind=info["kind"],
                n_params=cfg.n_params, n_active=cfg.n_active_params,
                tokens=n_tokens, dtype=cfg.dtype, variant=variant)
    sig = _cell_sig(arch, shape, mesh, variant)
    bsh = pipeline.batch_sharding(mesh, policy.batch_axes)

    def tokens(shape_):
        if dev.type == "meta":
            t = sds(shape_, I32)
            return dict(tokens=t, labels=t)
        return token_batch(seed, shape_[0], shape_[1], cfg.vocab, device=dev)

    def params_for(c):
        p = tf.init(seed, c, device=dev)
        return _placed_tree(p, lm_param_specs(p, c, policy), mesh)

    if info["kind"] == "train":
        params = params_for(cfg)
        opt = adamw_init(params)
        batch_ = {k: sh.place(v, bsh) for k, v in tokens((B, S)).items()}
        step = tf.make_train_step(cfg, AdamWConfig())
        lowered = _wrap(step, "cells.lm_train", sig, policy, mesh,
                        donate_argnums=(0, 1)).lower(params, opt, batch_)
        meta["model_flops"] = 6.0 * cfg.n_active_params * n_tokens
    elif info["kind"] == "prefill":
        bax_size = math.prod(sizes[a] for a in policy.batch_axes)
        if cfg.prefill_microbatch:
            eff_mb = min(B, max(cfg.prefill_microbatch, bax_size))
            cfg = dataclasses.replace(cfg, prefill_microbatch=eff_mb)
        params = params_for(cfg)
        toks = sh.place(tokens((B, S))["tokens"], bsh)

        def run(params, tokens, cfg=cfg):
            return tf.prefill(params, tokens, cfg)

        lowered = _wrap(run, "cells.lm_prefill", sig, policy,
                        mesh).lower(params, toks)
        meta["model_flops"] = 2.0 * cfg.n_active_params * n_tokens
    elif info["kind"] == "decode":
        params = params_for(cfg)
        cache_sh = lm_cache_spec(cfg, mesh, policy, S)
        cache = {k: sh.place(v, cache_sh[k])
                 for k, v in tf.init_cache(cfg, B, S, device=dev).items()}
        tok = sh.place(tokens((B, 1))["tokens"], bsh)
        cache_len = sh.place(torch.zeros((), dtype=I32, device=dev),
                             _replicated(mesh))

        def run(params, token, cache, cache_len, cfg=cfg):
            return tf.decode_step(params, token, cache, cache_len, cfg)

        lowered = _wrap(run, "cells.lm_decode", sig, policy, mesh,
                        donate_argnums=(2,)).lower(params, tok, cache,
                                                   cache_len)
        meta["model_flops"] = 2.0 * cfg.n_active_params * B \
            + 2.0 * _kv_read_flops(cfg, B, S)
        meta["tokens"] = B
    else:
        raise ValueError(info["kind"])
    return lowered, meta


def lm_cache_spec(cfg, mesh, policy, S: int) -> dict:
    """KV-cache shardings [L, B, ...]: batch always; model axis on the
    kv-head dim when divisible, else on the sequence dim
    (``transformer.cache_axes``)."""
    from repro_torch.models import transformer as tf
    return {k: to_shardings(policy.spec(*axes), mesh)
            for k, axes in tf.cache_axes(cfg, policy, S).items()}


def _kv_read_flops(cfg, B, S):
    """Attention score+value FLOPs against an S-deep cache (per new token)."""
    if cfg.attn == "mla":
        per_tok = cfg.n_heads * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
    else:
        per_tok = cfg.n_heads * cfg.d_head * 2
    return cfg.n_layers * B * S * per_tok


# ------------------------------------------------------------------ GNN -----

def _pad256(n: int) -> int:
    """Pad node/edge/candidate counts to 2048 so these dims shard evenly
    over every production mesh (up to all 512 devices).  Real pipelines pad
    identically: extra nodes carry zero features, extra edges run from and
    to the first padding node (``_gnn_batch``)."""
    return -(-n // 2048) * 2048


def _pad_rows(x: torch.Tensor, n: int, fill) -> torch.Tensor:
    extra = torch.full((n - x.shape[0],) + tuple(x.shape[1:]), fill,
                       dtype=x.dtype, device=x.device)
    return torch.cat([x, extra])


def _gnn_batch(cfg, info, n_out, dev, seed):
    """(batch, seed_count) of a GNN shape: on ``meta`` the reference's
    abstract batch (``_gnn_batch_abs``); on a device a seeded graph at the
    shape's real counts, a ``full`` one padded to ``_pad256``."""
    from repro_torch import generator
    from repro_torch.data import graphs
    kind = info["kind"]
    if kind == "full":
        n_real, e_real = info["n_nodes"], info["n_edges"]
        n, e = _pad256(n_real), _pad256(e_real)
        if e > e_real and n == n_real:
            raise ValueError(f"{n_real} nodes need no padding: no padding "
                             f"node takes the {e - e_real} padding edges")
    elif kind == "sampled":
        n, e = graphs.flow_sizes(info["batch_nodes"], info["fanouts"])
        n_real, e_real = n, e
    elif kind == "batched":
        g, nn, ee = info["batch"], info["n_nodes"], info["n_edges"]
        n, e = g * nn, g * ee
    else:
        raise ValueError(kind)
    d_feat = info["d_feat"]
    n_labels = info["batch"] if kind == "batched" else n
    if dev.type == "meta":
        batch = dict(node_feat=sds((n, d_feat), F32), edge_src=sds((e,), I32),
                     edge_dst=sds((e,), I32))
        if kind == "batched":
            batch["graph_ids"] = sds((n,), I32)
        labels, targets = sds((n_labels,), I32), sds((n, n_out), F32)
    else:
        if kind == "batched":
            batch = graphs.batched_molecules(seed, g, nn, ee, d_feat,
                                             info["n_classes"], device=dev)
        else:
            batch = graphs.random_graph(seed, n_real, e_real, d_feat,
                                        info["n_classes"], device=dev)
            batch = dict(node_feat=_pad_rows(batch["node_feat"], n, 0.0),
                         edge_src=_pad_rows(batch["edge_src"], e, n_real),
                         edge_dst=_pad_rows(batch["edge_dst"], e, n_real),
                         labels=_pad_rows(batch["labels"], n, 0))
        labels = batch.pop("labels")
        targets = torch.randn((n, n_out), generator=generator(seed + 1, dev),
                              device=dev)
    if cfg.kind == "graphcast":
        batch["targets"] = targets
    else:
        batch["labels"] = labels
    return batch, (info["batch_nodes"] if kind == "sampled" else 0)


def _gnn_cell(arch: str, shape: str, mesh, variant: str, device, seed
              ) -> Tuple[Any, Dict]:
    from repro_torch.models import gnn
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    cfg = get_config(arch)
    if variant != "baseline":
        cfg = apply_variant(cfg, variant)
    info = GNN_SHAPES[shape]
    dev = torch.device(device or "meta")
    # GNNs have no TP dim: folding the model axis into data parallelism
    # shards nodes/edges over ALL devices
    policy = make_policy(mesh, "dp")
    n_out = cfg.n_vars if cfg.kind == "graphcast" else info["n_classes"]
    task = gnn.task_for_shape(info["kind"], cfg.kind)
    batch, seed_count = _gnn_batch(cfg, info, n_out, dev, seed)

    params = gnn.init(seed, cfg, info["d_feat"], n_out, device=dev)
    params = _placed_tree(params, gnn_param_specs(params, cfg, policy), mesh)
    opt = adamw_init(params)
    bax = policy.batch_axes
    batch = {k: sh.place(v, _bsh(mesh, bax, v)) for k, v in batch.items()}
    step = gnn.make_train_step(cfg, AdamWConfig(), task, seed_count)
    lowered = _wrap(step, "cells.gnn_train",
                    _cell_sig(arch, shape, mesh, variant), policy, mesh,
                    donate_argnums=(0, 1)).lower(params, opt, batch)

    e = batch["edge_src"].shape[0]
    n = batch["node_feat"].shape[0]
    d = cfg.d_hidden
    # message-passing model flops: per edge gather+reduce (2d) + per node
    # transforms (6*d^2 per node per layer as the GEMM core), x3 for
    # fwd+bwd
    meta = dict(arch=arch, shape=shape, family="gnn", kind=info["kind"],
                n_nodes=n, n_edges=e, variant=variant,
                model_flops=3.0 * cfg.n_layers * (2.0 * e * d
                                                  + 6.0 * n * d * d),
                tokens=n, dtype=cfg.dtype)
    return lowered, meta


# --------------------------------------------------------------- recsys -----

def _recsys_cell(arch: str, shape: str, mesh, variant: str, device, seed
                 ) -> Tuple[Any, Dict]:
    from repro_torch.data.synthetic import recsys_batch, retrieval_batch
    from repro_torch.models import dcn
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    cfg = get_config(arch)
    if variant != "baseline":
        cfg = apply_variant(cfg, variant)
    info = RECSYS_SHAPES[shape]
    dev = torch.device(device or "meta")
    policy = make_policy(mesh, "dp")   # no TP dim; batch over every axis
    B = info["batch"]
    bax = policy.batch_axes
    sig = _cell_sig(arch, shape, mesh, variant)

    params = dcn.init(seed, cfg, device=dev)
    params = _placed_tree(params, recsys_param_specs(params, cfg, policy),
                          mesh)
    if dev.type == "meta":
        batch = dict(dense=sds((B, cfg.n_dense), F32),
                     sparse=sds((B, cfg.n_sparse), I32),
                     labels=sds((B,), F32))
    else:
        batch = recsys_batch(seed, B, cfg.n_dense, cfg.n_sparse,
                             multi_hot=cfg.multi_hot, device=dev)

    d0 = cfg.d_interact
    mlp_flops = sum(a * b for a, b in zip((d0,) + cfg.mlp, cfg.mlp))
    fwd_flops_per_ex = 2.0 * (cfg.n_cross_layers * d0 * d0 + mlp_flops)
    meta = dict(arch=arch, shape=shape, family="recsys", kind=info["kind"],
                rows=cfg.total_rows, tokens=B, dtype=cfg.dtype,
                variant=variant)

    if info["kind"] == "train":
        batch = {k: sh.place(v, _bsh(mesh, bax, v)) for k, v in batch.items()}
        opt = adamw_init(params)
        step = dcn.make_train_step(cfg, AdamWConfig())
        lowered = _wrap(step, "cells.recsys_train", sig, policy, mesh,
                        donate_argnums=(0, 1)).lower(params, opt, batch)
        meta["model_flops"] = 3.0 * B * fwd_flops_per_ex
    elif info["kind"] == "serve":
        batch = {k: sh.place(batch[k], _bsh(mesh, bax, batch[k]))
                 for k in ("dense", "sparse")}

        def run(params, batch, cfg=cfg):
            return dcn.serve_scores(params, batch, cfg)

        lowered = _wrap(run, "cells.recsys_serve", sig, policy,
                        mesh).lower(params, batch)
        meta["model_flops"] = B * fwd_flops_per_ex
    elif info["kind"] == "retrieval":
        nc = _pad256(info["n_candidates"])
        if dev.type == "meta":
            cands = sds((nc, cfg.mlp[-1]), F32)
        else:
            cands = retrieval_batch(seed, B, nc, cfg.mlp[-1],
                                    device=dev)["candidates"]
        cands = sh.place(cands, to_shardings(
            sh.Spec(tuple(mesh.mesh_dim_names), None), mesh))
        # a batch-1 query cannot shard: the query side whole on every rank
        batch = {k: sh.place(batch[k], _replicated(mesh))
                 for k in ("dense", "sparse")}

        def run(params, batch, cands, cfg=cfg):
            return dcn.retrieval_topk(params, batch, cands, cfg, k=100)

        lowered = _wrap(run, "cells.recsys_retrieval", sig, policy,
                        mesh).lower(params, batch, cands)
        meta["model_flops"] = B * fwd_flops_per_ex \
            + 2.0 * B * nc * cfg.mlp[-1]
    else:
        raise ValueError(info["kind"])
    return lowered, meta


def scaled_cuts(cuts, block: int, growth: int = 8):
    """Cut schedule adapted to the block size (paper: cuts are tunable).
    Keeps cuts strictly increasing when the configured cuts are smaller
    than the update block."""
    out = []
    for i, c in enumerate(cuts):
        lo = 2 * block * (growth ** i)
        c = max(c, lo)
        if out and c <= out[-1]:
            c = out[-1] * growth
        out.append(c)
    return tuple(out)


# ------------------------------------------------------------------ D4M -----

def _d4m_cell(arch: str, shape: str, mesh, variant: str, device, seed
              ) -> Tuple[Any, Dict]:
    from repro_torch.core import distributed
    from repro_torch.data import powerlaw
    from repro_torch.launch.ingest import round_generator

    dev = resolve_device(device)
    cfg = get_config(arch)
    if variant != "baseline":
        cfg = apply_variant(cfg, variant)
    info = D4M_SHAPES[shape]
    sizes = mesh_shape(mesh)
    axes = tuple(sizes)
    n_inst = math.prod(sizes.values()) * cfg.instances_per_device
    n_local = cfg.instances_per_device        # one rank's share
    dtype = getattr(torch, cfg.dtype)

    if info["kind"] == "ingest":
        block = info["block_size"]
        blocks = info["blocks"]
        cuts = scaled_cuts(cfg.cuts, block)
        chunk = cfg.effective_chunk(blocks)
        states = distributed.create_instances(n_local, cuts, block, dtype,
                                              device=dev)
        if dev.type == "meta":          # lowered only: meta carries no data
            rows = cols = vals = sds((n_local, blocks, block), I32)
        else:
            rows, cols, vals = powerlaw.instance_streams(
                round_generator(seed, 0, dev), n_local, blocks, block,
                cfg.rmat_scale)
        fn = distributed.sharded_ingest_fn(
            mesh, axes, lazy_l0=cfg.lazy_l0, use_kernel=cfg.use_kernel,
            fused=cfg.fused, chunk=chunk, batch_mode=cfg.batch_mode)
        lowered = fn.lower(states, rows, cols, vals.to(dtype),
                           keep_args=True)
        updates = n_inst * blocks * block
        c0 = cuts[0] + block
        meta = dict(arch=arch, shape=shape, family="d4m", kind="ingest",
                    n_instances=n_inst, updates=updates, tokens=updates,
                    model_flops=float(updates) * (math.log2(c0) ** 2),
                    dtype=cfg.dtype, variant=variant,
                    fused=cfg.fused, lazy_l0=cfg.lazy_l0,
                    use_kernel=cfg.use_kernel, chunk=chunk,
                    batch_mode=cfg.batch_mode)
        return lowered, meta
    if info["kind"] == "query":
        states = distributed.create_instances(
            n_local, cfg.cuts, cfg.block_size, dtype, device=dev)
        num_rows = 1 << cfg.rmat_scale
        fn = distributed.global_degree_histogram_fn(
            mesh, axes, num_rows=num_rows, num_bins=32)
        lowered = fn.lower(states, keep_args=True)
        meta = dict(arch=arch, shape=shape, family="d4m", kind="query",
                    n_instances=n_inst, tokens=n_inst,
                    model_flops=float(n_inst) * num_rows,
                    dtype=cfg.dtype, variant=variant)
        return lowered, meta
    raise ValueError(info["kind"])


# ------------------------------------------------------------- dispatcher ---

def apply_variant(cfg, variant: str):
    """Named config tweaks (``"k=v,k2=v2"``; a tuple as ``"a+b"``)."""
    import dataclasses as dc
    if variant == "baseline":
        return cfg
    for kv in variant.split(","):
        k, v = kv.split("=")
        field_type = type(getattr(cfg, k))
        if field_type is bool:
            v = v in ("1", "true", "True")
        elif field_type is tuple:
            v = tuple(int(x) for x in v.split("+"))
        else:
            v = field_type(v)
        cfg = dc.replace(cfg, **{k: v})
    return cfg


def lower_cell(arch: str, shape: str, mesh, variant: str = "baseline", *,
               device=None, batch: int = 0, seq: int = 0,
               seed: int = 0) -> Tuple[Any, Dict]:
    """``(lowered, meta)`` of one cell on ``mesh`` (a ``DeviceMesh`` over
    the process group; a D4M cell also takes a ``FleetMesh``).  ``device``
    defaults to ``meta`` for an LM, GNN or recsys cell and to the card for
    a D4M cell (``resolve_device``: it raises without one); an LM cell's
    ``batch`` / ``seq`` (0: the shape's) cut a run that executes."""
    fam = family(arch)
    shapes = dict(lm=LM_SHAPES, gnn=GNN_SHAPES, recsys=RECSYS_SHAPES,
                  d4m=D4M_SHAPES)[fam]
    if shape not in shapes:
        raise ValueError(f"{shape!r} is not a {fam} shape "
                         f"({sorted(shapes)})")
    if fam == "lm":
        return _lm_cell(arch, shape, mesh, variant, device, batch, seq, seed)
    if fam == "d4m":
        return _d4m_cell(arch, shape, mesh, variant, device, seed)
    build = _gnn_cell if fam == "gnn" else _recsys_cell
    return build(arch, shape, mesh, variant, device, seed)


def all_cells():
    """The assigned 40 cells (incl. documented skips) + d4m extras."""
    from repro_torch.configs import list_archs
    cells = []
    for arch in list_archs("lm"):
        for shape in LM_SHAPES:
            cells.append((arch, shape))
    for arch in list_archs("gnn"):
        for shape in GNN_SHAPES:
            cells.append((arch, shape))
    for arch in list_archs("recsys"):
        for shape in RECSYS_SHAPES:
            cells.append((arch, shape))
    for shape in D4M_SHAPES:
        cells.append(("d4m-stream", shape))
    return cells
