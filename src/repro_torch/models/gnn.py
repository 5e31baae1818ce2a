"""GNN zoo: GAT, GIN, GatedGCN, GraphCast-style encoder-processor-decoder,
inference and training on the card — the port of ``repro/models/gnn.py``.
  All message passing is
edge-list based: gather source-node features per edge, transform, then sum
(or max) into destination nodes.  ``cfg.use_kernel`` routes the
destination sum through the ``segment_agg`` CUDA kernels (edges sorted by
destination, read in place through the sort order, one warp per chunk of
64 edges) instead of ``index_add_``.

Graph dict convention (``data/graphs.py`` builders):
    node_feat [N, F]  edge_src [E]  edge_dst [E]  (int32)
    (+ graph_ids [N] for batched small graphs)

The model is a ``GNN`` module whose parameter names are the JAX pytree's
paths (``layers.3.edge_mlp.1.w``, ``head``, ``w_in``); ``forward`` keeps
the JAX name and signature and takes the module where JAX takes
``params``.  The parameters do not require gradients: ``make_train_step``
turns autograd on for their leaves only inside a step
(``common.value_and_grad``) and updates them in place.  With ``cfg.remat``
a differentiated forward checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant) where the reference takes
``jax.checkpoint``: only layer inputs are kept, the layer is recomputed in
the backward.  The ``segment_agg`` kernel has no backward (nor has the
reference's): a step with ``cfg.use_kernel`` raises
``NotImplementedError``.

Tasks: "node" (per-node classification), "graph" (readout
classification), "regress" (per-node regression, GraphCast's
weather-state prediction).

Under a sharding policy (the cells' ``"dp"`` layout: nodes and edges over
every mesh axis) the edge gathers go through ``sharding.gather_rows``,
the destination and readout reductions through ``sharding.scatter_rows``
(each rank reduces its own edges; the partial sums are reduce-scattered),
and the edge state is built sharded as the edges (``full_rows``).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import GNNConfig
from repro_torch.distribution.sharding import (constrain, full_rows,
                                               gather_rows, like,
                                               scatter_rows,
                                               under_current_policy)
from repro_torch.kernels.segment_agg import ops as seg_ops
from repro_torch.models import common
from repro_torch.optim.adamw import AdamWConfig, adamw_update


class GNN(common.ParamTree):
    """The parameters of one GNN kind, with its config."""

    def __init__(self, tree: dict, cfg: GNNConfig):
        super().__init__(tree)
        self.cfg = cfg


# ------------------------------------------------------------- primitives ---

def _scatter_sum_local(x: torch.Tensor, ids: torch.Tensor,
                      n: int) -> torch.Tensor:
    valid = (ids >= 0) & (ids < n)
    ids = torch.where(valid, ids, n).long()
    out = torch.zeros((n + 1,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, ids, x)[:n]


def _scatter_sum(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: x [E, ...] summed by ids into [n, ...];
    ids outside [0, n) are dropped.  Under a policy each rank sums its own
    edges and the partial sums are reduce-scattered
    (``sharding.scatter_rows``)."""
    return scatter_rows(x, ids, n, _scatter_sum_local)


def _segment_sum_kernel(messages: torch.Tensor, seg_ids: torch.Tensor,
                        n: int) -> torch.Tensor:
    return seg_ops.segment_sum(messages, seg_ids,
                               num_segments=n).to(messages.dtype)


def _segment_sum(cfg: GNNConfig, messages: torch.Tensor,
                 seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Destination-node reduction; kernel path or ``index_add_`` path (on
    each rank's own edges under a policy)."""
    if cfg.use_kernel and messages.dim() == 2:
        return scatter_rows(messages, seg_ids, num_segments,
                            _segment_sum_kernel)
    return _scatter_sum(messages, seg_ids, num_segments)


def _segment_max_local(scores: torch.Tensor, dst: torch.Tensor,
                       n_nodes: int) -> torch.Tensor:
    idx = dst.long().reshape((-1,) + (1,) * (scores.dim() - 1))
    out = torch.full((n_nodes,) + tuple(scores.shape[1:]), -torch.inf,
                     dtype=scores.dtype, device=scores.device)
    return out.scatter_reduce(0, idx.expand_as(scores), scores, "amax",
                              include_self=False)


def segment_max(scores: torch.Tensor, dst: torch.Tensor,
                n_nodes: int) -> torch.Tensor:
    """``jax.ops.segment_max``: empty segments keep -inf."""
    return scatter_rows(scores, dst, n_nodes, _segment_max_local, "max")


def segment_softmax(scores: torch.Tensor, dst: torch.Tensor,
                    n_nodes: int) -> torch.Tensor:
    """Edge softmax: normalize scores [E, ...] over edges sharing a dst."""
    dst = dst.long()
    smax = segment_max(scores, dst, n_nodes)
    (smax_e,) = gather_rows(smax, dst)
    ex = torch.exp(scores - smax_e)
    denom = _scatter_sum(ex, dst, n_nodes)
    (denom_e,) = gather_rows(denom, dst)
    return ex / torch.clamp(denom_e, min=1e-16)


def _mlp_spec(dims):
    return [dict(w=("dense", i, o), b=("zeros", (o,)))
            for i, o in zip(dims[:-1], dims[1:])]


def _mlp(layers, x, act=torch.relu):
    for i, l in enumerate(layers):
        x = x @ l.w + l.b
        if i < len(layers) - 1:
            x = act(x)
    return x


def _layer_norm(x, eps=1e-5):
    m = torch.mean(x, dim=-1, keepdim=True)
    v = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    return (x - m) * torch.rsqrt(v + eps)


# -------------------------------------------------------------------- GAT ---

def _gat_layer(p, h, src, dst, n_nodes, n_heads, cfg, concat=True):
    e = src.shape[0]
    hw = (h @ p.w).reshape(n_nodes, n_heads, -1)          # [N, H, D]
    s_src = torch.einsum("nhd,hd->nh", hw, p.a_src)       # [N, H]
    s_dst = torch.einsum("nhd,hd->nh", hw, p.a_dst)
    (s_src_e,) = gather_rows(s_src, src)
    (s_dst_e,) = gather_rows(s_dst, dst)
    scores = F.leaky_relu(s_src_e + s_dst_e, 0.2)         # [E, H]
    alpha = segment_softmax(scores, dst, n_nodes)
    (hw_src,) = gather_rows(hw, src)
    msg = hw_src * alpha[..., None]                       # [E, H, D]
    msg = constrain(msg, "batch", None, None)
    d_head = hw.shape[-1]
    out = _segment_sum(cfg, msg.reshape(e, n_heads * d_head), dst, n_nodes)
    out = out.reshape(n_nodes, n_heads, d_head)
    return out.reshape(n_nodes, -1) if concat else torch.mean(out, dim=1)


# -------------------------------------------------------------------- GIN ---

def _gin_layer(p, h, src, dst, n_nodes, cfg, learnable_eps=True):
    (h_src,) = gather_rows(h, src)
    msg = constrain(h_src, "batch", None)
    agg = _segment_sum(cfg, msg, dst, n_nodes)
    eps = p.eps if learnable_eps else 0.0
    out = _mlp(p.mlp, (1.0 + eps) * h + agg)
    return _layer_norm(out)          # stands in for the reference BatchNorm


# --------------------------------------------------------------- GatedGCN ---

def _gatedgcn_layer(p, h, e, src, dst, n_nodes, cfg):
    """Bresson & Laurent gated graph conv with edge-feature recurrence."""
    h_src, h_dst = gather_rows(h, src, dst)
    e_new = h_src @ p.A + h_dst @ p.B + e @ p.C            # [E, D]
    gate = torch.sigmoid(e_new)
    msg = constrain(gate * (h_src @ p.V), "batch", None)
    num = _segment_sum(cfg, msg, dst, n_nodes)
    den = _segment_sum(cfg, gate, dst, n_nodes)
    h_new = h @ p.U + num / (den + 1e-6)
    h_new = h + torch.relu(_layer_norm(h_new))             # residual
    e_new = e + torch.relu(_layer_norm(e_new))
    return h_new, e_new


# -------------------------------------------- GraphCast interaction block ---

def _interaction_layer(p, h, e, src, dst, n_nodes, cfg):
    """GraphCast/MeshGraphNet InteractionNetwork with residuals."""
    h_src, h_dst = gather_rows(h, src, dst)
    e = e + _mlp(p.edge_mlp, torch.cat([e, h_src, h_dst], dim=-1))
    agg = _segment_sum(cfg, constrain(e, "batch", None), dst, n_nodes)
    h_new = _mlp(p.node_mlp, torch.cat([h, agg], dim=-1))
    return h + h_new, e


# ------------------------------------------------------------- full model ---

def _spec(cfg: GNNConfig, d_feat: int, n_out: int) -> dict:
    d = cfg.d_hidden
    if cfg.kind == "gat":
        dims = [d_feat] + [d * cfg.n_heads] * (cfg.n_layers - 1)
        return dict(
            layers=[dict(w=("dense", dims[i], cfg.n_heads * d),
                         a_src=("normal", (cfg.n_heads, d), 0.1),
                         a_dst=("normal", (cfg.n_heads, d), 0.1))
                    for i in range(cfg.n_layers)],
            head=("dense", d, n_out))             # final layer averaged
    if cfg.kind == "gin":
        dims = [d_feat] + [d] * (cfg.n_layers - 1)
        return dict(layers=[dict(mlp=_mlp_spec((dims[i], d, d)),
                                 eps=("zeros", ()))
                            for i in range(cfg.n_layers)],
                    head=("dense", d, n_out))
    if cfg.kind == "gatedgcn":
        return dict(w_in=("dense", d_feat, d),
                    layers=[{k: ("dense", d, d) for k in "ABCUV"}
                            for _ in range(cfg.n_layers)],
                    head=("dense", d, n_out))
    if cfg.kind == "graphcast":
        # encoder (node + edge embed) -> processor x L -> decoder
        return dict(w_in=_mlp_spec((d_feat, d, d)),
                    w_edge_in=_mlp_spec((1, d, d)),
                    layers=[dict(edge_mlp=_mlp_spec((3 * d, d, d)),
                                 node_mlp=_mlp_spec((2 * d, d, d)))
                            for _ in range(cfg.n_layers)],
                    head=_mlp_spec((d, d, n_out)))
    raise ValueError(f"unknown GNN kind {cfg.kind!r}")


def init(seed: int, cfg: GNNConfig, d_feat: int, n_out: int, *,
         device=None) -> GNN:
    """Random parameters for ``cfg.kind`` with input dim d_feat and output
    n_out, drawn on ``device`` (default: the CUDA device; raises without
    one) from a generator seeded with ``seed``; on the ``meta`` device,
    their shapes only."""
    dev = resolve_device(device)
    tree = common.draw(_spec(cfg, d_feat, n_out), seed, dev,
                       getattr(torch, cfg.dtype))
    return GNN(tree, cfg)


def params_from_numpy(tree: dict, cfg: GNNConfig, device=None) -> GNN:
    """The JAX parameter pytree as nested dicts/lists of numpy arrays
    (``jax.tree.map(np.asarray, params)``) -> the port's module.  d_feat
    and n_out are read off the input and output layers."""
    if cfg.kind in ("gat", "gin"):
        w0 = tree["layers"][0]["w"] if cfg.kind == "gat" \
            else tree["layers"][0]["mlp"][0]["w"]
        d_feat, n_out = w0.shape[0], tree["head"].shape[1]
    elif cfg.kind == "gatedgcn":
        d_feat, n_out = tree["w_in"].shape[0], tree["head"].shape[1]
    else:
        d_feat = tree["w_in"][0]["w"].shape[0]
        n_out = tree["head"][-1]["w"].shape[1]
    want = common.spec_shapes(_spec(cfg, d_feat, n_out))
    if common.shapes(tree) != want:
        raise ValueError(f"params_from_numpy: shapes {common.shapes(tree)} "
                         f"do not match {cfg.name!r}: {want}")
    return GNN(common.tree_from_numpy(tree, resolve_device(device)), cfg)


def params_to_numpy(params: GNN) -> dict:
    return common.tree_to_numpy(params)


def _layer(cfg: GNNConfig, lp, fn, *args):
    """One layer, checkpointed when ``cfg.remat`` and it is differentiated
    (per-layer remat: at ogb_products scale storing every layer's edge
    activations for backward is hundreds of GiB; checkpointing keeps only
    layer inputs and recomputes inside backward)."""
    if cfg.remat and torch.is_grad_enabled() and (
            any(p.requires_grad for p in lp.parameters())
            or any(a.requires_grad for a in args)):
        return torch.utils.checkpoint.checkpoint(under_current_policy(fn),
                                                 *args, use_reentrant=False)
    return fn(*args)


def forward(params: GNN, cfg: GNNConfig,
            graph: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Returns per-node outputs [N, n_out] (callers readout for graph
    tasks)."""
    h = graph["node_feat"]
    src, dst = graph["edge_src"].long(), graph["edge_dst"].long()
    n = h.shape[0]

    if cfg.kind == "gat":
        for i, lp in enumerate(params.layers):
            last = i == len(params.layers) - 1

            def blk(h, lp=lp, last=last):
                out = _gat_layer(lp, h, src, dst, n, cfg.n_heads, cfg,
                                 concat=not last)
                return out if last else F.elu(out)

            h = constrain(_layer(cfg, lp, blk, h), "batch", None)
        return h @ params.head
    if cfg.kind == "gin":
        for lp in params.layers:
            def blk(h, lp=lp):
                return _gin_layer(lp, h, src, dst, n, cfg, cfg.learnable_eps)

            h = constrain(_layer(cfg, lp, blk, h), "batch", None)
        return h @ params.head
    if cfg.kind == "gatedgcn":
        h = h @ params.w_in
        e = full_rows(src, (cfg.d_hidden,), 0.0, h.dtype)
        for lp in params.layers:
            def blk(h, e, lp=lp):
                return _gatedgcn_layer(lp, h, e, src, dst, n, cfg)

            h, e = _layer(cfg, lp, blk, h, e)
            h = constrain(h, "batch", None)
            e = constrain(e, "batch", None)
        return h @ params.head
    if cfg.kind == "graphcast":
        h = _mlp(params.w_in, h)
        e = _mlp(params.w_edge_in, full_rows(src, (1,), 1.0, h.dtype))
        for lp in params.layers:
            def blk(h, e, lp=lp):
                return _interaction_layer(lp, h, e, src, dst, n, cfg)

            h, e = _layer(cfg, lp, blk, h, e)
            h = constrain(h, "batch", None)
            e = constrain(e, "batch", None)
        return _mlp(params.head, h)
    raise ValueError(cfg.kind)


def graph_readout(node_out: torch.Tensor, graph_ids: torch.Tensor,
                  n_graphs: int) -> torch.Tensor:
    return _scatter_sum(node_out, graph_ids, n_graphs)


# ---------------------------------------------------------------- training --

def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    ls = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.take_along_dim(ls, labels.long()[:, None],
                                            dim=-1))


def _accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, -1) == labels).float())


def make_loss_fn(cfg: GNNConfig, task: str, seed_count: int = 0):
    """``seed_count`` > 0 restricts node-task loss to the first
    ``seed_count`` positions — the seeds of a sampled node flow."""
    def loss_fn(params, batch):
        out = forward(params, cfg, batch)
        if task == "node":
            logits, labels = out, batch["labels"]
            if seed_count:                      # sampled: loss on seeds only
                logits, labels = logits[:seed_count], labels[:seed_count]
            loss = _nll(logits, labels)
            return loss, dict(loss=loss, acc=_accuracy(logits, labels))
        if task == "graph":
            labels = batch["labels"]
            logits = graph_readout(out, batch["graph_ids"], labels.shape[0])
            loss = _nll(logits, labels)
            return loss, dict(loss=loss, acc=_accuracy(logits, labels))
        if task == "regress":
            err = (out - batch["targets"]).float()
            loss = torch.mean(torch.square(err))
            return loss, dict(loss=loss, acc=like(
                torch.zeros((), device=loss.device), loss))
        raise ValueError(task)
    return loss_fn


def make_train_step(cfg: GNNConfig, opt_cfg: AdamWConfig, task: str,
                    seed_count: int = 0):
    loss_fn = make_loss_fn(cfg, task, seed_count)

    def step(params, opt_state, batch):
        (loss, metrics), (grads,) = common.value_and_grad(
            lambda p: loss_fn(p, batch), params)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params,
                                                opt_cfg)
        return params, opt_state, dict(metrics, gnorm=gnorm)

    return step


def task_for_shape(shape_kind: str, arch_kind: str) -> str:
    if arch_kind == "graphcast":
        return "regress"
    return "graph" if shape_kind == "batched" else "node"
