"""DCN-v2 (arXiv:2008.13535): embedding tables -> cross network -> deep
MLP, served and trained on the card — the port of ``repro/models/dcn.py``.
  The 26 per-field
embedding tables are STACKED into one [padded_rows, embed_dim] table with
static per-field offsets; the lookup (a gather, or with ``cfg.use_kernel``
the ``embedding_bag`` CUDA kernel) is the serving hot path.  Cross layers
are the DCN-v2 full-rank form  x_{l+1} = x0 * (x_l W + b) + x_l,  followed
by the deep MLP (1024-1024-512) and a logit head.

The model is a ``DCNv2`` module whose parameter names are the JAX pytree's
paths (``table``, ``cross.0.w``, ``mlp.2.b``, ``logit_w``, a 0-d
``logit_b``); the serving functions keep the JAX names and signatures and
take the module where JAX takes ``params``.  The parameters do not
require gradients: the training steps turn autograd on for their leaves
only inside a step (``common.value_and_grad``).

Training paths:
  * ``make_train_step``      — dense autodiff table grads (reference).
  * ``make_train_step_hier`` — the PAPER'S TECHNIQUE as an optimizer
    feature: per-step row-sparse embedding grads are block-added into a
    hierarchical accumulator (``core/vassoc.HierVec``); the master table is
    only touched when the deepest cut spills or every ``drain_every``
    steps (a batched scatter-apply).  Dense params take AdamW; embedding
    rows follow SGD semantics (DLRM-standard).
Both update the parameters in place.  The ``embedding_bag`` kernel has no
backward (nor has the reference's): a step with ``cfg.use_kernel`` raises
``NotImplementedError``; the hier step reads the table with a gather, as
the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import RecsysConfig
from repro_torch.core import vassoc
from repro_torch.distribution.sharding import constrain, like, lookup_rows
from repro_torch.kernels import registry
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.models import common
from repro_torch.optim.adamw import AdamWConfig, adamw_update


class DCNv2(common.ParamTree):
    """The DCN-v2 parameters, with their config."""

    def __init__(self, tree: dict, cfg: RecsysConfig):
        super().__init__(tree)
        self.cfg = cfg


def field_offsets(cfg: RecsysConfig) -> np.ndarray:
    """Static row offset of each field's sub-table in the stacked table."""
    return np.concatenate([[0], np.cumsum(cfg.table_sizes)[:-1]]).astype(
        np.int64)


def _spec(cfg: RecsysConfig, table_scale: float) -> dict:
    d0 = cfg.d_interact
    dims = (d0,) + tuple(cfg.mlp)
    return dict(
        table=("normal", (cfg.padded_rows, cfg.embed_dim), table_scale),
        cross=[dict(w=("dense", d0, d0), b=("zeros", (d0,)))
               for _ in range(cfg.n_cross_layers)],
        mlp=[dict(w=("dense", dims[i], dims[i + 1]),
                  b=("zeros", (dims[i + 1],)))
             for i in range(len(cfg.mlp))],
        logit_w=("dense", cfg.mlp[-1], 1),
        logit_b=("zeros", ()))


def init(seed: int, cfg: RecsysConfig, table_scale: float = 0.01, *,
         device=None) -> DCNv2:
    """Random parameters drawn on ``device`` (default: the CUDA device;
    raises without one) from a generator seeded with ``seed``; on the
    ``meta`` device, their shapes only."""
    dev = resolve_device(device)
    tree = common.draw(_spec(cfg, table_scale), seed, dev,
                       getattr(torch, cfg.dtype))
    return DCNv2(tree, cfg)


def params_from_numpy(tree: dict, cfg: RecsysConfig, device=None) -> DCNv2:
    """The JAX parameter pytree as nested dicts/lists of numpy arrays
    (``jax.tree.map(np.asarray, params)``) -> the port's module."""
    want = common.spec_shapes(_spec(cfg, 0.0))
    if common.shapes(tree) != want:
        raise ValueError(f"params_from_numpy: shapes {common.shapes(tree)} "
                         f"do not match {cfg.name!r}: {want}")
    return DCNv2(common.tree_from_numpy(tree, resolve_device(device)), cfg)


def params_to_numpy(params: DCNv2) -> dict:
    return common.tree_to_numpy(params)


def global_ids(sparse: torch.Tensor, cfg: RecsysConfig) -> torch.Tensor:
    """[B, F] or [B, F, H] per-field ids -> stacked-table row ids."""
    if sparse.dim() == 2:
        sparse = sparse[..., None]
    sizes = like(torch.tensor(cfg.table_sizes, dtype=torch.int32,
                              device=sparse.device), sparse)
    offs = like(torch.tensor(field_offsets(cfg), dtype=torch.int32,
                             device=sparse.device), sparse)
    return (sparse.to(torch.int32) % sizes[None, :, None]) \
        + offs[None, :, None]


def _bags_gather(table: torch.Tensor, ids: torch.Tensor,
                 weights) -> torch.Tensor:
    """[..., H] ids -> [..., D]: the rows gathered and summed over H."""
    rows = table[ids.long()]
    if weights is not None:
        rows = rows * weights[..., None].to(rows.dtype)
    return torch.sum(rows, dim=-2)


def _bags_kernel(table: torch.Tensor, ids: torch.Tensor,
                 weights) -> torch.Tensor:
    """``_bags_gather`` through the ``embedding_bag`` CUDA kernel."""
    lead, hh = ids.shape[:-1], ids.shape[-1]
    if weights is not None:
        weights = weights.reshape(-1, hh)
    out = eb_ops.embedding_bag(table, ids.reshape(-1, hh), weights)
    return out.reshape(*lead, table.shape[-1]).to(table.dtype)


def embed_lookup(table: torch.Tensor, sparse: torch.Tensor,
                 cfg: RecsysConfig) -> torch.Tensor:
    """-> [B, n_sparse * embed_dim] (multi-hot bags sum-combined).  Under a
    policy the row-sharded table is looked up vocab-parallel
    (``sharding.lookup_rows``): each rank reads its own block, with the
    same gather or kernel on the local rows."""
    gids = global_ids(sparse, cfg)                       # [B, F, H]
    b, f, _ = gids.shape
    if cfg.use_kernel:
        registry.refuse_autograd("embedding_bag", table)
    out = lookup_rows(table, gids, _bags_kernel if cfg.use_kernel
                      else _bags_gather, "batch", None, None)  # [B, F, D]
    return constrain(out.reshape(b, f * cfg.embed_dim), "batch", None)


def interact(params: DCNv2, dense: torch.Tensor, embeds: torch.Tensor,
             cfg: RecsysConfig) -> torch.Tensor:
    """Cross network + deep MLP -> final hidden [B, mlp[-1]]."""
    x0 = torch.cat([dense.to(embeds.dtype), embeds], dim=-1)
    x0 = constrain(x0, "batch", None)
    x = x0
    for lp in params.cross:
        x = x0 * (x @ lp.w + lp.b) + x                    # DCN-v2 cross
    for lp in params.mlp:
        x = torch.relu(x @ lp.w + lp.b)
    return constrain(x, "batch", None)


def forward(params: DCNv2, batch: Dict[str, torch.Tensor],
            cfg: RecsysConfig) -> torch.Tensor:
    embeds = embed_lookup(params.table, batch["sparse"], cfg)
    h = interact(params, batch["dense"], embeds, cfg)
    return (h @ params.logit_w)[:, 0] + params.logit_b


def bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    # at x = 0 the reference's gradients are jnp.maximum's 0.5 (torch's
    # ``maximum`` splits a tie too; ``relu`` and ``clamp`` give 0 or 1) and
    # jnp.abs's 1 (torch's ``abs`` gives 0; the ``where`` gives 1)
    x, y = logits.float(), labels.float()
    zero = like(torch.zeros((), dtype=x.dtype, device=x.device), x)
    abs_x = torch.where(x >= 0, x, -x)
    return torch.mean(torch.maximum(x, zero) - x * y
                      + torch.log1p(torch.exp(-abs_x)))


# ---------------------------------------------------------------- training --

def make_train_step(cfg: RecsysConfig, opt_cfg: AdamWConfig):
    """Reference path: dense autodiff grads for everything (incl. table)."""

    def loss_fn(params, batch):
        logits = forward(params, batch, cfg)
        loss = bce(logits, batch["labels"])
        return loss, dict(loss=loss)

    def step(params, opt_state, batch):
        (loss, metrics), (grads,) = common.value_and_grad(
            lambda p: loss_fn(p, batch), params)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params,
                                                opt_cfg)
        return params, opt_state, dict(metrics, gnorm=gnorm)

    return step


@dataclasses.dataclass(frozen=True)
class HierEmbedState:
    """Pending sparse embedding-gradient mass (the paper's hierarchy)."""
    hier: vassoc.HierVec
    steps: torch.Tensor              # int32, for the periodic drain


def hier_embed_init(cfg: RecsysConfig, batch: int,
                    cuts: Tuple[int, ...] = (8192, 65536, 524288), *,
                    device=None) -> HierEmbedState:
    dev = resolve_device(device)
    block = batch * cfg.n_sparse * cfg.multi_hot
    return HierEmbedState(
        hier=vassoc.create(cuts, block, cfg.embed_dim, device=dev),
        steps=torch.zeros((), dtype=torch.int32, device=dev))


def rest_params(params: DCNv2) -> dict:
    """Every parameter but the table, as the pytree's top-level dict."""
    items = dict(params.named_parameters(recurse=False))
    items.update(params.named_children())
    return {k: v for k, v in items.items() if k != "table"}


def make_train_step_hier(cfg: RecsysConfig, opt_cfg: AdamWConfig,
                         embed_lr: float = 0.05, drain_every: int = 64):
    """Paper-technique path: hierarchical sparse embedding-grad accumulation.

    The embedding activation e [B, F, D] is treated as a leaf: autodiff
    yields (dense-param grads, grad_e); grad_e rows are block-added into the
    HierVec keyed by stacked-table row id.  The master table is touched
    only on drain (deepest-cut pressure or every ``drain_every`` steps).
    Two host reads of a device flag per step with three cuts (the spill
    decisions of ``vassoc.update``) plus one for the drain.
    """

    def loss_from_embeds(params, embeds_flat, batch):
        # ``params``' leaves but the table are the ``rest`` differentiated
        h = interact(params, batch["dense"],
                     constrain(embeds_flat, "batch", None), cfg)
        logits = (h @ params.logit_w)[:, 0] + params.logit_b
        loss = bce(logits, batch["labels"])
        return loss, dict(loss=loss)

    def step(params, opt_state, hstate: HierEmbedState, batch):
        table = params.table
        rest = rest_params(params)
        gids = global_ids(batch["sparse"], cfg)          # [B, F, H]
        b, f, hh = gids.shape
        with torch.no_grad():
            vecs = table[gids.long()]                    # [B, F, H, D]
            embeds_flat = torch.sum(vecs, dim=2).reshape(
                b, f * cfg.embed_dim)
            del vecs

        (loss, metrics), (g_rest, g_embeds) = common.value_and_grad(
            lambda r, e: loss_from_embeds(params, e, batch), rest,
            embeds_flat)
        _, opt_state, gnorm = adamw_update(g_rest, opt_state, rest, opt_cfg)

        # row-sparse table grads: every (b, f, h) occurrence carries the
        # field's grad slice (sum-combine duplicates inside the hierarchy)
        g_rows = g_embeds.reshape(b, f, 1, cfg.embed_dim).expand(
            b, f, hh, cfg.embed_dim).reshape(-1, cfg.embed_dim)
        hier = vassoc.update(hstate.hier, gids.reshape(-1), g_rows)
        steps = hstate.steps + 1

        last = hier.layers[-1]
        pressure = (last.nnz > hier.cuts[-1]) | (steps % drain_every == 0)
        if vassoc.host_flag(pressure):
            hier, _ = vassoc.drain_to_table(hier, table, -embed_lr)

        telemetry = dict(metrics, gnorm=gnorm,
                         pending_nnz=torch.sum(hier.nnz_per_layer(),
                                               dtype=torch.int32),
                         spills=hier.spills, drained=pressure)
        return params, opt_state, HierEmbedState(hier, steps), telemetry

    return step


# ----------------------------------------------------------------- serving --

def serve_scores(params: DCNv2, batch: Dict[str, torch.Tensor],
                 cfg: RecsysConfig) -> torch.Tensor:
    return torch.sigmoid(forward(params, batch, cfg))


def query_embedding(params: DCNv2, batch: Dict[str, torch.Tensor],
                    cfg: RecsysConfig) -> torch.Tensor:
    embeds = embed_lookup(params.table, batch["sparse"], cfg)
    return interact(params, batch["dense"], embeds, cfg)   # [B, mlp[-1]]


def retrieval_topk(params: DCNv2, batch: Dict[str, torch.Tensor],
                   candidates: torch.Tensor, cfg: RecsysConfig, k: int = 100
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score the query batch against [N, mlp[-1]] candidates; top-k per
    query as (values [B, k], int32 indices [B, k])."""
    q = query_embedding(params, batch, cfg)               # [B, D]
    scores = constrain(q @ candidates.T, "batch", "tp")   # [B, N]
    values, indices = torch.topk(scores, k, dim=-1)
    return values, indices.to(torch.int32)
