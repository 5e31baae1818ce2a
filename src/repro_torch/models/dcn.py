"""DCN-v2 (arXiv:2008.13535) serving: embedding tables -> cross network ->
deep MLP, on the card.

The port of ``repro/models/dcn.py``'s serving path.  The 26 per-field
embedding tables are STACKED into one [padded_rows, embed_dim] table with
static per-field offsets; the lookup (a gather, or with ``cfg.use_kernel``
the ``embedding_bag`` CUDA kernel) is the serving hot path.  Cross layers
are the DCN-v2 full-rank form  x_{l+1} = x0 * (x_l W + b) + x_l,  followed
by the deep MLP (1024-1024-512) and a logit head.

The model is a ``DCNv2`` module whose parameter names are the JAX pytree's
paths (``table``, ``cross.0.w``, ``mlp.2.b``, ``logit_w``, a 0-d
``logit_b``); the serving functions keep the JAX names and signatures and
take the module where JAX takes ``params``.  Inference only: the
parameters do not require gradients (the kernels have no backward yet; the
training steps are still to port).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import generator, resolve_device
from repro_torch.configs.base import RecsysConfig
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.models import common


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
    raises without one) from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    tree = common.materialize(_spec(cfg, table_scale),
                              generator(seed, dev),
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
    sizes = torch.tensor(cfg.table_sizes, dtype=torch.int32,
                         device=sparse.device)
    offs = torch.tensor(field_offsets(cfg), dtype=torch.int32,
                        device=sparse.device)
    return (sparse.to(torch.int32) % sizes[None, :, None]) \
        + offs[None, :, None]


def embed_lookup(table: torch.Tensor, sparse: torch.Tensor,
                 cfg: RecsysConfig) -> torch.Tensor:
    """-> [B, n_sparse * embed_dim] (multi-hot bags sum-combined)."""
    gids = global_ids(sparse, cfg)                       # [B, F, H]
    b, f, hh = gids.shape
    if cfg.use_kernel:
        out = eb_ops.embedding_bag(table, gids.reshape(b * f, hh))
        out = out.reshape(b, f, cfg.embed_dim).to(table.dtype)
    else:
        out = torch.sum(table[gids.long()], dim=2)       # [B, F, D]
    return out.reshape(b, f * cfg.embed_dim)


def interact(params: DCNv2, dense: torch.Tensor, embeds: torch.Tensor,
             cfg: RecsysConfig) -> torch.Tensor:
    """Cross network + deep MLP -> final hidden [B, mlp[-1]]."""
    x0 = torch.cat([dense.to(embeds.dtype), embeds], dim=-1)
    x = x0
    for lp in params.cross:
        x = x0 * (x @ lp.w + lp.b) + x                    # DCN-v2 cross
    for lp in params.mlp:
        x = torch.relu(x @ lp.w + lp.b)
    return x


def forward(params: DCNv2, batch: Dict[str, torch.Tensor],
            cfg: RecsysConfig) -> torch.Tensor:
    embeds = embed_lookup(params.table, batch["sparse"], cfg)
    h = interact(params, batch["dense"], embeds, cfg)
    return (h @ params.logit_w)[:, 0] + params.logit_b


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
    values, indices = torch.topk(q @ candidates.T, k, dim=-1)
    return values, indices.to(torch.int32)
