"""AdamW — the port of ``repro/optim/adamw.py``.

The update is the decoupled-weight-decay form (Loshchilov & Hutter) with
bias-corrected moments; gradient clipping is by global norm across the
whole tree.  The state keeps the parameter tree's nesting: ``m`` and ``v``
mirror it in float32 (nested dicts and lists, so checkpoint paths read
``opt/m/cross/0/w``), ``count`` is an int32 0-d tensor.

The arithmetic is the reference's, operation for operation: the bias
correction ``1 - b ** t`` is a float32 power of the int32 count; the clip
scale ``min(1, max_norm / max(gnorm, 1e-12))``; weight decay on every leaf.
Unlike the reference the update runs IN PLACE on the parameters and
moments, leaf by leaf and in slices of ``CHUNK`` elements, so a 6 GB
embedding table needs a few hundred MB of temporaries, not another five
copies of itself.  Trees are walked in the JAX package's leaf order
(``models/common.py::tree_leaves``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.common import tree_leaves, tree_map

CHUNK = 1 << 24      # elements per slice of the in-place update


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params) -> dict:
    """Zero float32 moments mirroring ``params`` and a 0-d int32 count on
    the parameters' device."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    # zeros_like keeps a sharded parameter's placements (a DTensor)
    zeros32 = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return dict(m=tree_map(zeros32, params), v=tree_map(zeros32, params),
                count=torch.zeros((), dtype=torch.int32, device=dev))


def _global_norm(grads) -> torch.Tensor:
    sq = 0
    for g in tree_leaves(grads):
        sq = sq + torch.sum(torch.square(g.float()))
    norm = torch.sqrt(sq)
    # sharded gradients (DTensors): the one collective of the update
    return norm.full_tensor() if isinstance(norm, DTensor) else norm


def _local(p, g, m, v):
    """A leaf's parameter, gradient and moments as the tensors this rank
    updates: the local shards of DTensors (the gradient first put under
    its parameter's placements), the tensors themselves otherwise."""
    if not isinstance(p, DTensor):
        return p, g, m, v
    g = g.redistribute(p.device_mesh, p.placements)
    return tuple(x.to_local() for x in (p, g, m, v))


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    # a float32 division (``float / tensor`` would multiply by a
    # reciprocal); ``full`` fills on the device, where ``torch.tensor``
    # would copy from the host and wait for it (a step runs under
    # ``set_sync_debug_mode("error")`` in the LM trainer)
    num = torch.full((), max_norm, dtype=torch.float32, device=gnorm.device)
    return torch.clamp(num / torch.clamp(gnorm, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to global norm <= max_norm, pre-clip global norm)."""
    gnorm = _global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


def _pow32(b: float, t: torch.Tensor) -> torch.Tensor:
    return torch.pow(torch.full((), b, dtype=torch.float32, device=t.device),
                     t)


@torch.no_grad()
def adamw_update(grads, state: dict, params, cfg: AdamWConfig,
                 lr: torch.Tensor | float | None = None
                 ) -> Tuple[Any, dict, torch.Tensor]:
    """Returns (params, new state, pre-clip grad norm).  ``params`` and the
    state's moments are updated in place and returned; ``count`` is a new
    tensor.  ``grads`` is not modified."""
    # the clip is applied slice by slice below: clip_by_global_norm would
    # allocate a clipped copy of every gradient
    gnorm = _global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    count = state["count"] + 1
    t = count.to(torch.float32)
    lr = cfg.lr if lr is None else lr
    bc1 = 1.0 - _pow32(cfg.b1, t)
    bc2 = 1.0 - _pow32(cfg.b2, t)

    for leaf in zip(tree_leaves(params), tree_leaves(grads),
                    tree_leaves(state["m"]), tree_leaves(state["v"])):
        p, g, m, v = _local(*leaf)
        flat = [x.reshape(-1) for x in (p, g, m, v)]
        for lo in range(0, max(p.numel(), 1), CHUNK):
            ps, gs, ms, vs = (x[lo:lo + CHUNK] for x in flat)
            g32 = (gs.float() * scale).to(gs.dtype).float()
            ms.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
            vs.mul_(cfg.b2).add_(torch.square(g32).mul_(1 - cfg.b2))
            step = (ms / bc1).div_(torch.sqrt(vs / bc2).add_(cfg.eps))
            step.add_(ps.float() * cfg.weight_decay)
            ps.copy_((ps.float() - step.mul_(lr)).to(ps.dtype))
    return params, dict(m=state["m"], v=state["v"], count=count), gnorm


@torch.no_grad()
def apply_updates(params, updates):
    """params += updates, leaf by leaf, in place; returns ``params``."""
    for p, u in zip(tree_leaves(params), tree_leaves(updates)):
        p.add_(u.to(p.dtype))
    return params


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``floor * peak_lr`` (float32)."""
    t = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * torch.clamp(t / max(warmup, 1), max=1.0)
    frac = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(t < warmup, warm, peak_lr * cos)
