"""Public wrapper for embedding_bag.

Normalizes ragged input (mask -> index 0 and zero weight, indices clamped
to [0, V)), picks the kernel wrapper or the oracle, and implements the
sum / mean combiners — as ``repro/kernels/embedding_bag/ops.py`` does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import registry
from repro_torch.kernels.embedding_bag import ref
from repro_torch.kernels.embedding_bag.embedding_bag import embedding_bag_cuda


def embedding_bag(table, indices, weights=None, mask=None, *,
                  combiner: str = "sum", use_kernel: bool = True):
    """out[b] = combine_l  weights[b,l] * table[indices[b,l]].

    indices [B, L] integer; optional mask [B, L] bool (False = padding);
    optional weights [B, L].  Returns [B, D] float32.  With ``use_kernel``
    it raises ``NotImplementedError`` when grad mode is on and ``table`` or
    ``weights`` requires grad (the kernel has no backward).
    """
    if use_kernel:
        registry.refuse_autograd("embedding_bag", table, weights)
    if combiner not in ("sum", "mean"):
        raise ValueError(f"unknown combiner {combiner!r}")
    n_bags, bag = indices.shape
    if weights is None:
        weights = torch.ones((n_bags, bag), dtype=torch.float32,
                             device=indices.device)
    if mask is not None:
        weights = torch.where(mask, weights, 0.0)
        indices = torch.where(mask, indices, 0)
    indices = indices.clamp(0, table.shape[0] - 1).to(torch.int32)

    if use_kernel:
        out = embedding_bag_cuda(table, indices.contiguous(),
                                 weights.float().contiguous())
    else:
        out = ref.embedding_bag_ref(table, indices, weights)

    if combiner == "mean":
        counts = torch.sum(weights != 0.0, dim=1, keepdim=True)
        out = out / counts.clamp(min=1).float()
    return out
