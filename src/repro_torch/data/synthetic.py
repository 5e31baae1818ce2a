"""Synthetic recsys streams: a Criteo-style click stream (13 dense + 26
categorical fields) with a planted logistic teacher, and the retrieval
shape — the port of ``repro/data/synthetic.py``'s recsys part.

Everything is drawn on the device from a ``torch.Generator`` seeded with
``seed``, with the reference's formulas; the bits differ from JAX's.
"""
from __future__ import annotations

import math

import torch

from repro_torch import generator, resolve_device


def recsys_batch(seed: int, batch: int, n_dense: int = 13,
                 n_sparse: int = 26, vocab_per_field: int = 1_000_000,
                 multi_hot: int = 1, *, device=None):
    """Criteo-like batch: dense [B, 13] f32 + sparse ids [B, 26, H] int32 +
    labels [B] f32, on ``device`` (default: the CUDA device).

    Labels come from a fixed random logistic teacher over the dense features
    and a hash of the sparse ids.
    """
    dev = resolve_device(device)
    gen = generator(seed, dev)
    dense = torch.randn((batch, n_dense), generator=gen, device=dev)
    # zipf-ish ids: floor(exp(u * log V)) concentrates mass on small ids
    u = torch.rand((batch, n_sparse, multi_hot), generator=gen, device=dev)
    sparse = torch.floor(torch.exp(u * math.log(float(vocab_per_field)))
                         ).to(torch.int32) % vocab_per_field
    w = torch.randn((n_dense,), generator=generator(7, dev), device=dev)
    teacher = (dense @ w) / math.sqrt(n_dense) + 0.1 * torch.sin(
        torch.sum(sparse[..., 0], dim=1).float() / 1000.0)
    labels = (torch.rand((batch,), generator=gen, device=dev)
              < torch.sigmoid(teacher)).float()
    return dict(dense=dense, sparse=sparse, labels=labels)


def retrieval_batch(seed: int, batch: int, n_candidates: int, dim: int, *,
                    device=None):
    """Retrieval-scoring shape: queries [B, D] vs candidate matrix [N, D]."""
    dev = resolve_device(device)
    gen = generator(seed, dev)
    return dict(query=torch.randn((batch, dim), generator=gen, device=dev),
                candidates=torch.randn((n_candidates, dim), generator=gen,
                                       device=dev))
