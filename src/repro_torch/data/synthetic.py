"""Synthetic token and recsys streams: Zipf token batches for the LMs, a
Criteo-style click stream (13 dense + 26 categorical fields) with a
planted logistic teacher, and the retrieval shape — the port of
``repro/data/synthetic.py``.

Everything is drawn on the device from a ``torch.Generator`` seeded with
``seed``, with the reference's formulas; the bits differ from JAX's.
"""
from __future__ import annotations

import math

import torch

from repro_torch import generator, resolve_device


def token_batch(seed: int, batch: int, seq_len: int, vocab: int, *,
                device=None):
    """Zipf(1.1)-distributed token ids: tokens [B, S] int32 and labels =
    the next token, on ``device`` (default: the CUDA device).

    Id i is drawn with probability proportional to (i + 1) ** -1.1, by
    inverting the cumulative distribution at uniform draws.
    """
    dev = resolve_device(device)
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=dev)
    cdf = torch.cumsum(torch.softmax(-1.1 * torch.log(ranks), dim=0), dim=0)
    u = torch.rand((batch, seq_len + 1), generator=generator(seed, dev),
                   dtype=torch.float64, device=dev)
    toks = torch.clamp(torch.searchsorted(cdf, u, right=True),
                       max=vocab - 1).to(torch.int32)
    return dict(tokens=toks[:, :-1], labels=toks[:, 1:])


def token_stream(seed: int, steps: int, batch: int, seq_len: int,
                 vocab: int, *, device=None):
    """Host-side iterator of token batches; step i's comes from the seed
    ``(seed << 32) | i``."""
    for i in range(steps):
        yield token_batch((int(seed) << 32) | i, batch, seq_len, vocab,
                          device=device)


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
