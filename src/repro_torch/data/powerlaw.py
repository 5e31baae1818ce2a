"""Power-law (R-MAT / Kronecker) edge-stream generator — paper §III workload.

The paper benchmarks "a power-law graph of 100,000,000 entries divided up
into 1,000 sets of 100,000 entries" per instance.  R-MAT with Graph500
parameters (a=.57, b=.19, c=.19, d=.05) is the standard generator for that
family.  Drawn on the generator's device from an explicit
``torch.Generator``: one uniform draw per (edge, scale-bit) picks the
quadrant.  The bits differ from the JAX generator's; the distribution is
the same.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

GRAPH500 = (0.57, 0.19, 0.19, 0.05)


def rmat_edges(gen: torch.Generator, n_edges: int, scale: int,
               params: Tuple[float, float, float, float] = GRAPH500
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample n_edges (row, col) int32 pairs on a 2^scale x 2^scale vertex
    grid, on ``gen``'s device."""
    n_edges, scale = int(n_edges), int(scale)
    dev = gen.device
    bounds = torch.tensor(np.cumsum(params)[:-1], dtype=torch.float32,
                          device=dev)
    u = torch.rand((n_edges, scale), generator=gen, device=dev)
    rows = torch.zeros((n_edges,), dtype=torch.int32, device=dev)
    cols = torch.zeros((n_edges,), dtype=torch.int32, device=dev)
    # one bit level at a time: [E] temporaries, not [E, S] int64 ones
    # (114M edges at scale 18 would take ~50 GB)
    for s in range(scale):
        quad = torch.searchsorted(bounds, u[:, s].contiguous(),
                                  right=True, out_int32=True)   # {0..3}
        rows += (quad >> 1) << s
        cols += (quad & 1) << s
    return rows, cols


def rmat_stream(gen: torch.Generator, n_blocks: int, block_size: int,
                scale: int,
                params: Tuple[float, float, float, float] = GRAPH500):
    """The paper's per-instance stream: [T, B] update blocks with unit values.

    (T=1000, B=100000, total 1e8 for the full-size experiment.)
    """
    rows, cols = rmat_edges(gen, n_blocks * block_size, scale, params)
    vals = torch.ones((n_blocks, block_size), dtype=torch.float32,
                      device=gen.device)
    return (rows.reshape(n_blocks, block_size),
            cols.reshape(n_blocks, block_size), vals)


def instance_streams(gen: torch.Generator, n_instances: int, n_blocks: int,
                     block_size: int, scale: int, params=GRAPH500):
    """Independent streams for many instances: [I, T, B] tensors — the
    paper's "thousands of processors each creating many different graphs"."""
    rows, cols, vals = rmat_stream(gen, n_instances * n_blocks, block_size,
                                   scale, params)
    shape = (n_instances, n_blocks, block_size)
    return rows.reshape(shape), cols.reshape(shape), vals.reshape(shape)


def degree_tail_exponent(degrees) -> float:
    """Crude MLE power-law exponent over the degree tail (sanity checks)."""
    if isinstance(degrees, torch.Tensor):
        degrees = degrees.cpu().numpy()
    d = np.asarray(degrees)
    d = d[d >= 1].astype(np.float64)
    if d.size < 10:
        return float("nan")
    xmin = max(1.0, np.percentile(d, 50))
    tail = d[d >= xmin]
    return 1.0 + tail.size / np.sum(np.log(tail / xmin))
