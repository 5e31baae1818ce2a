"""The benchmark's seeded inputs: Graph500 R-MAT edge streams, the flows'
byte values and the query-key sets, and the query arrivals.

Everything but the arrivals is drawn from ``--seed`` alone, on the
device, in chunks: one uniform draw a scale bit picks the quadrant
(a=.57, b=.19, c=.19, d=.05), so a paper epoch of 409.6 M updates never holds more than ``CHUNK`` draws
at once.  The R-MAT arithmetic is the program's own generator's
(``repro_torch.data.powerlaw``: bit ``s`` of the row and the column from
the quadrant of level ``s``), kept here so that a change to the program
cannot move the yardstick.

Sub-streams are keyed by name (``sub_seed(seed, "stream", 0)``), so one
seed gives the same stream, values and keys whatever else a cell draws.
"""
from __future__ import annotations

import math

import numpy as np
import torch

GRAPH500 = (0.57, 0.19, 0.19, 0.05)
CHUNK = 1 << 24
ARRIVALS_SEED = 1          # the query schedule's order, for every seed


def sub_seed(seed: int, *path) -> int:
    """A 63-bit seed for the named sub-stream of ``seed`` (any whole
    number, negative ones included)."""
    words = [int(seed) % (1 << 64)]
    for p in path:
        words += list(str(p).encode()) if isinstance(p, str) else [int(p)]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, *path, device="cpu") -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, *path))
    return gen


def rmat_fill(gen: torch.Generator, rows: torch.Tensor, cols: torch.Tensor,
              scale: int, params=GRAPH500) -> None:
    """Fill the 1-D int32 tensors ``rows`` and ``cols`` with R-MAT edges
    on a 2**scale x 2**scale grid, ``CHUNK`` edges at a time."""
    a, b, c, _ = params
    bounds = (a, a + b, a + b + c)
    n = rows.numel()
    for start in range(0, n, CHUNK):
        r = rows[start:start + CHUNK]
        q = cols[start:start + CHUNK]
        r.zero_()
        q.zero_()
        for s in range(scale):
            u = torch.rand(r.numel(), generator=gen, device=rows.device)
            quad = ((u >= bounds[0]).to(torch.int32)
                    + (u >= bounds[1]).to(torch.int32)
                    + (u >= bounds[2]).to(torch.int32))
            r.bitwise_or_((quad >> 1) << s)
            q.bitwise_or_((quad & 1) << s)


def values_fill(gen: torch.Generator, vals: torch.Tensor, lo: int,
                hi: int) -> None:
    """Fill a 1-D float tensor with whole numbers in [lo, hi] (the bytes of
    a flow), ``CHUNK`` at a time."""
    n = vals.numel()
    for start in range(0, n, CHUNK):
        v = vals[start:start + CHUNK]
        v.copy_(torch.randint(lo, hi + 1, (v.numel(),), generator=gen,
                              device=vals.device, dtype=torch.int32))


def streams(seed: int, n_streams: int, instances: int, blocks: int,
            block: int, scale: int, values, device, params=GRAPH500):
    """``n_streams`` epochs of every instance's update stream:
    (rows, cols, vals), each ``[n_streams, instances, blocks, block]``;
    values are float32 whole numbers in ``values = [lo, hi]``."""
    shape = (n_streams, instances, blocks, block)
    rows = torch.empty(shape, dtype=torch.int32, device=device)
    cols = torch.empty(shape, dtype=torch.int32, device=device)
    vals = torch.empty(shape, dtype=torch.float32, device=device)
    rmat_fill(generator(seed, "stream", device=device), rows.view(-1),
              cols.view(-1), scale, params)
    values_fill(generator(seed, "values", device=device), vals.view(-1),
                int(values[0]), int(values[1]))
    return rows, cols, vals


def key_sets(seed: int, n_sets: int, keys: int, rmat_share: float,
             scale: int, device, params=GRAPH500):
    """``n_sets`` query batches of ``keys`` keys each, ``[n_sets, keys]``
    int32 rows and cols: the first ``round(keys * rmat_share)`` of a batch
    drawn from the streams' R-MAT distribution, the rest uniform over the
    grid."""
    k_r = int(round(keys * rmat_share))
    q_rows = torch.empty((n_sets, keys), dtype=torch.int32, device=device)
    q_cols = torch.empty_like(q_rows)
    if k_r:
        r = torch.empty(n_sets * k_r, dtype=torch.int32, device=device)
        c = torch.empty_like(r)
        rmat_fill(generator(seed, "keys.rmat", device=device), r, c, scale,
                  params)
        q_rows[:, :k_r] = r.view(n_sets, k_r)
        q_cols[:, :k_r] = c.view(n_sets, k_r)
    if k_r < keys:
        gen = generator(seed, "keys.uniform", device=device)
        shape = (n_sets, keys - k_r)
        q_rows[:, k_r:] = torch.randint(0, 1 << scale, shape, generator=gen,
                                        device=device, dtype=torch.int32)
        q_cols[:, k_r:] = torch.randint(0, 1 << scale, shape, generator=gen,
                                        device=device, dtype=torch.int32)
    return q_rows, q_cols


def poisson_arrivals(rate: float, seconds: float) -> np.ndarray:
    """Due times (s after the window opens) of ``floor(rate * seconds)``
    batches: the exponential gaps of a Poisson process at ``rate``, taken
    at their stratified quantiles, in one order fixed by
    ``ARRIVALS_SEED``.  The schedule is the same for every ``--seed``, as
    a replayed trace of arrivals would be: its order alone moves the work
    an open loop does between two ingest calls."""
    n = int(math.floor(rate * seconds))
    if n < 1:
        return np.zeros(0)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    rng = np.random.default_rng(sub_seed(ARRIVALS_SEED, "arrivals"))
    return np.cumsum(rng.permutation(gaps))
