"""The port's R-MAT generator, held statistically: the two packages draw
different random bits, so quadrant frequencies are checked against
``GRAPH500`` within 3 sigma and the degree-tail exponent against the JAX
generator's at the same size."""
import jax
import numpy as np
import pytest
import torch

from repro.data import powerlaw as jpl
from repro_torch.data import powerlaw as tpl


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def test_graph500_parameters_match():
    assert tpl.GRAPH500 == jpl.GRAPH500


@pytest.mark.parametrize("scale", [1, 10])
def test_quadrant_frequencies_within_3_sigma(scale):
    n = 1 << 15
    gen = torch.Generator().manual_seed(scale)
    rows, cols = tpl.rmat_edges(gen, n, scale)
    assert rows.dtype == cols.dtype == torch.int32
    assert int(rows.min()) >= 0 and int(rows.max()) < 1 << scale
    bits = torch.arange(scale)
    rb = (rows.long()[:, None] >> bits) & 1           # [E, S] quadrant bits
    cb = (cols.long()[:, None] >> bits) & 1
    quad = (2 * rb + cb).ravel()
    total = quad.numel()
    counts = torch.bincount(quad, minlength=4).double()
    for q, p in enumerate(tpl.GRAPH500):
        sigma = np.sqrt(total * p * (1 - p))
        assert abs(float(counts[q]) - total * p) <= 3 * sigma, (q, counts)


def test_degree_tail_exponent_near_reference():
    n, scale = 1 << 16, 12
    jr, _ = jpl.rmat_edges(jax.random.PRNGKey(0), n, scale)
    want = jpl.degree_tail_exponent(np.bincount(np.asarray(jr),
                                                minlength=1 << scale))
    rows, _ = tpl.rmat_edges(torch.Generator().manual_seed(0), n, scale)
    got = tpl.degree_tail_exponent(torch.bincount(rows.long(),
                                                  minlength=1 << scale))
    assert abs(got - want) < 0.05, (got, want)


def test_instance_streams_shapes():
    gen = torch.Generator().manual_seed(3)
    rows, cols, vals = tpl.instance_streams(gen, 3, 4, 16, scale=6)
    assert rows.shape == cols.shape == vals.shape == (3, 4, 16)
    assert rows.dtype == torch.int32 and vals.dtype == torch.float32
    assert bool((vals == 1).all())
    again = tpl.instance_streams(torch.Generator().manual_seed(3), 3, 4, 16,
                                 scale=6)
    assert torch.equal(rows, again[0]) and torch.equal(cols, again[1])
