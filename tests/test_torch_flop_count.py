"""The port's flop count against XLA's: ``stages.Compiled.cost_analysis()``
of a recorded call (``analysis/tracekit.py``: ``FlopCounterMode``'s table
for the matrix-class ops, ``op_cost``'s rules for the rest) gives the
``"flops"`` and ``"transcendentals"`` that
``jax.jit(f).lower(...).compile().cost_analysis()`` gives for the
reference's same function on the same numpy inputs, exactly (JAX's CPU
backend; a key XLA leaves out counts 0).

The cases are the op classes the rules cover: elementwise arithmetic,
compare, select, integer and bit ops, dtype conversion, transcendentals,
``integer_pow``, the composites (sigmoid, silu, softmax, log-softmax,
logsumexp), reductions, sorts and an integer ``topk`` (XLA lowers it to
the same sort; a float ``lax.top_k`` is a custom call XLA counts as -1),
a segment-sum scatter and the matrix product.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import stages
from repro_torch.analysis import tracekit

RNG = np.random.default_rng(0)
F128 = RNG.normal(size=(128, 64)).astype(np.float32)
G128 = RNG.normal(size=(128, 64)).astype(np.float32)
F8 = RNG.normal(size=(8, 1024)).astype(np.float32)
K8192 = RNG.integers(0, 1 << 20, 8192).astype(np.int32)
K4096 = RNG.integers(0, 1 << 20, 4096).astype(np.int32)
K8 = RNG.integers(0, 1 << 20, (8, 1024)).astype(np.int32)
POS = (np.abs(F128) + 0.5).astype(np.float32)
X6, Y6 = (RNG.normal(size=s).astype(np.float32) for s in ((6, 4), (4, 5)))
SEG = RNG.integers(0, 10, 100).astype(np.int32)
D100 = RNG.normal(size=100).astype(np.float32)

# name -> (port function, reference function, numpy inputs)
CASES = {
    # Motivation's table
    "add": (lambda a, b: a + b, lambda a, b: a + b, (F128, G128)),
    "mul_add": (lambda a, b: a * b + a, lambda a, b: a * b + a,
                (F128, G128)),
    "less": (lambda a, b: a < b, lambda a, b: a < b, (F128, G128)),
    "where": (lambda a: torch.where(a > 0, a, 0),
              lambda a: jnp.where(a > 0, a, 0), (F8,)),
    "int_add": (lambda k: k + 1, lambda k: k + 1, (K8192,)),
    "to_float": (lambda k: k.to(torch.float32),
                 lambda k: k.astype(jnp.float32), (K8192,)),
    "shift_or": (lambda k: (k << 3) | 1, lambda k: (k << 3) | 1, (K8192,)),
    "exp": (torch.exp, jnp.exp, (F128,)),
    "sum": (lambda a: a.sum(), lambda a: a.sum(), (F128,)),
    "max_axis1": (lambda a: a.amax(dim=1), lambda a: a.max(axis=1),
                  (F128,)),
    "sort_int": (lambda k: torch.sort(k).values, jnp.sort, (K4096,)),
    "sort_axis1": (lambda a: torch.sort(a, dim=1).values,
                   lambda a: jnp.sort(a, axis=1), (F8,)),
    "argsort_axis1": (lambda a: torch.argsort(a, dim=1),
                      lambda a: jnp.argsort(a, axis=1), (F8,)),
    "matmul": (lambda a, b: a @ b.T, lambda a, b: a @ b.T, (F128, G128)),
    # the other classes
    "relu_matmul": (lambda x, y: (x @ y).relu(),
                    lambda x, y: jnp.maximum(x @ y, 0), (X6, Y6)),
    "mean_axis1": (lambda a: a.mean(dim=1), lambda a: a.mean(axis=1),
                   (F128,)),
    "any_axis1": (lambda a: (a > 0).any(dim=1),
                  lambda a: (a > 0).any(axis=1), (F128,)),
    "var_axis1": (lambda a: a.var(dim=1, correction=0),
                  lambda a: a.var(axis=1), (F128,)),
    "clamp": (lambda a: a.clamp(0, 1), lambda a: jnp.clip(a, 0, 1),
              (F128,)),
    "tanh": (torch.tanh, jnp.tanh, (F128,)),
    "rsqrt": (torch.rsqrt, jax.lax.rsqrt, (POS,)),
    "square": (lambda a: a ** 2, lambda a: a ** 2, (F128,)),
    "cube": (lambda a: a ** 3, lambda a: a ** 3, (F128,)),
    "sqrt_pow": (lambda a: a ** 0.5, lambda a: a ** 0.5, (POS,)),
    "sigmoid": (torch.sigmoid, jax.nn.sigmoid, (F128,)),
    "silu": (torch.nn.functional.silu, jax.nn.silu, (F128,)),
    "softmax": (lambda a: torch.softmax(a, dim=1),
                lambda a: jax.nn.softmax(a, axis=1), (F128,)),
    "log_softmax": (lambda a: torch.log_softmax(a, dim=1),
                    lambda a: jax.nn.log_softmax(a, axis=1), (F128,)),
    "logsumexp": (lambda a: torch.logsumexp(a, dim=1),
                  lambda a: jax.nn.logsumexp(a, axis=1), (F128,)),
    "topk_int": (lambda k: torch.topk(k, 8, dim=1),
                 lambda k: jax.lax.top_k(k, 8), (K8,)),
    "segment_sum": (
        lambda d, s: torch.zeros(10).index_add(0, s, d),
        lambda d, s: jax.ops.segment_sum(d, s, num_segments=10),
        (D100, SEG)),
}


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def port_cost(name, fn, args) -> dict:
    args = tuple(torch.from_numpy(a) for a in args)
    w = stages.wrap(fn, f"test.flops.{name}",
                    stages.signature_of(extra=(("case", name),)))
    comp = w.lower(*args).compile()
    tracekit.record_compiled(comp, args)
    return comp.cost_analysis()


def reference_cost(fn, args) -> dict:
    cost = jax.jit(fn).lower(*(jnp.asarray(a) for a in args)).compile() \
        .cost_analysis()
    if isinstance(cost, list):          # older JAX: one dict a module
        cost = cost[0]
    return cost


@pytest.mark.parametrize("name", list(CASES))
def test_flops_and_transcendentals_equal_xla(name):
    fn, jfn, args = CASES[name]
    got, want = port_cost(name, fn, args), reference_cost(jfn, args)
    for key in ("flops", "transcendentals"):
        assert got[key] == (want.get(key) or 0.0), (key, got, want)


def test_views_gathers_copies_and_fills_count_no_flop():
    """The ops that compute nothing: views, a gather, a copy, ``cat``,
    fills."""
    a = torch.from_numpy(F128)
    idx = torch.arange(0, 64, 2)

    def moves(x):
        y = x.t().reshape(64, 128)[:, idx]
        return torch.cat([y, y.clone()]), torch.zeros_like(x).fill_(2.0)

    assert port_cost("moves", moves, (F128,))["flops"] == 0
    assert torch.equal(moves(a)[1], torch.full_like(a, 2.0))
