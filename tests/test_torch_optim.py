"""Port parity of ``repro_torch.optim``: AdamW (the in-place update against
the reference's functional one, with and without clipping, with a
schedule), ``clip_by_global_norm`` and ``warmup_cosine`` within rtol 1e-6;
``SparseAccumulator`` against ``repro.optim.sparse_update`` — keys, nnz,
spills and the counter exact, integer-valued payloads exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim.sparse_update import SparseAccumulator as JAcc
from repro_torch.models import common
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.sparse_update import SparseAccumulator as TAcc

RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def _tree(rng, scale=1.0):
    """A nested dict/list pytree of float32 numpy arrays, with a 0-d leaf
    and keys out of sorted order."""
    f = lambda *s: np.asarray(scale * rng.normal(size=s), np.float32)
    return dict(zeta=f(7, 3), layers=[dict(w=f(3, 4), b=f(4)),
                                      dict(w=f(4, 2), b=f(2))],
                alpha=f(), table=f(50, 8))


def _to_torch(tree):
    return common.tree_unflatten(tree, [torch.from_numpy(np.array(x))
                                        for x in jax.tree.leaves(tree)])


def _close(got, want, rtol=RTOL, what=""):
    g, w = common.tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=1e-7, err_msg=what)


def test_tree_order_is_the_jax_order():
    tree = _tree(np.random.default_rng(0))
    got = [tuple(x.shape) for x in common.tree_leaves(_to_torch(tree))]
    assert got == [x.shape for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("clip_norm,grad_scale", [(1.0, 10.0), (1e3, 1.0)])
def test_adamw_update_matches_reference(clip_norm, grad_scale):
    """Four steps, the first three at the config's lr, the last at a
    schedule's lr tensor: params, moments and gnorm within rtol 1e-6, the
    count int32 and exact."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    cfg = dict(lr=1e-2, weight_decay=0.1, clip_norm=clip_norm)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
    jp = jax.tree.map(jnp.asarray, params)
    js = jadamw.adamw_init(jp)
    tp = _to_torch(params)
    ts = tadamw.adamw_init(tp)
    assert ts["count"].dtype == torch.int32 and ts["count"].dim() == 0
    for i in range(4):
        grads = _tree(rng, grad_scale)
        lr = None
        if i == 3:
            lr = jadamw.warmup_cosine(jnp.int32(5), peak_lr=1e-2, warmup=2,
                                      total=10)
        jp, js, jg = jadamw.adamw_update(jax.tree.map(jnp.asarray, grads),
                                         js, jp, jcfg, lr=lr)
        tlr = None if lr is None else tadamw.warmup_cosine(
            torch.tensor(5, dtype=torch.int32), peak_lr=1e-2, warmup=2,
            total=10)
        tp, ts, tg = tadamw.adamw_update(_to_torch(grads), ts, tp, tcfg,
                                         lr=tlr)
        np.testing.assert_allclose(float(tg), float(jg), rtol=RTOL)
    _close(tp, jp, what="params")
    _close(ts["m"], js["m"], what="m")
    _close(ts["v"], js["v"], what="v")
    assert int(ts["count"]) == int(js["count"]) == 4
    assert ts["count"].dtype == torch.int32


def test_adamw_update_in_slices_equals_whole(monkeypatch):
    """The in-place update in slices of CHUNK elements is the same
    arithmetic as one pass."""
    rng = np.random.default_rng(2)
    params, grads = _tree(rng), _tree(rng)
    outs = []
    for chunk in (tadamw.CHUNK, 7):
        monkeypatch.setattr(tadamw, "CHUNK", chunk)
        tp = _to_torch(params)
        ts = tadamw.adamw_init(tp)
        tadamw.adamw_update(_to_torch(grads), ts, tp, tadamw.AdamWConfig())
        outs.append(common.tree_leaves(tp))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(3)
    grads = _tree(rng, 5.0)
    jg, jn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), 1.0)
    tg, tn = tadamw.clip_by_global_norm(_to_torch(grads), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    _close(tg, jg)
    total = torch.sqrt(sum(torch.sum(x * x) for x in common.tree_leaves(tg)))
    np.testing.assert_allclose(float(total), 1.0, rtol=1e-5)


def test_apply_updates_matches_reference():
    rng = np.random.default_rng(4)
    params, upd = _tree(rng), _tree(rng)
    want = jadamw.apply_updates(jax.tree.map(jnp.asarray, params),
                                jax.tree.map(jnp.asarray, upd))
    tp = _to_torch(params)
    assert tadamw.apply_updates(tp, _to_torch(upd)) is tp
    _close(tp, want)


@pytest.mark.parametrize("step_type", ["int", "tensor"])
def test_warmup_cosine_matches_reference(step_type):
    kw = dict(peak_lr=3e-4, warmup=7, total=50, floor=0.1)
    for s in range(0, 56):
        js = s if step_type == "int" else jnp.int32(s)
        ts = s if step_type == "int" else torch.tensor(s, dtype=torch.int32)
        got = tadamw.warmup_cosine(ts, **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got),
                                   float(jadamw.warmup_cosine(js, **kw)),
                                   rtol=RTOL)


# ------------------------------------------------------ SparseAccumulator --

def _acc_equal(tacc, jacc, exact=True):
    for tl, jl in zip(tacc.hier.layers, jacc.hier.layers):
        np.testing.assert_array_equal(tl.key.numpy(), np.asarray(jl.key))
        np.testing.assert_array_equal(tl.nnz.numpy(), np.asarray(jl.nnz))
        if exact:
            np.testing.assert_array_equal(tl.val.numpy(), np.asarray(jl.val))
        else:
            np.testing.assert_allclose(tl.val.numpy(), np.asarray(jl.val),
                                       rtol=1e-4, atol=1e-6)
    for f in ("spills", "overflow", "n_updates"):
        np.testing.assert_array_equal(getattr(tacc.hier, f).numpy(),
                                      np.asarray(getattr(jacc.hier, f)))


@pytest.mark.parametrize("integer_vals", [True, False])
def test_sparse_accumulator_matches_reference(integer_vals):
    """Blocks added with and without masks; ``pending``/``pressured``
    agree after every add; ``apply_if_pressured`` drains exactly when the
    reference does; a final ``drain`` and ``snapshot`` agree."""
    rng = np.random.default_rng(5)
    cuts, block, dim = (6, 20), 12, 3
    jacc = JAcc.create(cuts, block, dim)
    tacc = TAcc.create(cuts, block, dim, device="cpu")
    jtab = np.zeros((40, dim), np.float32)
    ttab = torch.zeros((40, dim))
    drains = 0
    jadd = jax.jit(lambda acc, k, v, m: acc.add(k, v, m))
    japply = jax.jit(lambda acc, t: acc.apply_if_pressured(t, -0.5))
    for i in range(10):
        keys = rng.integers(0, 40, block).astype(np.int32)
        vals = (rng.integers(-3, 4, (block, dim)) if integer_vals
                else rng.normal(size=(block, dim))).astype(np.float32)
        mask = rng.random(block) < 0.8 if i % 2 else None
        jacc = jadd(jacc, jnp.asarray(keys), jnp.asarray(vals),
                    None if mask is None else jnp.asarray(mask))
        tacc = tacc.add(torch.from_numpy(keys), torch.from_numpy(vals),
                        None if mask is None else torch.from_numpy(mask))
        _acc_equal(tacc, jacc, integer_vals)
        assert int(tacc.pending()) == int(jacc.pending())
        assert tacc.pending().dtype == torch.int32
        assert bool(tacc.pressured()) == bool(jacc.pressured())
        drains += bool(jacc.pressured())
        jacc, jt = japply(jacc, jnp.asarray(jtab))
        jtab = np.asarray(jt)
        tacc, ttab = tacc.apply_if_pressured(ttab, -0.5)
        np.testing.assert_allclose(ttab.numpy(), jtab, rtol=1e-4, atol=1e-6)
    assert drains > 0
    jsnap, tsnap = jacc.snapshot(), tacc.snapshot()
    np.testing.assert_array_equal(tsnap.key.numpy(), np.asarray(jsnap.key))
    np.testing.assert_array_equal(tsnap.nnz.numpy(), np.asarray(jsnap.nnz))
    jacc, jt = jacc.drain(jnp.asarray(jtab), 2.0)
    tacc, ttab = tacc.drain(ttab, 2.0)
    np.testing.assert_allclose(ttab.numpy(), np.asarray(jt), rtol=1e-4,
                               atol=1e-6)
    assert int(tacc.pending()) == int(jacc.pending()) == 0
