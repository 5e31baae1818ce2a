"""Port parity: the configs, shape tables and registry against the JAX
package's, and DCN-v2 serving — ``serve_scores`` with the embedding_bag
kernel route on and off, ``retrieval_topk`` and the parameter converters —
against ``repro.models.dcn`` on the same JAX-initialised weights and the
same numpy batch, on the CPU (where the kernel wrapper runs its plain
version).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jcfg
from repro.models import dcn as jdcn
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as tcfg
from repro_torch.data import synthetic
from repro_torch.kernels import registry as treg
from repro_torch.models import dcn as tdcn

SCORE_RTOL = 1e-5   # f32 matmuls of the cross network / MLP, other order


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


# ----------------------------------------------------------------- configs --

@pytest.mark.parametrize("arch", sorted(tcfg.ARCHS))
def test_configs_equal_the_reference(arch):
    assert tcfg.family(arch) == jcfg.family(arch)
    for get in ("get_smoke_config", "get_config"):
        t, j = getattr(tcfg, get)(arch), getattr(jcfg, get)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        props = dict(recsys=("total_rows", "padded_rows", "d_interact"),
                     lm=("n_params", "n_active_params")).get(t.family, ())
        for prop in props:
            assert getattr(t, prop) == getattr(j, prop)


def test_shape_tables_and_registry():
    assert tbase.GNN_SHAPES == jbase.GNN_SHAPES
    assert tbase.RECSYS_SHAPES == jbase.RECSYS_SHAPES
    assert tbase.LM_SHAPES == jbase.LM_SHAPES
    assert tbase.SHAPES_BY_FAMILY == jbase.SHAPES_BY_FAMILY
    for fam in ("lm", "gnn", "recsys"):
        assert tcfg.list_archs(fam) == jcfg.list_archs(fam)
    assert tcfg.list_archs() == jcfg.list_archs()
    assert not hasattr(tcfg, "NOT_PORTED")
    with pytest.raises(ValueError, match="unknown arch"):
        tcfg.get_config("no-such-arch")
    assert tcfg.get_config("dcn-v2").padded_rows == 94_306_304


# ------------------------------------------------------------------- model --

def _cfg(use_kernel: bool):
    return dataclasses.replace(tcfg.get_smoke_config("dcn-v2"),
                               use_kernel=use_kernel)


def _jax_params(seed=0):
    cfg = jcfg.get_smoke_config("dcn-v2")
    return jax.tree.map(np.asarray, jdcn.init(jax.random.PRNGKey(seed), cfg))


def _batch(seed, b, hot=None):
    cfg = _cfg(False)
    rng = np.random.default_rng(seed)
    shape = (b, cfg.n_sparse) if hot is None else (b, cfg.n_sparse, hot)
    # ids past each field's vocab and below 0 exercise the modulo
    return dict(dense=rng.normal(size=(b, cfg.n_dense)).astype(np.float32),
                sparse=rng.integers(-2000, 5000, shape).astype(np.int32))


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def test_converters_round_trip_and_names():
    tree = _jax_params()
    params = tdcn.params_from_numpy(tree, _cfg(True), device="cpu")
    back = tdcn.params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    names = dict(params.named_parameters())
    assert {"table", "cross.0.w", "cross.1.b", "mlp.1.w", "logit_w",
            "logit_b"} <= set(names)
    assert names["logit_b"].dim() == 0
    assert not any(p.requires_grad for p in names.values())
    # the port's own init draws the same shapes
    own = tdcn.params_to_numpy(tdcn.init(0, _cfg(True), device="cpu"))
    assert jax.tree.map(np.shape, own) == jax.tree.map(np.shape, tree)
    with pytest.raises(ValueError, match="do not match"):
        tdcn.params_from_numpy(
            dict(tree, logit_w=np.zeros((3, 1), np.float32)), _cfg(True),
            device="cpu")


@pytest.mark.parametrize("use_kernel", [True, False])
def test_serve_scores_matches_reference(use_kernel):
    """Embeddings exact (one id per field), scores within rtol 1e-5; the
    reference runs its own route with the same switch (the Pallas kernel
    in interpret mode when on)."""
    tree = _jax_params()
    jcfg_ = dataclasses.replace(jcfg.get_smoke_config("dcn-v2"),
                                use_kernel=use_kernel)
    cfg = _cfg(use_kernel)
    jb, tb = _both(_batch(1, 8))
    params = tdcn.params_from_numpy(tree, cfg, device="cpu")
    want_emb = jdcn.embed_lookup(jnp.asarray(tree["table"]), jb["sparse"],
                                 jcfg_)
    treg.reset_launches()
    got_emb = tdcn.embed_lookup(params.table, tb["sparse"], cfg)
    np.testing.assert_array_equal(got_emb.numpy(), np.asarray(want_emb))
    want = jdcn.serve_scores(jax.tree.map(jnp.asarray, tree), jb, jcfg_)
    got = tdcn.serve_scores(params, tb, cfg)
    assert got.shape == (8,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=SCORE_RTOL)
    assert treg.launches()["embedding_bag.embedding_bag"] == 0   # CPU


def test_multi_hot_lookup_matches_reference():
    tree = _jax_params(1)
    jb, tb = _both(_batch(2, 6, hot=3))
    want = jdcn.embed_lookup(jnp.asarray(tree["table"]), jb["sparse"],
                             jcfg.get_smoke_config("dcn-v2"))
    for use_kernel in (True, False):
        got = tdcn.embed_lookup(torch.from_numpy(np.array(tree["table"])),
                                tb["sparse"], _cfg(use_kernel))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_retrieval_topk_matches_reference():
    tree = _jax_params(2)
    cfg = _cfg(True)
    jb, tb = _both(_batch(3, 2))
    cands = np.random.default_rng(4).normal(
        size=(1000, cfg.mlp[-1])).astype(np.float32)
    want_v, want_i = jdcn.retrieval_topk(
        jax.tree.map(jnp.asarray, tree), jb, jnp.asarray(cands),
        jcfg.get_smoke_config("dcn-v2"), k=20)
    got_v, got_i = tdcn.retrieval_topk(
        tdcn.params_from_numpy(tree, cfg, device="cpu"), tb,
        torch.from_numpy(cands), cfg, k=20)
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    assert got_i.dtype == torch.int32 and got_v.shape == want_v.shape
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=SCORE_RTOL)
    # an index is determined where its value is separated from both
    # neighbours by more than the tolerance
    gap = np.abs(np.diff(want_v, axis=1)) > 1e-4 * np.abs(want_v[:, 1:])
    sep = np.ones_like(want_v, bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    assert sep.sum() > want_v.size // 2
    np.testing.assert_array_equal(got_i.numpy()[sep], want_i[sep])


def test_recsys_batch_formulas():
    """The port's batch maker: shapes, dtypes, ids in [0, V), labels 0/1,
    the same for the same seed."""
    b = synthetic.recsys_batch(3, 64, vocab_per_field=1000, multi_hot=2,
                               device="cpu")
    assert b["dense"].shape == (64, 13) and b["dense"].dtype == torch.float32
    assert b["sparse"].shape == (64, 26, 2)
    assert b["sparse"].dtype == torch.int32
    assert int(b["sparse"].min()) >= 0 and int(b["sparse"].max()) < 1000
    assert set(b["labels"].unique().tolist()) <= {0.0, 1.0}
    again = synthetic.recsys_batch(3, 64, vocab_per_field=1000, multi_hot=2,
                                   device="cpu")
    assert all(torch.equal(b[k], again[k]) for k in b)
    r = synthetic.retrieval_batch(1, 2, 50, 16, device="cpu")
    assert r["query"].shape == (2, 16) and r["candidates"].shape == (50, 16)


def test_recsys_stream_matches_reference_shape():
    """``recsys_stream``: as many batches as the reference's, with its keys,
    shapes and dtypes, step i equal to ``recsys_batch`` of the seed
    ``(seed << 32) | i`` (the port's fold-in), and the steps differ."""
    from repro.data import synthetic as jsyn
    kw = dict(n_dense=5, n_sparse=3, vocab_per_field=100, multi_hot=2)
    want = list(jsyn.recsys_stream(jax.random.PRNGKey(4), 3, 8, **kw))
    got = list(synthetic.recsys_stream(4, 3, 8, device="cpu", **kw))
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for k in w:
            assert tuple(g[k].shape) == tuple(w[k].shape), k
            assert str(g[k].dtype).removeprefix("torch.") == \
                np.asarray(w[k]).dtype.name, k
        one = synthetic.recsys_batch((4 << 32) | i, 8, device="cpu", **kw)
        assert all(torch.equal(g[k], one[k]) for k in g)
    assert not torch.equal(got[0]["dense"], got[1]["dense"])
