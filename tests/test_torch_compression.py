"""Port parity of ``repro_torch.optim.compression`` (error-feedback int8
and top-k gradient compression) and ``repro_torch.data.pipeline``
(``ShardedStream``) against the JAX package on the same numpy inputs, on
the CPU.

Payloads are exact: int8 codes and scales, top-k indices (in
``lax.top_k``'s order: larger |g| first, the lower index first among
equal ones), values and shapes; wire bytes equal.  The inputs hold ties
in |g| and values exactly on a half step of the int8 grid (rounded half to
even by both packages).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.data import pipeline as jpipeline
from repro.optim import compression as jcomp
from repro_torch.data import pipeline as tpipeline
from repro_torch.models import common
from repro_torch.optim import compression as tcomp


def _grads():
    """Leaves with ties in |g| and half steps of the int8 grid, as numpy
    (grads, err)."""
    rng = np.random.default_rng(0)
    # max |g + e| = 127: the int8 scale is 1, and g + e = k + 0.5 lands on
    # a half step (2.5 -> 2, 3.5 -> 4, -0.5 -> -0, 1.5 -> 2)
    half = np.array([127.0, 2.5, 3.5, -0.5, 1.5, -2.5, 0.5, -126.5],
                    np.float32)
    ties = np.array([1.0, -1.0, 0.5, 1.0, -0.5, -1.0, 1.0, 0.25] * 8,
                    np.float32)
    normal = rng.standard_normal((6, 50)).astype(np.float32)
    grads = dict(half=half, layers=[dict(w=normal), dict(w=ties)],
                 zero=np.zeros((3, 4), np.float32))
    err = dict(half=np.zeros(8, np.float32),
               layers=[dict(w=(rng.standard_normal((6, 50)) * 0.1)
                            .astype(np.float32)),
                       dict(w=np.zeros(64, np.float32))],
               zero=np.zeros((3, 4), np.float32))
    return grads, err


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return common.tree_from_numpy(tree, "cpu")


def _payload_pairs(tp, jp):
    """(port payload, reference payload) leaf dicts, in leaf order."""
    if tcomp._is_payload(tp):
        return [(tp, jp)]
    if isinstance(tp, dict):
        assert tp.keys() == jp.keys()
        return [x for k in sorted(tp) for x in _payload_pairs(tp[k], jp[k])]
    return [x for a, b in zip(tp, jp) for x in _payload_pairs(a, b)]


@pytest.mark.parametrize("kind,frac", [("int8", 0.01), ("topk", 0.01),
                                       ("topk", 0.1), ("topk", 0.5)])
def test_compress_tree_matches_reference(kind, frac):
    """``compress_tree``'s payloads exactly, its new error and
    ``decompress_tree``/``roundtrip``'s output exactly, ``wire_bytes``
    equal; top-k at fractions whose k cuts through a run of ties."""
    grads, err = _grads()
    cfg = tcomp.CompressionConfig(kind, topk_frac=frac)
    jcfg = jcomp.CompressionConfig(kind, topk_frac=frac)
    jpay, jerr = jcomp.compress_tree(_jax(grads), _jax(err), jcfg)
    tpay, terr = tcomp.compress_tree(_torch(grads), _torch(err), cfg)
    pairs = _payload_pairs(tpay, jpay)
    assert len(pairs) == 4
    for t, j in pairs:
        assert t.keys() == j.keys()
        for k in t:
            if k == "shape":
                assert t[k] == tuple(j[k])
                continue
            want = np.asarray(j[k])
            assert t[k].numpy().dtype == want.dtype, k
            np.testing.assert_array_equal(t[k].numpy(), want, err_msg=k)
    for a, b in zip(common.tree_leaves(terr), jax.tree.leaves(jerr)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jdeq = jcomp.decompress_tree(jpay, jcfg)
    tdeq = tcomp.decompress_tree(tpay, cfg)
    for a, b in zip(common.tree_leaves(tdeq), jax.tree.leaves(jdeq)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rdeq, rerr = tcomp.roundtrip(_torch(grads), _torch(err), cfg)
    for a, b in zip(common.tree_leaves(rdeq) + common.tree_leaves(rerr),
                    common.tree_leaves(tdeq) + common.tree_leaves(terr)):
        assert torch.equal(a, b)
    assert tcomp.wire_bytes(tpay, cfg) == jcomp.wire_bytes(jpay, jcfg)


def test_int8_rounds_half_to_even_and_topk_keeps_the_lower_index():
    grads, err = _grads()
    cfg = tcomp.CompressionConfig("int8")
    pay, _ = tcomp.compress_tree(_torch(grads), _torch(err), cfg)
    assert float(pay["half"]["scale"]) == 1.0
    assert pay["half"]["q"].tolist() == [127, 2, 4, 0, 2, -2, 0, -126]
    assert tcomp.wire_bytes(pay["half"], cfg) == 8 + 4
    cfg = tcomp.CompressionConfig("topk", topk_frac=0.1)   # k = 6 of 64
    pay, _ = tcomp.compress_tree(_torch(grads), _torch(err), cfg)
    assert pay["layers"][1]["w"]["idx"].tolist() == [0, 1, 3, 5, 6, 8]
    assert pay["layers"][1]["w"]["idx"].dtype == torch.int32
    assert tcomp.wire_bytes(pay["layers"][1]["w"], cfg) == 8 * 6


def test_none_and_ef_init():
    grads, err = _grads()
    cfg = tcomp.CompressionConfig("none")
    g, e = _torch(grads), _torch(err)
    assert tcomp.compress_tree(g, e, cfg) == (g, e)
    assert tcomp.decompress_tree(g, cfg) is g
    assert tcomp.wire_bytes(g, cfg) == jcomp.wire_bytes(
        _jax(grads), jcomp.CompressionConfig("none"))
    z = tcomp.ef_init(dict(a=torch.ones(3, dtype=torch.bfloat16)))
    assert z["a"].dtype == torch.float32 and not z["a"].any()
    with pytest.raises(ValueError):
        tcomp.compress_tree(g, e, tcomp.CompressionConfig("fp4"))


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.sampled_from(["int8", "topk"]))
def test_compression_error_feedback_invariant(seed, kind):
    """decompressed + new_error == grads + old_error (mass conservation),
    as the reference's own property states it."""
    rng = np.random.default_rng(seed)
    g = dict(w=torch.from_numpy(rng.standard_normal(64).astype(np.float32)))
    err = dict(w=torch.from_numpy(
        (rng.standard_normal(64) * 0.1).astype(np.float32)))
    cfg = tcomp.CompressionConfig(kind, topk_frac=0.1)
    deq, new_err = tcomp.roundtrip(g, err, cfg)
    np.testing.assert_allclose((deq["w"] + new_err["w"]).numpy(),
                               (g["w"] + err["w"]).numpy(), rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------------------------- pipeline --

def test_sharded_stream_prefetch_and_error():
    """Batches come out in order; an error of the source iterator is
    raised on the consumer side (the reference's test, on the port)."""
    it = (dict(x=torch.ones(4) * i) for i in range(5))
    out = [float(b["x"][0]) for b in tpipeline.ShardedStream(it, prefetch=2)]
    assert out == [0, 1, 2, 3, 4]
    jit = (dict(x=jnp.ones((4,)) * i) for i in range(5))
    assert out == [float(b["x"][0])
                   for b in jpipeline.ShardedStream(jit, prefetch=2)]

    def bad():
        yield dict(x=torch.ones(2))
        raise RuntimeError("boom")
    s = tpipeline.ShardedStream(bad())
    next(s)
    with pytest.raises(RuntimeError, match="boom"):
        next(s)
        next(s)


def test_sharded_stream_places_batches():
    """With a device every tensor of a (nested) batch is moved there; with
    none the batch passes through as it is."""
    batch = dict(tokens=torch.arange(6).reshape(2, 3),
                 extra=[torch.zeros(2), 7])
    placed = next(tpipeline.ShardedStream(iter([batch]), device="cpu"))
    assert placed["tokens"].device == torch.device("cpu")
    assert torch.equal(placed["tokens"], batch["tokens"])
    assert placed["extra"][1] == 7
    same = next(tpipeline.ShardedStream(iter([batch])))
    assert same is batch
    meta = next(tpipeline.ShardedStream(iter([batch]), device="meta"))
    assert meta["tokens"].device.type == "meta"
    assert meta["extra"][0].device.type == "meta"
