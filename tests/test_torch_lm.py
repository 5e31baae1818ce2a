"""Port parity of the LM family's serving half: ``repro_torch.models``'
attention, MoE and transformer against ``repro.models``' on the same numpy
inputs and the same JAX-initialised weights (``params_from_numpy``), on
the CPU, for every LM arch's ``smoke_config()``.

Float32 tolerances: a module's outputs within rtol 1e-5 / atol 1e-5;
logits and caches of a whole prefill or decode step within rtol 1e-4 /
atol 1e-5; greedy tokens, MoE expert ids, capacity slots and kept masks
exact.  A bfloat16 smoke run of a dense arch holds its logits within
2e-2.  The parameter shapes and counts of every full ``config()`` are held
against the reference's (abstractly: nothing of full size is drawn).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jcfg
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch.configs import registry as tcfg
from repro_torch.models import attention as tattn
from repro_torch.models import common
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf

LM_ARCHS = ("deepseek-v2-236b", "granite-moe-3b-a800m", "mistral-nemo-12b",
            "phi3-mini-3.8b", "smollm-360m")
MOD = dict(rtol=1e-5, atol=1e-5)      # one module, float32
WHOLE = dict(rtol=1e-4, atol=1e-5)    # a whole prefill / decode step
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def _t(x):
    return common.tree_from_numpy(jax.tree.map(np.asarray, x), "cpu")


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **tol)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_lm_archs_are_the_references():
    assert tcfg.list_archs("lm") == list(LM_ARCHS) == jcfg.list_archs("lm")


# ----------------------------------------------------------------- common --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_common_helpers(dtype):
    """rms_norm and apply_rope compute in float32 and cast back; swiglu
    stays in the input dtype; embed_init draws N(0, 0.02**2)."""
    from repro.models import common as jcommon
    rng = np.random.default_rng(0)
    x, scale = _rand(rng, 3, 5, 16), _rand(rng, 16)
    pos = rng.integers(0, 1000, (3, 5)).astype(np.int32)
    w = [_rand(rng, 16, 8), _rand(rng, 16, 8), _rand(rng, 8, 16)]
    jx = jnp.asarray(x, dtype)
    tx = _t(jx)
    for got, want in (
            (common.rms_norm(tx, torch.from_numpy(scale)),
             jcommon.rms_norm(jx, scale)),
            (common.apply_rope(tx, torch.from_numpy(pos), 1e4),
             jcommon.apply_rope(jx, pos, 1e4)),
            (common.swiglu(tx, *(_t(jnp.asarray(a, dtype)) for a in w)),
             jcommon.swiglu(jx, *(jnp.asarray(a, dtype) for a in w)))):
        assert str(got.dtype) == f"torch.{want.dtype}"
        want = np.asarray(want, np.float32)
        # bf16: each rounding of an intermediate is relative to the output's
        # scale, so the tolerance is too
        tol = MOD if dtype == "float32" else dict(
            rtol=1e-2, atol=1e-2 * float(np.abs(want).max()))
        _close(got, want, tol)
    _close(common.rope_freqs(16, 1e6), jcommon.rope_freqs(16, 1e6), MOD)
    e = common.embed_init(torch.Generator().manual_seed(0), 4000, 8)
    assert e.shape == (4000, 8) and abs(float(e.std()) - 0.02) < 1e-3


# -------------------------------------------------------------- attention --

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_offset", [0, 5])
def test_chunked_attention(causal, q_offset):
    """Four KV chunks of 8; with q_offset the causal mask leaves some
    chunks fully masked for early queries."""
    rng = np.random.default_rng(1)
    q, k, v = (_rand(rng, 2, 2, 3, 8, 16), _rand(rng, 2, 2, 32, 16),
               _rand(rng, 2, 2, 32, 12))
    want = jattn.chunked_attention(q, k, v, causal=causal, chunk=8,
                                   q_offset=q_offset)
    got = tattn.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal, chunk=8, q_offset=q_offset)
    assert got.shape == want.shape
    _close(got, want, MOD)
    with pytest.raises(AssertionError):
        tattn.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=causal, chunk=12)


@pytest.mark.parametrize("cache_len", [7, (3, 11)])
def test_decode_attention(cache_len):
    rng = np.random.default_rng(2)
    q, kc, vc = (_rand(rng, 2, 2, 3, 16), _rand(rng, 2, 2, 12, 16),
                 _rand(rng, 2, 2, 12, 8))
    jl = jnp.asarray(cache_len, jnp.int32) if isinstance(cache_len, tuple) \
        else cache_len
    tl = torch.tensor(cache_len) if isinstance(cache_len, tuple) \
        else cache_len
    want = jattn.decode_attention(q, kc, vc, jl)
    got = tattn.decode_attention(*map(torch.from_numpy, (q, kc, vc)), tl)
    _close(got, want, MOD)


def _attn_args(cfg):
    if cfg.attn == "mla":
        return dict(cfg=ttf.mla_config(cfg))
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                d_head=cfg.d_head, rope_theta=cfg.rope_theta)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_attention_forward_and_decode(arch):
    """GQA (MHA for phi3) or MLA: the full path's output and cache entries,
    then decode steps into a cache of 10 — at a position inside it, and at
    cache_len = max_len, where the write clamps to the last slot."""
    cfg = jcfg.get_smoke_config(arch)
    rng = np.random.default_rng(3)
    b, s, max_len = 2, 8, 10
    x = _rand(rng, b, s, cfg.d_model)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    if cfg.attn == "mla":
        mcfg = jtf.mla_config(cfg)
        jp = jattn.mla_init(KEY, mcfg)
        want, (c1, c2) = jattn.mla_forward(jp, x, mcfg, pos, chunk=4)
        got, (g1, g2) = tattn.mla_forward(_t(jp), torch.from_numpy(x),
                                          ttf.mla_config(cfg),
                                          torch.from_numpy(pos), chunk=4)
        names, axis = ("c_kv", "k_rope"), 1
        jdec, tdec = jattn.mla_decode, tattn.mla_decode
    else:
        kw = _attn_args(cfg)
        jp = jattn.gqa_init(KEY, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.d_head)
        want, (c1, c2) = jattn.gqa_forward(jp, x, positions=pos, chunk=4,
                                           **kw)
        got, (g1, g2) = tattn.gqa_forward(_t(jp), torch.from_numpy(x),
                                          positions=torch.from_numpy(pos),
                                          chunk=4, **kw)
        names, axis = ("k", "v"), 2
        jdec, tdec = jattn.gqa_decode, tattn.gqa_decode
    _close(got, want, MOD, "out")
    _close(g1, c1, MOD, names[0])
    _close(g2, c2, MOD, names[1])
    gen = torch.Generator().manual_seed(0)
    mine = tattn.mla_init(gen, ttf.mla_config(cfg)) if cfg.attn == "mla" \
        else tattn.gqa_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.d_head)
    assert common.shapes(mine) == common.shapes(jp)

    def padded(c):
        widths = [(0, 0)] * c.ndim
        widths[axis] = (0, max_len - s)
        return np.pad(np.asarray(c), widths)
    jcache = {n: jnp.asarray(padded(c)) for n, c in zip(names, (c1, c2))}
    tcache = {n: torch.from_numpy(padded(c).copy())
              for n, c in zip(names, (c1, c2))}
    for step, cache_len in enumerate((s, s + 1, max_len)):
        xd = _rand(rng, b, 1, cfg.d_model)
        if cfg.attn == "mla":
            want, jcache = jdec(jp, xd, jcache, cache_len, mcfg)
            got, tcache = tdec(_t(jp), torch.from_numpy(xd), tcache,
                               cache_len, ttf.mla_config(cfg))
        else:
            want, jcache = jdec(jp, xd, jcache, cache_len, **kw)
            got, tcache = tdec(_t(jp), torch.from_numpy(xd), tcache,
                               cache_len, **kw)
        _close(got, want, MOD, f"decode {step}")
        for n in names:
            _close(tcache[n], jcache[n], MOD, f"decode {step} {n}")


# -------------------------------------------------------------------- MoE --

def _slots_by_loop(gate_idx: np.ndarray, n_experts: int, cap: int):
    """Each (token, k) pair's slot, counted in flattened pair order, and
    whether it fits under the capacity: a plain loop."""
    count = np.zeros(n_experts, np.int64)
    slots = []
    for e in gate_idx.reshape(-1):
        slots.append(count[e])
        count[e] += 1
    slots = np.array(slots)
    return slots, slots < cap


def _recorded_moe(monkeypatch, p, x, cfg):
    """The reference's moe_forward, recording its top-k (values, ids) and
    its [E, C] slot table (the argument of its second ``constrain``)."""
    seen = dict(constrain=[], top_k=[])
    top_k = jax.lax.top_k

    def rec_top_k(a, k):
        out = top_k(a, k)
        seen["top_k"].append(out)
        return out

    def rec_constrain(a, *spec, **kw):
        seen["constrain"].append(a)
        return a
    monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
    monkeypatch.setattr(jmoe, "constrain", rec_constrain)
    out, aux = jmoe.moe_forward(p, x, cfg)
    monkeypatch.undo()
    return out, aux, seen["top_k"][0][1], seen["constrain"][1]


@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("capacity_factor", [0.25, 8.0])
def test_moe_forward_routing_exact(monkeypatch, n_shared, capacity_factor):
    """Output and aux loss within rtol; expert ids, the slot table, the
    slots and the kept masks exact, with capacity 8 of 25 pairs an expert
    (capacity_factor 0.25: pairs drop) and with no drops."""
    cfg = jmoe.MoEConfig(d_model=24, d_ff_expert=32, n_experts=5, top_k=2,
                         n_shared=n_shared, capacity_factor=capacity_factor)
    tcf = tmoe.MoEConfig(**dataclasses.asdict(cfg))
    jp = jmoe.moe_init(KEY, cfg)
    mine = tmoe.moe_init(torch.Generator().manual_seed(0), tcf)
    assert common.shapes(mine) == common.shapes(jp)
    x = _rand(np.random.default_rng(4), 2, 32, 24)
    want, want_aux, gate_idx, slot_token = _recorded_moe(monkeypatch, jp, x,
                                                         cfg)
    p = _t(jp)
    got, aux = tmoe.moe_forward(p, torch.from_numpy(x), tcf)
    _close(got, want, MOD, "out")
    _close(aux, want_aux, MOD, "aux")

    t, cap = 64, tmoe._capacity(64, tcf)
    assert cap == jmoe._capacity(t, cfg)
    r = tmoe.route(p["router"], torch.from_numpy(x).reshape(t, 24), tcf, cap)
    np.testing.assert_array_equal(r.gate_idx.numpy(), np.asarray(gate_idx))
    np.testing.assert_array_equal(r.slot_token.numpy(),
                                  np.asarray(slot_token))
    slots, keep = _slots_by_loop(np.asarray(gate_idx), 5, cap)
    np.testing.assert_array_equal(r.slot_of.numpy(), slots)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert keep.all() == (capacity_factor == 8.0)


def test_moe_bf16_routing_and_ties(monkeypatch):
    """bfloat16 weights: the router's product is rounded to bf16 before
    the float32 softmax, so rows hold equal probabilities; equal ones rank
    the lower expert id first, as ``lax.top_k`` ranks them."""
    cfg = jmoe.MoEConfig(d_model=16, d_ff_expert=16, n_experts=8, top_k=3,
                         capacity_factor=1.0)
    tcf = tmoe.MoEConfig(**dataclasses.asdict(cfg))
    jp = jmoe.moe_init(KEY, cfg, jnp.bfloat16)
    rng = np.random.default_rng(5)
    x = jnp.asarray(_rand(rng, 4, 32, 16), jnp.bfloat16)
    # duplicate router columns: experts 2 and 5, 1 and 6 tie on every token
    router = np.array(jp["router"])
    router[:, 5], router[:, 6] = router[:, 2], router[:, 1]
    jp = dict(jp, router=jnp.asarray(router))
    want, _, gate_idx, slot_token = _recorded_moe(monkeypatch, jp, x, cfg)
    p = _t(jp)
    xt = _t(x)
    got, _ = tmoe.moe_forward(p, xt, tcf)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), dict(rtol=2e-2, atol=2e-2))
    cap = tmoe._capacity(128, tcf)
    r = tmoe.route(p["router"], xt.reshape(128, 16), tcf, cap)
    np.testing.assert_array_equal(r.gate_idx.numpy(), np.asarray(gate_idx))
    np.testing.assert_array_equal(r.slot_token.numpy(),
                                  np.asarray(slot_token))
    both = np.isin(r.gate_idx.numpy(), (2, 5)).sum(-1) == 2
    assert both.any()
    assert (np.argmax(r.gate_idx.numpy() == 2, -1)
            < np.argmax(r.gate_idx.numpy() == 5, -1))[both].all()


# ------------------------------------------------------------ transformer --

def _models(arch, **over):
    cfg = dataclasses.replace(jcfg.get_smoke_config(arch), **over)
    tcf = dataclasses.replace(tcfg.get_smoke_config(arch), **over)
    jp = jtf.init(KEY, cfg)
    return cfg, tcf, jp, ttf.params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("microbatch", [0, 2])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_decode(arch, microbatch):
    """Prefill of [4, 16] prompts into a cache of 20, then 5 greedy decode
    steps (the fifth at cache_len = max_len, where the write clamps):
    logits and every cache leaf within rtol 1e-4, the greedy tokens and
    cache_len exact; with ``prefill_microbatch=2`` the batch runs in two
    chunks."""
    cfg, tcf, jp, tp = _models(arch, prefill_microbatch=microbatch)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (4, 16)
                                             ).astype(np.int32)
    jl, jc, jn = jtf.prefill(jp, jnp.asarray(toks), cfg, max_len=20)
    tl, tc, tn = ttf.prefill(tp, torch.from_numpy(toks), tcf, max_len=20)
    assert tn == int(jn) == 16
    _close(tl, jl, WHOLE, "prefill logits")
    assert tc.keys() == jc.keys()
    for k in jc:
        assert tc[k].shape == jc[k].shape and tc[k].dtype == torch.float32
        _close(tc[k], jc[k], WHOLE, f"prefill cache {k}")
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = torch.argmax(tl, -1).to(torch.int32)
    for cache_len in (16, 17, 18, 19, 20):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = jtf.decode_step(jp, jtok[:, None], jc, cache_len, cfg)
        tl, tc = ttf.decode_step(tp, ttok[:, None], tc, cache_len, tcf)
        _close(tl, jl, WHOLE, f"decode logits at {cache_len}")
        for k in jc:
            _close(tc[k], jc[k], WHOLE, f"decode cache {k} at {cache_len}")
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = torch.argmax(tl, -1).to(torch.int32)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_and_decode_matches_forward(arch):
    """``forward``'s logits and aux against the reference's; and, with
    capacity_factor 8 (no drops), two decode steps after a prefill of
    S - 2 tokens equal forward's last two positions (the reference's own
    self-consistency check, run on the port)."""
    cfg, tcf, jp, tp = _models(arch, capacity_factor=8.0)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 12)
                                             ).astype(np.int32)
    jl, jaux = jtf.forward(jp, jnp.asarray(toks), cfg)
    full, aux = ttf.forward(tp, torch.from_numpy(toks), tcf)
    _close(full, jl, WHOLE, "forward logits")
    _close(aux, jaux, MOD, "aux")
    t = torch.from_numpy(toks)
    _, cache, n = ttf.prefill(tp, t[:, :10], tcf, max_len=12)
    l1, cache = ttf.decode_step(tp, t[:, 10:11], cache, n, tcf)
    l2, cache = ttf.decode_step(tp, t[:, 11:12], cache, n + 1, tcf)
    _close(l1, full[:, -2].numpy(), dict(rtol=2e-4, atol=2e-4))
    _close(l2, full[:, -1].numpy(), dict(rtol=2e-4, atol=2e-4))


def test_bf16_dense_smoke():
    """smollm's smoke config in bfloat16: prefill and two decode steps
    within 2e-2 of the reference's, caches held in bfloat16."""
    cfg, tcf, jp, tp = _models("smollm-360m", dtype="bfloat16")
    assert tp.embed.dtype == torch.bfloat16
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 16)
                                             ).astype(np.int32)
    jl, jc, jn = jtf.prefill(jp, jnp.asarray(toks), cfg, max_len=18)
    tl, tc, tn = ttf.prefill(tp, torch.from_numpy(toks), tcf, max_len=18)
    assert all(v.dtype == torch.bfloat16 for v in tc.values())
    tol = dict(rtol=2e-2, atol=2e-2)
    _close(tl, np.asarray(jl, np.float32), tol)
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    for cache_len in (16, 17):
        jl, jc = jtf.decode_step(jp, tok[:, None], jc, cache_len, cfg)
        tl, tc = ttf.decode_step(tp, torch.from_numpy(np.array(tok))[:, None],
                                 tc, cache_len, tcf)
        assert tl.dtype == torch.bfloat16
        _close(tl, np.asarray(jl, np.float32), tol)
        tok = jnp.argmax(jl, -1).astype(jnp.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_cache(arch, dtype):
    """Shapes and dtypes of the zeroed cache, full config and smoke, against
    the reference's (abstractly)."""
    for get in ("get_config", "get_smoke_config"):
        cfg = dataclasses.replace(getattr(jcfg, get)(arch), dtype=dtype)
        tcf = dataclasses.replace(getattr(tcfg, get)(arch), dtype=dtype)
        want = jax.eval_shape(lambda: jtf.init_cache(cfg, 3, 24))
        got = ttf.init_cache(tcf, 3, 24, device="meta")
        assert got.keys() == want.keys()
        for k in want:
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype) == f"torch.{want[k].dtype}"
    small = ttf.init_cache(tcf, 2, 4, device="cpu")
    assert all(not v.any() for v in small.values())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_shapes_and_counts(arch):
    """Every leaf's path and shape of the full ``config()`` equal the
    reference's init (abstractly), and their count is ``n_params``; the
    smoke config's drawn parameters count ``n_params`` and are finite."""
    cfg, tcf = jcfg.get_config(arch), tcfg.get_config(arch)
    want = jax.tree.map(lambda a: tuple(a.shape),
                        jax.eval_shape(lambda: jtf.init(KEY, cfg)))
    got = common.spec_shapes(ttf._spec(tcf))
    assert got == want
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(
        got, is_leaf=lambda x: isinstance(x, tuple)))
    assert n == tcf.n_params == cfg.n_params
    smoke = tcfg.get_smoke_config(arch)
    params = ttf.init(0, smoke, device="cpu")
    assert sum(p.numel() for p in params.parameters()) == smoke.n_params
    assert all(bool(torch.isfinite(p).all()) for p in params.parameters())
    assert params.layers.ln1.shape == (smoke.n_layers, smoke.d_model)
