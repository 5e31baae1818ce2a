"""Port parity of the LM family's training half: ``repro_torch.models``'
``cross_entropy``, ``transformer.loss_fn`` (value and the gradient of
every leaf) and ``make_train_step`` against ``repro.models``' on the same
numpy inputs and the same JAX-initialised weights, on the CPU, for every
LM arch's ``smoke_config()``; and properties of the port alone: remat on
== off, and the stacked ``[L, ...]`` leaves split with one ``unbind``.

Float32 tolerances: losses rtol 1e-5; gradients, parameters and AdamW
moments rtol 1e-4 / atol 1e-5.  The steps take lr 1e-4, so the atol is a
tenth of one AdamW step: AdamW's per-element step m / (sqrt(v) + eps)
turns a gradient near zero whose last bits differ between the packages
into a different fraction of lr.  With a bfloat16 gradient accumulator a
gradient that differs between the packages in its last float32 bits may
round to the neighbouring bfloat16 value, and where two microbatch
gradients cancel that rounding is large against their sum: the moments
are held within one bfloat16 rounding of each leaf's largest value (2**-8
of the leaf's max; 2**-7, since v squares the gradient), and the
parameters within two AdamW steps
(atol 2 lr), since two microbatch gradients that cancel may land on
either side of zero, and AdamW's first step is +-lr whatever the
gradient's size.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jcfg
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro_torch.configs import registry as tcfg
from repro_torch.models import common
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw as tadamw

LM_ARCHS = ("deepseek-v2-236b", "granite-moe-3b-a800m", "mistral-nemo-12b",
            "phi3-mini-3.8b", "smollm-360m")
LOSS = dict(rtol=1e-5, atol=0.0)
TREE = dict(rtol=1e-4, atol=1e-5)
KEY = jax.random.PRNGKey(0)
LR = 1e-4
BF16_ACC = 2.0 ** -7    # one bf16 rounding of a leaf's max (v doubles it)
BF16_MODEL = 2e-2       # a whole bf16 model's outputs (tests/test_torch_lm.py)


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(
        np.asarray(got.detach().float().numpy() if isinstance(
            got, torch.Tensor) else got, np.float32),
        np.asarray(want, np.float32), err_msg=what, **tol)


def _trees_close(got, want, tol, what):
    """Leaf by leaf; a float ``tol`` is relative to each leaf's largest
    value (rtol and atol ``tol * max |leaf|``)."""
    leaves = common.tree_leaves(got)
    jleaves = jax.tree.leaves(want)
    assert len(leaves) == len(jleaves), what
    for i, (a, b) in enumerate(zip(leaves, jleaves)):
        assert tuple(a.shape) == b.shape, (what, i)
        leaf_tol = tol
        if isinstance(tol, float):
            leaf_tol = dict(rtol=tol,
                            atol=tol * float(np.abs(np.asarray(b)).max()))
        _close(a, b, leaf_tol, f"{what} leaf {i}")


def _models(arch, **over):
    cfg = dataclasses.replace(jcfg.get_smoke_config(arch), **over)
    tcf = dataclasses.replace(tcfg.get_smoke_config(arch), **over)
    jp = jtf.init(KEY, cfg)
    return cfg, tcf, jp, ttf.params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


def _batch(seed, vocab, b=4, s=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return dict(tokens=toks[:, :-1], labels=toks[:, 1:])


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v.copy()) for k, v in batch.items()})


# ---------------------------------------------------------- cross entropy --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("z_loss", [0.0, 1e-2])
def test_cross_entropy(dtype, z_loss):
    """Float32 log-sum-exp minus the gold logit (plus z_loss * lse**2),
    averaged, on float32 and bfloat16 logits; its gradient too."""
    rng = np.random.default_rng(0)
    logits = jnp.asarray(rng.standard_normal((3, 7, 40)) * 4, dtype)
    labels = rng.integers(0, 40, (3, 7)).astype(np.int32)
    want, jgrad = jax.value_and_grad(
        lambda x: jcommon.cross_entropy(x, labels, z_loss))(logits)
    x = common.tree_from_numpy(np.asarray(logits), "cpu").requires_grad_()
    got = common.cross_entropy(x, torch.from_numpy(labels), z_loss)
    assert got.dtype == torch.float32
    _close(got, want, LOSS)
    got.backward()
    assert x.grad.dtype == x.dtype
    _close(x.grad, jgrad, dict(rtol=1e-5, atol=1e-7) if dtype == "float32"
           else dict(rtol=1e-2, atol=1e-4))


@pytest.mark.parametrize("z_loss", [0.0, 1e-2])
def test_cross_entropy_labels_outside_the_vocab(z_loss):
    """A label of ``V`` or ``-1`` matches no logit in the reference's
    iota-mask sum, so its gold logit is 0 and its loss the log-sum-exp:
    value and gradient rtol 1e-5; and the figure of seed 0's [2, 3, 11]
    logits."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 11)).astype(np.float32)
    labels = np.array([[0, 5, 11], [1, -1, 3]], np.int32)
    want, jgrad = jax.value_and_grad(
        lambda v: jcommon.cross_entropy(v, labels, z_loss))(jnp.asarray(x))
    t = torch.from_numpy(x.copy()).requires_grad_()
    got = common.cross_entropy(t, torch.from_numpy(labels), z_loss)
    _close(got, want, LOSS)
    got.backward()
    _close(t.grad, jgrad, dict(rtol=1e-5, atol=1e-7))
    if not z_loss:
        assert float(got.detach()) == pytest.approx(3.0315053462982178,
                                                    rel=1e-6)


def test_count_params():
    for arch in LM_ARCHS:
        cfg, _, jp, tp = _models(arch)
        assert common.count_params(tp) == jcommon.count_params(jp) \
            == cfg.n_params


# ---------------------------------------------------------------- loss_fn --

LOSS_CASES = [(a, None) for a in LM_ARCHS] + [
    ("granite-moe-3b-a800m", 0.25), ("deepseek-v2-236b", 0.25)]


@pytest.mark.parametrize("arch,capacity_factor", LOSS_CASES)
def test_loss_fn_value_and_grads(arch, capacity_factor):
    """``loss_fn``'s value and metrics, and the gradient of every leaf,
    against ``jax.value_and_grad`` of the reference's; the MoE archs also
    at capacity factor 0.25, where pairs drop (a dropped pair gathers
    slot C - 1 with weight 0: no gradient reaches that slot from it)."""
    over = {} if capacity_factor is None else dict(
        capacity_factor=capacity_factor)
    cfg, tcf, jp, tp = _models(arch, **over)
    jb, tb = _both(_batch(1, cfg.vocab))
    (jloss, jm), jgrads = jax.value_and_grad(
        partial(jtf.loss_fn, cfg=cfg), has_aux=True)(jp, jb)
    (loss, m), (grads,) = common.value_and_grad(
        lambda p: ttf.loss_fn(p, tb, tcf), tp)
    _close(loss, jloss, LOSS, "loss")
    assert m.keys() == jm.keys()
    _close(m["loss"], jm["loss"], LOSS, "ce")
    _close(m["aux"], jm["aux"], dict(rtol=1e-5, atol=1e-7), "aux")
    _trees_close(grads, jgrads, TREE, f"{arch} grads")
    if cfg.moe:
        router = grads["layers"]["ffn"]["router"]
        assert bool((router != 0).any())


# -------------------------------------------------------- make_train_step --

STEP_CASES = [(1, "float32", False), (1, "float32", True),
              (2, "float32", False), (2, "float32", True),
              (2, "bfloat16", False)]


@pytest.mark.parametrize("nm,accum,schedule", STEP_CASES)
@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m"])
def test_train_steps_match_reference(arch, nm, accum, schedule):
    """Two steps of ``make_train_step`` (lr 1e-4, or ``warmup_cosine`` as
    the schedule) from the same params on the same batches: params, m, v,
    count and every metric.  With nm 1 ``loss`` is the cross entropy and
    ``aux`` the aux loss; with nm 2 ``loss`` and ``total`` are the mean
    over microbatches of ce + aux and ``aux`` is 0, as in the
    reference."""
    cfg, tcf, jp, tp = _models(arch, num_microbatches=nm,
                               grad_accum_dtype=accum)
    opt_cfg = jadamw.AdamWConfig(lr=LR)
    sched = dict(peak_lr=LR, warmup=1, total=10)
    jstep = jax.jit(jtf.make_train_step(
        cfg, opt_cfg, partial(jadamw.warmup_cosine, **sched)
        if schedule else None))
    tstep = ttf.make_train_step(
        tcf, tadamw.AdamWConfig(lr=LR),
        partial(tadamw.warmup_cosine, **sched) if schedule else None)
    jo, to = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    params_tol, moments = (TREE, TREE) if accum == "float32" else (
        dict(rtol=1e-4, atol=2 * LR), BF16_ACC)
    for seed in (2, 3):
        jb, tb = _both(_batch(seed, cfg.vocab))
        jp, jo, jm = jstep(jp, jo, jb)
        tp, to, tm = tstep(tp, to, tb)
        assert tm.keys() == jm.keys() == {"loss", "aux", "total", "gnorm"}
        for k in ("loss", "total"):
            _close(tm[k], jm[k], LOSS, k)
        _close(tm["aux"], jm["aux"], dict(rtol=1e-5, atol=1e-7), "aux")
        _close(tm["gnorm"], jm["gnorm"], dict(rtol=1e-4, atol=0.0), "gnorm")
        if nm > 1:
            assert float(tm["aux"]) == 0.0
        elif cfg.moe:
            assert float(tm["aux"]) > 0.0
            _close(tm["total"], jm["loss"] + jm["aux"], LOSS, "total")
        assert int(to["count"]) == int(jo["count"])
        assert to["count"].dtype == torch.int32
        _trees_close(tp, jp, params_tol, "params")
        _trees_close(to["m"], jo["m"], moments, "m")
        _trees_close(to["v"], jo["v"], moments, "v")


@pytest.mark.parametrize("nm", [1, 2])
def test_bf16_train_step(nm):
    """smollm's smoke config in bfloat16: autograd gives bfloat16
    gradients, as ``jax.grad`` does, and each leaf is as accurate as the
    reference's: its relative L2 error against the float32 gradient of
    the same (widened) weights at most 1.5 times the reference's bf16
    gradient's (the packages round a bf16 model's intermediates in
    different places, so their bf16 gradients differ by about as much as
    each differs from float32, 1-2 % a leaf); AdamW takes them as they
    are with nm 1,
    and nm 2 accumulates them in float32.  One step against the
    reference's: metrics within 2e-2, the params stay bfloat16, within one
    bfloat16 spacing (rtol 2**-7) or two AdamW steps (atol 2 lr: a
    gradient near zero may take either sign)."""
    cfg, tcf, jp, tp = _models("smollm-360m", dtype="bfloat16",
                               num_microbatches=nm)
    assert tp.embed.dtype == torch.bfloat16
    jb, tb = _both(_batch(7, cfg.vocab))
    _, jgrads = jax.value_and_grad(partial(jtf.loss_fn, cfg=cfg),
                                   has_aux=True)(jp, jb)
    _, (grads,) = common.value_and_grad(lambda p: ttf.loss_fn(p, tb, tcf),
                                        tp)
    assert all(g.dtype == torch.bfloat16 for g in common.tree_leaves(grads))
    f32 = dataclasses.replace(cfg, dtype="float32")
    _, exact = jax.value_and_grad(partial(jtf.loss_fn, cfg=f32),
                                  has_aux=True)(
        jax.tree.map(lambda x: x.astype(jnp.float32), jp), jb)

    def rel(a, b):
        b = np.asarray(b)
        return np.linalg.norm(np.asarray(a, np.float32) - b) \
            / np.linalg.norm(b)
    for i, (a, b, t) in enumerate(zip(common.tree_leaves(grads),
                                      jax.tree.leaves(jgrads),
                                      jax.tree.leaves(exact))):
        mine, ref = rel(a.float().numpy(), t), rel(b, t)
        assert 0 < mine <= 1.5 * ref, (i, mine, ref)
    jp, _, jm = jax.jit(jtf.make_train_step(
        cfg, jadamw.AdamWConfig(lr=LR)))(jp, jadamw.adamw_init(jp), jb)
    tp, to, tm = ttf.make_train_step(tcf, tadamw.AdamWConfig(lr=LR))(
        tp, tadamw.adamw_init(tp), tb)
    for k in ("loss", "total", "gnorm"):
        _close(tm[k], jm[k], dict(rtol=BF16_MODEL, atol=0.0), k)
    assert all(p.dtype == torch.bfloat16 for p in common.tree_leaves(tp))
    assert all(m.dtype == torch.float32
               for m in common.tree_leaves([to["m"], to["v"]]))
    _trees_close(tp, jp, dict(rtol=2 ** -7, atol=2 * LR), "params")


def test_microbatches_split_the_batch_contiguously():
    """nm 2 takes rows [0, B/2) then [B/2, B), as the reference's
    ``reshape(nm, B // nm, ...)`` does: its total is the mean of the two
    halves' losses; a batch nm does not divide raises."""
    _, tcf, _, tp = _models("smollm-360m", num_microbatches=2)
    _, tb = _both(_batch(4, tcf.vocab))
    halves = [float(ttf.loss_fn(tp, {k: v[r] for k, v in tb.items()},
                                tcf)[0])
              for r in (slice(0, 2), slice(2, 4))]
    opt = tadamw.adamw_init(tp)
    _, _, m = ttf.make_train_step(tcf, tadamw.AdamWConfig())(tp, opt, tb)
    np.testing.assert_allclose(float(m["total"]), np.mean(halves),
                               rtol=1e-6)
    _, tb = _both(_batch(4, tcf.vocab, b=3))
    with pytest.raises(ValueError, match="not a multiple"):
        ttf.make_train_step(tcf, tadamw.AdamWConfig())(tp, opt, tb)


# ------------------------------------------------------------ port alone --

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_remat_on_equals_off(arch):
    """Checkpointed layers recompute the same values: loss and every
    gradient within 1e-5 with remat on and off."""
    _, tcf, _, tp = _models(arch)
    _, tb = _both(_batch(5, tcf.vocab))
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(tcf, remat=remat)
        out[remat] = common.value_and_grad(lambda p: ttf.loss_fn(p, tb, c),
                                           tp)
    (l1, _), (g1,) = out[True]
    (l0, _), (g0,) = out[False]
    _close(l1, l0.numpy(), LOSS)
    for a, b in zip(common.tree_leaves(g1), common.tree_leaves(g0)):
        _close(a, b.numpy(), dict(rtol=1e-5, atol=1e-7))


def _consumers(loss, leaves) -> dict:
    """For each leaf of ``leaves`` (by id), the names of the autograd nodes
    that take it as an input, found by walking ``loss``'s graph."""
    want = {id(x) for x in leaves}
    found, seen, todo = {}, set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            var = getattr(nxt, "variable", None)
            if var is not None and id(var) in want:
                found.setdefault(id(var), []).append(node.name())
            todo.append(nxt)
    return found


@pytest.mark.parametrize("remat", [True, False])
def test_stacked_leaves_are_split_by_one_unbind(remat):
    """Every stacked ``[L, ...]`` layer leaf reaches the loss through one
    ``UnbindBackward`` (its backward is one stack), never through a
    ``SelectBackward`` per layer (each of which would add a zero tensor of
    the whole leaf), for all five archs."""
    for arch in LM_ARCHS:
        _, tcf, _, tp = _models(arch, remat=remat)
        _, tb = _both(_batch(6, tcf.vocab))
        stacked = list(tp.layers.parameters())
        for p in tp.parameters():
            p.requires_grad_(True)
        loss, _ = ttf.loss_fn(tp, tb, tcf)
        found = _consumers(loss, stacked)
        assert len(found) == len(stacked), arch
        for names in found.values():
            assert names == ["UnbindBackward0"], (arch, names)
