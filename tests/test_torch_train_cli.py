"""Port parity of the training driver ``repro_torch.launch.train``: its
flags against ``repro.launch.train``'s (plus ``--device``), the lm family
at ``--smoke`` for every LM arch (plain, ``--compress int8`` and
``topk``) with the reference's result keys, resume and failure injection
reproducing the uninterrupted run, and a training checkpoint —
``dict(params, opt=dict(m, v, count)[, hier | err])`` — written by either
package restored by the other, leaf for leaf, under the same paths
(``params/cross/0/w``, ``opt/m/table``, ``hier/.hier/.layers/0/.key``,
``params/layers/ffn/router``, ``err/embed``)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.checkpoint import ckpt as jckpt_mod
from repro.configs import registry as jcfg
from repro.launch import train as jtrain
from repro.models import dcn as jdcn
from repro.models import gnn as jgnn
from repro.models import transformer as jtf
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.optim.adamw import adamw_init as jadamw_init
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import registry as tcfg
from repro_torch.launch import train as ttrain
from repro_torch.models import dcn as tdcn
from repro_torch.models import common
from repro_torch.models import gnn as tgnn
from repro_torch.models import transformer as ttf
from repro_torch.optim.adamw import AdamWConfig, adamw_init

B = 8
CUTS = (64, 128, 256)


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


# ------------------------------------------------------------------- flags --

def _reference_args(monkeypatch, argv) -> dict:
    """The reference CLI's parsed arguments (its parser is built inside
    ``main``: run it with ``run`` replaced)."""
    seen = {}

    def fake_run(args):
        seen.update(vars(args))
        return dict(steps=0, final_loss=0.0, wall_s=0.0, straggler_flags=0,
                    failures=0)
    monkeypatch.setattr(jtrain, "run", fake_run)
    monkeypatch.setattr("sys.argv", ["train", *argv])
    jtrain.main()
    return seen


@pytest.mark.parametrize("argv", [
    [], ["--arch", "dcn-v2", "--smoke", "--hier-embed", "--steps", "7",
         "--ckpt-dir", "d", "--ckpt-every", "3", "--resume",
         "--fail-at-step", "2", "--compress", "int8", "--log-every", "0"]])
def test_train_flags_match_reference(monkeypatch, argv):
    want = _reference_args(monkeypatch, argv)
    got = vars(ttrain.parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want
    made = vars(ttrain.make_args())
    assert made.pop("device") == "cuda"
    assert made == vars(jtrain.make_args())


def test_lm_family_and_cuda_default(monkeypatch):
    """An lm smoke run trains on ``device="cpu"``; with no card the CUDA
    default raises."""
    out = ttrain.run(ttrain.make_args(arch="smollm-360m", steps=3, batch=2,
                                      seq=16, device="cpu"))
    assert out["steps"] == 3 and len(out["losses"]) == 3
    assert np.all(np.isfinite(out["losses"] + out["gnorms"]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.run(ttrain.make_args(arch="dcn-v2"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.run(ttrain.make_args(arch="smollm-360m"))


LM_ARCHS = ("deepseek-v2-236b", "granite-moe-3b-a800m", "mistral-nemo-12b",
            "phi3-mini-3.8b", "smollm-360m")


@pytest.fixture(scope="module")
def reference_keys(_jax_shim):
    """The reference driver's result keys, from a one-step lm smoke run."""
    return set(jtrain.run(jtrain.make_args(steps=1, batch=2, seq=16)))


@pytest.mark.parametrize("compress", ["", "int8", "topk"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_run_on_cpu(reference_keys, arch, compress):
    """``run`` at ``--smoke`` for every LM arch, plain and compressed:
    the reference's result keys (plus ``step_s`` and ``gnorms``), finite
    losses and gradient norms; the plain state is (params, opt), the
    compressed one adds the error tree."""
    out, state = ttrain.run_with_state(ttrain.make_args(
        arch=arch, steps=2, batch=2, seq=16, compress=compress,
        device="cpu"))
    assert set(out) == reference_keys | {"step_s", "gnorms"}
    assert out["steps"] == 2 and out["failures"] == 0
    assert np.all(np.isfinite(out["losses"] + out["gnorms"]))
    assert set(state) == ({"params", "opt", "err"} if compress
                          else {"params", "opt"})
    assert int(state["opt"]["count"]) == 2


@pytest.mark.parametrize("compress", ["", "int8"])
def test_lm_driver_resume_determinism(tmp_path, compress):
    """The reference's driver test on the port: a run that fails at step 6
    and restores step 4 ends on the clean run's loss (rtol 1e-6); so does
    a run cut at step 6 and resumed.  With ``--compress`` the error tree
    is checkpointed too."""
    base = dict(arch="smollm-360m", steps=8, batch=2, seq=32,
                compress=compress, device="cpu",
                ckpt_dir=str(tmp_path / "a"), ckpt_every=4)
    clean = ttrain.run(ttrain.make_args(**base))
    faulty = ttrain.run(ttrain.make_args(**{**base, "ckpt_dir": str(
        tmp_path / "b"), "fail_at_step": 6}))
    assert faulty["failures"] == 1
    np.testing.assert_allclose(clean["final_loss"], faulty["final_loss"],
                               rtol=1e-6)
    cut = {**base, "ckpt_dir": str(tmp_path / "c")}
    ttrain.run(ttrain.make_args(**{**cut, "steps": 6}))
    resumed = ttrain.run(ttrain.make_args(**{**cut, "resume": True}))
    np.testing.assert_allclose(resumed["losses"], clean["losses"][6:],
                               rtol=1e-6)
    names = os.listdir(tmp_path / "c" / "step_8")
    with open(tmp_path / "c" / "step_8" / "manifest.json") as f:
        paths = [l["path"] for l in json.load(f)["leaves"]]
    assert "manifest.json" in names
    assert ("err/embed" in paths) == bool(compress)


@pytest.mark.parametrize("compress", ["int8", "topk"])
def test_lm_driver_compression_converges(compress):
    """The reference's test on the port (and top-k too): ten compressed
    steps lower the loss."""
    out = ttrain.run(ttrain.make_args(arch="smollm-360m", steps=10, batch=2,
                                      seq=32, compress=compress,
                                      device="cpu"))
    assert out["losses"][-1] < out["losses"][0]


# ------------------------------------------------------------------ resume --

@pytest.mark.parametrize("arch,hier", [("dcn-v2", True), ("dcn-v2", False),
                                       ("gat-cora", False)])
def test_resume_and_failure_equal_the_uninterrupted_run(tmp_path, arch,
                                                        hier):
    """``--ckpt-every 4 --fail-at-step 6`` (restore step 4, rerun 4 and 5)
    and a run cut at step 6 then ``--resume``d both end on the
    uninterrupted run's loss; their batches come from (seed + 1, step)."""
    kw = dict(arch=arch, steps=10, batch=B, hier_embed=hier, device="cpu",
              lr=1e-2)
    base = ttrain.run(ttrain.make_args(**kw))
    assert len(base["losses"]) == 10 and base["failures"] == 0
    assert np.all(np.isfinite(base["losses"] + base["gnorms"]))
    failed = ttrain.run(ttrain.make_args(
        ckpt_dir=str(tmp_path / "a"), ckpt_every=4, fail_at_step=6, **kw))
    assert failed["failures"] == 1 and len(failed["losses"]) == 12
    np.testing.assert_allclose(failed["final_loss"], base["final_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(failed["losses"][6:], base["losses"][4:],
                               rtol=1e-5)
    cut = dict(kw, steps=6, ckpt_dir=str(tmp_path / "b"), ckpt_every=4)
    ttrain.run(ttrain.make_args(**cut))
    resumed = ttrain.run(ttrain.make_args(**dict(cut, steps=10,
                                                 resume=True)))
    assert len(resumed["losses"]) == 4
    np.testing.assert_allclose(resumed["losses"], base["losses"][6:],
                               rtol=1e-5)


def test_data_seed_follows_the_step():
    a = ttrain.step_seed(0, 5)
    assert a == ttrain.step_seed(0, 5) != ttrain.step_seed(0, 6)
    assert ttrain.step_seed(1, 5) != a


# ------------------------------------------------- cross-package checkpoint --

def _batches(cfg, n):
    rng = np.random.default_rng(3)
    return [dict(dense=rng.normal(size=(B, cfg.n_dense)).astype(np.float32),
                 sparse=rng.integers(0, 60, (B, cfg.n_sparse)).astype(
                     np.int32),
                 labels=(rng.random(B) < 0.5).astype(np.float32))
            for _ in range(n)]


def _lm_batches(vocab, n):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (2, 17)).astype(np.int32)
        out.append(dict(tokens=toks[:, :-1], labels=toks[:, 1:]))
    return out


def _jax_state(kind, steps):
    """A reference training state after ``steps`` steps."""
    if kind.startswith("lm"):
        cfg = jcfg.get_smoke_config("granite-moe-3b-a800m")
        params = jtf.init(jax.random.PRNGKey(0), cfg)
        opt = jadamw_init(params)
        step = jax.jit(jtf.make_train_step(cfg, JAdamW(lr=1e-2)))
        for b in _lm_batches(cfg.vocab, steps):
            params, opt, _ = step(params, opt, jax.tree.map(jnp.asarray, b))
        state = dict(params=params, opt=opt)
        if kind == "lm-int8":
            state["err"] = jax.tree.map(lambda p: p * 0.5, params)
        return state
    if kind == "dcn-hier":
        cfg = jcfg.get_smoke_config("dcn-v2")
        params = jdcn.init(jax.random.PRNGKey(0), cfg)
        rest = {k: v for k, v in params.items() if k != "table"}
        opt, h = jadamw_init(rest), jdcn.hier_embed_init(cfg, B, CUTS)
        step = jax.jit(jdcn.make_train_step_hier(cfg, JAdamW(lr=1e-2)))
        for b in _batches(cfg, steps):
            params, opt, h, _ = step(params, opt, h, jax.tree.map(
                jnp.asarray, b))
        return dict(params=params, opt=opt, hier=h)
    cfg = jcfg.get_smoke_config("gat-cora")
    params = jgnn.init(jax.random.PRNGKey(0), cfg, 6, 3)
    return dict(params=params, opt=jadamw_init(params))


def _torch_state(kind, steps):
    """A port training state after ``steps`` steps (fresh weights)."""
    if kind.startswith("lm"):
        cfg = tcfg.get_smoke_config("granite-moe-3b-a800m")
        params = ttf.init(1, cfg, device="cpu")
        opt = adamw_init(params)
        step = ttf.make_train_step(cfg, AdamWConfig(lr=1e-2))
        for b in _lm_batches(cfg.vocab, steps):
            params, opt, _ = step(params, opt, {
                k: torch.from_numpy(v) for k, v in b.items()})
        state = dict(params=params, opt=opt)
        if kind == "lm-int8":
            state["err"] = common.tree_map(lambda p: p * 0.5, params)
        return state
    if kind == "dcn-hier":
        cfg = tcfg.get_smoke_config("dcn-v2")
        params = tdcn.init(1, cfg, device="cpu")
        opt = adamw_init(tdcn.rest_params(params))
        h = tdcn.hier_embed_init(cfg, B, CUTS, device="cpu")
        step = tdcn.make_train_step_hier(cfg, AdamWConfig(lr=1e-2))
        for b in _batches(cfg, steps):
            params, opt, h, _ = step(params, opt, h, {
                k: torch.from_numpy(v) for k, v in b.items()})
        return dict(params=params, opt=opt, hier=h)
    cfg = tcfg.get_smoke_config("gat-cora")
    params = tgnn.init(1, cfg, 6, 3, device="cpu")
    return dict(params=params, opt=adamw_init(params))


def _assert_same_leaves(tstate, jstate):
    t, j = tckpt._flatten(tstate), jckpt_mod._flatten(jstate)
    assert [p for p, _, _ in t] == [p for p, _ in j]
    for (path, a, _), (_, b) in zip(t, j):
        b = np.asarray(b)
        a = a.detach().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


PARAMS_TYPE = {"dcn-hier": tdcn.DCNv2, "gat": tgnn.GNN,
               "lm": common.ParamTree, "lm-int8": common.ParamTree}
# a leaf path each checkpoint must hold
LEAF_NAME = {"dcn-hier": "hier/.hier/.layers/0/.key", "gat": "params/head",
             "lm": "params/layers/ffn/router", "lm-int8": "err/embed"}


@pytest.mark.parametrize("kind", ["dcn-hier", "gat", "lm", "lm-int8"])
def test_training_checkpoint_crosses_packages(tmp_path, kind):
    # the reference writes, the port restores
    jstate = _jax_state(kind, 3)
    jckpt.save(str(tmp_path / "j"), 3, jstate)
    got = tckpt.restore(str(tmp_path / "j"), 3, _torch_state(kind, 0))
    _assert_same_leaves(got, jstate)
    assert type(got["params"]) is PARAMS_TYPE[kind]
    assert not any(p.requires_grad for p in got["params"].parameters())
    # the port writes, the reference restores
    tstate = _torch_state(kind, 3)
    tckpt.save(str(tmp_path / "t"), 3, tstate)
    back = jckpt.restore(str(tmp_path / "t"), 3, _jax_state(kind, 0))
    _assert_same_leaves(tstate, back)
    paths = {}
    for w in ("j", "t"):
        with open(os.path.join(tmp_path, w, "step_3", "manifest.json")) as f:
            paths[w] = [(l["path"], l["dtype"], l["shape"])
                        for l in json.load(f)["leaves"]]
    assert paths["j"] == paths["t"]
    names = [p for p, _, _ in paths["t"]]
    assert "opt/count" in names and LEAF_NAME[kind] in names
