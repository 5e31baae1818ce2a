"""Port parity of LM serving, ``repro_torch.launch.serve``, and of
``data/synthetic.token_batch``: the serve CLI's flags against
``repro.launch.serve``'s (plus ``--device``); ``run`` at ``--smoke`` on the
CPU for every LM arch with the reference's result keys; the port's serve
loop (``generate``) fed the reference run's own params and prompts,
giving its greedy tokens exactly; and the token stream by its invariants
(its bits cannot match ``jax.random.categorical``)."""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.configs import registry as tcfg
from repro_torch.data import synthetic
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttf

LM_ARCHS = ("deepseek-v2-236b", "granite-moe-3b-a800m", "mistral-nemo-12b",
            "phi3-mini-3.8b", "smollm-360m")


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


# ------------------------------------------------------------------- data --

def test_token_batch_invariants():
    b = synthetic.token_batch(3, 64, 48, 256, device="cpu")
    toks, labels = b["tokens"], b["labels"]
    assert toks.shape == labels.shape == (64, 48)
    assert toks.dtype == labels.dtype == torch.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < 256
    assert torch.equal(toks[:, 1:], labels[:, :-1])
    assert torch.equal(synthetic.token_batch(3, 64, 48, 256,
                                             device="cpu")["tokens"], toks)
    # Zipf(1.1): rank frequencies fall; id 0 takes ~1/sum(i^-1.1) of draws
    big = synthetic.token_batch(4, 512, 256, 1000, device="cpu")["tokens"]
    counts = torch.bincount(big.reshape(-1).long(), minlength=1000).numpy()
    assert (np.diff(counts[:6]) < 0).all()
    p0 = 1.0 / (np.arange(1, 1001) ** -1.1).sum()
    assert abs(counts[0] / counts.sum() - p0) < 0.01
    assert counts[:10].sum() > counts[500:].sum()
    steps = list(synthetic.token_stream(3, 3, 2, 8, 50, device="cpu"))
    assert len(steps) == 3
    assert not torch.equal(steps[0]["tokens"], steps[1]["tokens"])


# ------------------------------------------------------------------- flags --

def _reference_args(monkeypatch, argv) -> dict:
    """The reference CLI's parsed arguments (its parser is built inside
    ``main``: run it with ``run`` replaced)."""
    seen = {}

    def fake_run(args):
        seen.update(vars(args))
        return dict(prefill_tok_s=0.0, prefill_s=1.0, decode_tok_s=0.0,
                    decode_s=1.0, generated=(0, 0), finite=True)
    monkeypatch.setattr(jserve, "run", fake_run)
    monkeypatch.setattr("sys.argv", ["serve", *argv])
    jserve.main()
    return seen


@pytest.mark.parametrize("argv", [
    [], ["--arch", "deepseek-v2-236b", "--smoke", "--batch", "3",
         "--prompt-len", "9", "--gen", "5", "--seed", "7"]])
def test_serve_flags_match_reference(monkeypatch, argv):
    want = _reference_args(monkeypatch, argv)
    got = vars(tserve.parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want
    made = vars(tserve.make_args())
    assert made.pop("device") == "cuda"
    assert made == _reference_args(monkeypatch, [])


# -------------------------------------------------------------------- runs --

def _reference_run(monkeypatch, arch, batch, prompt_len, gen):
    """The reference's ``serve.run`` at ``--smoke``, with its ``stages.wrap``
    recording every prefill and decode call: returns its result, the
    params and prompts it built, and its greedy tokens."""
    from repro import stages
    calls = []

    def fake_wrap(fn, entry, sig, **kw):
        def call(*a):
            out = fn(*a)
            calls.append((entry, a, out))
            return out
        return call
    monkeypatch.setattr(stages, "wrap", fake_wrap)
    out = jserve.run(argparse.Namespace(arch=arch, smoke=True, batch=batch,
                                        prompt_len=prompt_len, gen=gen,
                                        seed=0))
    monkeypatch.undo()
    ((params, prompts), (logits, _, _)), = [
        (a, o) for e, a, o in calls if e == "serve.prefill"]
    decodes = [o for e, _, o in calls if e == "serve.decode"]
    assert len(decodes) == gen
    tokens = [jnp.argmax(logits, -1)] + [jnp.argmax(o[0], -1)
                                        for o in decodes]
    return out, params, prompts, np.stack([np.asarray(t) for t in tokens],
                                          axis=1)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_serve_run_on_cpu(monkeypatch, arch):
    """``run`` at ``--smoke --batch 4 --prompt-len 16 --gen 4`` on the CPU
    returns the reference's keys and shape, finite; and the port's serve
    loop on the reference run's params and prompts gives its greedy tokens
    exactly."""
    want, params, prompts, want_tokens = _reference_run(monkeypatch, arch,
                                                        4, 16, 4)
    got = tserve.run(tserve.make_args(arch=arch, smoke=True, batch=4,
                                      prompt_len=16, gen=4, device="cpu"))
    assert got.keys() == want.keys()
    assert got["generated"] == tuple(want["generated"]) == (4, 5)
    assert got["finite"] and want["finite"]
    assert got["prefill_tok_s"] > 0 and got["decode_tok_s"] > 0

    cfg = tcfg.get_smoke_config(arch)
    tp = ttf.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    state = tserve.generate(tp, torch.from_numpy(np.array(prompts)), cfg, 4)
    np.testing.assert_array_equal(state["tokens"].numpy(), want_tokens)
    assert state["cache_len"] == 20
    assert (np.asarray(prompts)[:, -1] == 0).all()


def test_run_with_state_returns_the_tokens():
    out, state = tserve.run_with_state(tserve.make_args(
        arch="granite-moe-3b-a800m", smoke=True, batch=2, prompt_len=8,
        gen=3, device="cpu"))
    assert state["tokens"].shape == (2, 4) and out["generated"] == (2, 4)
    assert state["prompts"].shape == (2, 8)
    assert (state["prompts"][:, -1] == 0).all()
    assert state["cache"]["k"].shape[3] == 11
    assert torch.isfinite(state["logits"]).all()


def test_serve_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.run(tserve.make_args(arch="smollm-360m", smoke=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.run(tserve.parser().parse_args(["--smoke"]))
