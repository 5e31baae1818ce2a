"""``repro_torch.examples.recsys_hier_embeddings`` on the CPU at batch 32,
4 steps, ``drain_every=2`` and cuts (64, 128, 256): the dense and hier
paths' losses equal the JAX package's same steps (``dcn.make_train_step``
and ``make_train_step_hier`` at the example's learning rates) from the
same numpy parameters and batches, within rtol 1e-5 as in
``test_torch_train.py``, and the drain flags are the same at every step.
``main`` serves and retrieves on both routes (the kernel route's plain
version on the CPU) with scores within rtol 1e-6."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jcfg
from repro.models import dcn as jdcn
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.optim.adamw import adamw_init as jadamw_init
from repro_torch.examples import recsys_hier_embeddings as rx
from repro_torch.models import dcn as tdcn

LOSS_RTOL = 1e-5
B, STEPS, DRAIN, CUTS = 32, 4, 2, (64, 128, 256)


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


@pytest.fixture(scope="module")
def setup():
    """The JAX package's initial weights in both packages, and the
    example's own batches (as numpy for the reference)."""
    jc = jcfg.get_smoke_config("dcn-v2")
    tc = rx.get_smoke_config("dcn-v2")
    tree = jax.tree.map(np.asarray, jdcn.init(jax.random.PRNGKey(0), jc))
    data = rx.batches(tc, 0, B, "cpu")
    np_batches = [{k: v.numpy() for k, v in data(i).items()}
                  for i in range(STEPS)]
    return jc, tc, tree, data, np_batches


def test_dense_losses_equal_the_reference(setup):
    jc, tc, tree, data, np_batches = setup
    params = tdcn.params_from_numpy(tree, tc, device="cpu")
    _, metrics = rx.train_dense(tc, params, data, STEPS)
    jstep = jax.jit(jdcn.make_train_step(jc, JAdamW(lr=1e-3)))
    jp = jax.tree.map(jnp.asarray, tree)
    jo = jadamw_init(jp)
    for m, b in zip(metrics, np_batches):
        jp, jo, jm = jstep(jp, jo, jax.tree.map(jnp.asarray, b))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)


def test_hier_losses_and_drains_equal_the_reference(setup):
    jc, tc, tree, data, np_batches = setup
    params = tdcn.params_from_numpy(tree, tc, device="cpu")
    _, _, metrics = rx.train_hier(tc, params, data, STEPS, B,
                                  drain_every=DRAIN, cuts=CUTS)
    jstep = jax.jit(jdcn.make_train_step_hier(
        jc, JAdamW(lr=1e-3), embed_lr=0.05, drain_every=DRAIN))
    jp = jax.tree.map(jnp.asarray, tree)
    jo = jadamw_init({k: v for k, v in jp.items() if k != "table"})
    jh = jdcn.hier_embed_init(jc, B, cuts=CUTS)
    drained = []
    for m, b in zip(metrics, np_batches):
        jp, jo, jh, jm = jstep(jp, jo, jh, jax.tree.map(jnp.asarray, b))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        assert bool(m["drained"]) == bool(jm["drained"])
        np.testing.assert_array_equal(m["spills"].numpy(),
                                      np.asarray(jm["spills"]))
        drained.append(bool(m["drained"]))
    assert drained == [False, True, False, True]


def test_main_serves_on_both_routes():
    kw = dict(batch=B, steps=STEPS, drain_every=DRAIN, cuts=CUTS,
              n_candidates=1000)
    out, (params, batch, cfg) = rx.run_with_state("cpu", use_kernel=True,
                                                  **kw)
    assert cfg.use_kernel and out["drains"] == 2
    gather = tdcn.serve_scores(params, batch,
                               dataclasses.replace(cfg, use_kernel=False))
    np.testing.assert_allclose(np.asarray(out["scores"]), gather.numpy(),
                               rtol=1e-6)
    assert len(out["top_ids"]) == 10 and np.isfinite(out["best_score"])
    assert out["dense_loss"] > 0 and out["hier_loss"] > 0
    assert torch.isfinite(gather).all()
