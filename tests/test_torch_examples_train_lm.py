"""``repro_torch.examples.train_lm`` on the CPU at smollm-360m's smoke
config, 12 steps of batch 2 x 32, a checkpoint every 2 steps and the
failure injected at step 6: the example's own two checks hold (the loss
drops; the recovered run's final loss within 1e-4 of the clean run's),
and ``check`` refuses a run whose loss did not drop or whose recovery
strayed."""
import jax
import pytest

from repro_torch.examples import train_lm

SMALL = dict(steps=12, batch=2, seq=32, ckpt_every=2, fail_at_step=6,
             log_every=0)


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def test_clean_and_recovered_runs_pass_the_examples_checks():
    out = train_lm.main("cpu", **SMALL)
    assert out["failures"] == 1 and out["steps"] == 12
    assert out["final_loss"] < out["first_loss"]
    assert out["final_loss_diff"] < 1e-4


@pytest.mark.parametrize("clean,faulty,what", [
    (dict(losses=[1.0], final_loss=1.5), dict(final_loss=1.5), "drop"),
    (dict(losses=[2.0], final_loss=1.0), dict(final_loss=1.001),
     "reproduce")])
def test_check_refuses(clean, faulty, what):
    with pytest.raises(AssertionError, match=what):
        train_lm.check(clean, faulty)
