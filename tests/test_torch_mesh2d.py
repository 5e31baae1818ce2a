"""Port parity: the sharding layer executed on real ranks — gloo ranks on
the CPU, one ``launch.mesh.spawn_fleet`` per world size for the whole
module (the rank body is ``torch_parity.run_mesh_jobs``).

* The FSDP x TP LM step: phi3-mini's smoke config, one
  ``transformer.make_train_step`` step at lr 1e-3 (the reference's
  ``test_real_execution_on_mesh_matches_single``) on a (2, 2) ``("data",
  "model")`` mesh under ``make_policy``, parameters placed by
  ``to_shardings(lm_param_specs(...))``, the batch by ``batch_sharding``
  through ``ShardedStream(sharding=)``.
  Its loss equals the port's unsharded step and the JAX package's
  single-device step within 5e-4 (the reference test's bound); every
  parameter within rtol 1e-4 plus a tenth of one lr step of both; every
  local shard's shape equals its spec's arithmetic; the AdamW moments
  under their parameters' placements.  All three steps start from the
  JAX package's parameters, carried as numpy.  The other four LM archs'
  smoke configs (MoE with ``"ep"`` and expert-TP, MLA, GQA) take the
  same sharded step from the port's own parameters, held to the port's
  unsharded step with the same bounds.
* ``constrain`` under the policy on the ranks: a [6, 4] tensor sharded
  over ``("data",)`` x ``"model"``, a [5, 4] one keeps dim 0 replicated
  (2 does not divide 5), the values unchanged; ``sharding.place`` keeps
  the block DTensor's own ``distribute_tensor`` keeps, uneven shapes
  too.
* The reference's ``test_elastic_restore_onto_larger_mesh``, mirrored:
  a fleet of 8 instances ingested and saved by the JAX package, restored
  by the port with ``restore(..., shardings=)`` under ``Shard(0)`` of the
  fleet's mesh on P = 2 and 4 ranks (each rank reads 8/P instances; the
  ``REPRO_CHECK=1`` contracts pass on each rank's blocks), then
  ``rebalance_instances(..., 16, sharding=)``: the ranks' blocks joined
  equal ``repro.runtime.elastic.rebalance_instances`` of the JAX restore
  leaf for leaf, and the counter kept.
* An LM checkpoint (the JAX package's phi3 smoke parameters, saved by the
  port) restored onto ``init(..., device="meta")`` under
  ``to_shardings(lm_param_specs(...))`` on the (2, 2) mesh: every rank's
  block is its slice of the leaf, and the leaves gathered equal the
  saved ones exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro.configs import get_smoke_config as jget_smoke
from repro.core import distributed as jdist
from repro.core import stream as jstream
from repro.models import transformer as jtf
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init
from repro.runtime.elastic import rebalance_instances as jrebalance
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as ttf
from repro_torch.optim.adamw import AdamWConfig, adamw_init

import torch_parity as tp

ARCH = "phi3-mini-3.8b"
OTHER_ARCHS = ("deepseek-v2-236b", "granite-moe-3b-a800m",
               "mistral-nemo-12b", "smollm-360m")
LR = 1e-3
LOSS_TOL = 5e-4          # the reference test's bound
RTOL = 1e-4
ATOL = LR / 10           # a tenth of one lr step
FLEET = dict(instances=8, cuts=(64, 256), block=32, step=1, n_new=16)


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else str(k)))
        return out
    return {path: np.asarray(tree)}


@pytest.fixture(scope="module")
def lm_case():
    """The JAX package's parameters (numpy), batch and single-device
    step; the port's unsharded step from the same numbers."""
    cfg = jget_smoke(ARCH)
    key = jax.random.PRNGKey(0)
    params = jtf.init(key, cfg)
    tree = jax.tree.map(np.asarray, params)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (8, 33))
    batch = dict(tokens=toks[:, :-1].astype(np.int32),
                 labels=toks[:, 1:].astype(np.int32))
    step = jtf.make_train_step(cfg, JAdamWConfig(lr=LR))
    jp, _, jm = jax.jit(step)(params, jadamw_init(params),
                              jax.tree.map(jnp.asarray, batch))
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    tparams = ttf.params_from_numpy(tree, "cpu")
    tparams, _, tm = ttf.make_train_step(tcfg, AdamWConfig(lr=LR))(
        tparams, adamw_init(tparams),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return dict(tree=tree, batch=batch, jax_loss=float(jm["total"]),
                jax_params=_flat(jax.tree.map(np.asarray, jp)),
                port_loss=float(tm["total"]),
                port_params=_flat(ttf.params_to_numpy(tparams)))


@pytest.fixture(scope="module")
def other_cases():
    """Each other arch's smoke parameters drawn by the port (numpy), the
    batch, and the port's unsharded step from them."""
    out = {}
    toks = np.random.default_rng(1).integers(0, 256, (8, 17))
    batch = dict(tokens=toks[:, :-1].astype(np.int32),
                 labels=toks[:, 1:].astype(np.int32))
    for arch in OTHER_ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        assert cfg.vocab >= 256
        tree = ttf.params_to_numpy(ttf.init(0, cfg, device="cpu"))
        params = ttf.params_from_numpy(tree, "cpu")
        params, _, m = ttf.make_train_step(cfg, AdamWConfig(lr=LR))(
            params, adamw_init(params),
            {k: torch.from_numpy(v) for k, v in batch.items()})
        out[arch] = dict(tree=tree, batch=batch, loss=float(m["total"]),
                         params=_flat(ttf.params_to_numpy(params)))
    return out


@pytest.fixture(scope="module")
def fleet_case(tmp_path_factory):
    """The reference test's fleet: 8 instances ingested and saved by the
    JAX package, and its restore grown to 16 by the JAX package."""
    d = str(tmp_path_factory.mktemp("fleet"))
    n = FLEET["instances"]
    states = jdist.create_instances(n, FLEET["cuts"], FLEET["block"])
    key = jax.random.PRNGKey(0)
    rows = jax.random.randint(key, (n, 2, 32), 0, 100)
    cols = jax.random.randint(jax.random.fold_in(key, 1), (n, 2, 32), 0, 100)
    states, _ = jstream.ingest_instances(states, rows, cols,
                                         jnp.ones((n, 2, 32)))
    jsave(d, FLEET["step"], states)
    grown = jrebalance(jrestore(d, FLEET["step"], states), FLEET["n_new"])
    return dict(dir=d, want=tp.jax_state_to_numpy(grown),
                count=int(np.sum(np.asarray(states.n_updates))))


def _elastic_job(fleet_case):
    return ("elastic", dict(FLEET, dir=fleet_case["dir"]))


@pytest.fixture(scope="module")
def params_ckpt(lm_case, tmp_path_factory):
    """The JAX package's phi3 smoke parameters saved by the port."""
    d = str(tmp_path_factory.mktemp("params"))
    tckpt.save(d, 3, ttf.params_from_numpy(lm_case["tree"], "cpu"))
    return d


@pytest.fixture(scope="module")
def world4(lm_case, other_cases, fleet_case, params_ckpt, tmp_path_factory):
    jobs = [("lm_step", dict(arch=ARCH, tree=lm_case["tree"],
                             batch=lm_case["batch"], lr=LR)),
            ("constrain", {}), _elastic_job(fleet_case)]
    jobs += [("lm_step", dict(arch=arch, tree=c["tree"], batch=c["batch"],
                              lr=LR)) for arch, c in other_cases.items()]
    jobs += [("restore_params", dict(arch=ARCH, dir=params_ckpt, step=3))]
    return tmesh.spawn_fleet(tp.run_mesh_jobs, 4, "gloo", "cpu",
                             str(tmp_path_factory.mktemp("world4")),
                             args=(jobs,))


@pytest.fixture(scope="module")
def world2(fleet_case, tmp_path_factory):
    return tmesh.spawn_fleet(tp.run_mesh_jobs, 2, "gloo", "cpu",
                             str(tmp_path_factory.mktemp("world2")),
                             args=([_elastic_job(fleet_case)],))


def test_sharded_lm_step_loss(world4, lm_case):
    for rank in world4:
        loss = rank[0]["loss"]
        assert abs(loss - lm_case["port_loss"]) < LOSS_TOL
        assert abs(loss - lm_case["jax_loss"]) < LOSS_TOL
    assert abs(lm_case["port_loss"] - lm_case["jax_loss"]) < LOSS_TOL


@pytest.mark.parametrize("against", ("port", "jax"))
def test_sharded_lm_step_params(world4, lm_case, against):
    want = lm_case[f"{against}_params"]
    for rank in world4:
        got = rank[0]["params"]
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, rtol=RTOL, atol=ATOL,
                                       err_msg=path)


def test_sharded_lm_step_local_shards_follow_specs(world4):
    for rank in world4:
        assert rank[0]["moments_placed"]
        assert rank[0]["batch_local"] == (4, 32)     # 8 rows over "data"
        for path, local, spec_local in rank[0]["shapes"]:
            assert local == spec_local, path
    # the (256, 64) embedding: vocab over "model", D over "data"
    local = {p: l for p, l, _ in world4[0][0]["shapes"]}
    assert world4[0][0]["params"]["embed"].shape == (256, 64)
    assert local["embed"] == (128, 32)
    assert local["layers/attn/wq"] == (2, 32, 32)


@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_sharded_step_of_other_archs(world4, other_cases, arch):
    want = other_cases[arch]
    i = 3 + OTHER_ARCHS.index(arch)
    for rank in world4:
        got = rank[i]
        assert abs(got["loss"] - want["loss"]) < LOSS_TOL
        assert sorted(got["params"]) == sorted(want["params"])
        for path, w in want["params"].items():
            np.testing.assert_allclose(got["params"][path], w, rtol=RTOL,
                                       atol=ATOL, err_msg=path)
        for path, local, spec_local in got["shapes"]:
            assert local == spec_local, path


def test_lm_params_restored_under_their_specs(world4, lm_case):
    want = _flat(lm_case["tree"])
    for rank in world4:
        got = rank[-1]
        assert all(got["blocks"])
        assert sorted(got["params"]) == sorted(want)
        for path, w in want.items():
            np.testing.assert_array_equal(got["params"][path], w,
                                          err_msg=path)


def test_constrain_under_policy_on_ranks(world4):
    from torch.distributed.tensor import Replicate, Shard
    for rank in world4:
        ((rows6, pl6, ok6), (rows5, pl5, ok5)), same = rank[1]
        assert same == [True] * 4          # place == distribute_tensor
        assert (rows6, rows5) == (6, 5) and ok6 and ok5
        assert pl6 == (Shard(0), Shard(1))
        assert pl5 == (Replicate(), Shard(1))


@pytest.mark.parametrize("ranks", (2, 4))
def test_sharded_restore_and_rebalance(ranks, world2, world4, fleet_case):
    got = [r[0] for r in world2] if ranks == 2 else [r[2] for r in world4]
    for r in got:
        assert r["restored"] == FLEET["instances"] // ranks
        assert r["sharded"]
    want = fleet_case["want"]
    for k, v in want.items():
        if k == "cuts":
            continue
        joined = np.concatenate([r["state"][k] for r in got])
        np.testing.assert_array_equal(joined, v, err_msg=k)
    total = sum(int(np.sum(r["state"]["n_updates"].astype(np.int64)))
                for r in got)
    assert total == fleet_case["count"] == 8 * 2 * 32
