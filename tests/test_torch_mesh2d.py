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
* The GNN and DCN-v2 steps under ``make_policy(mesh, "dp")`` (the GNN and
  recsys cells' layout) on the same (2, 2) mesh, from the JAX package's
  parameters: two ``gnn.make_train_step`` steps at lr 1e-2 of each kind's
  smoke config (GAT on a node task restricted to 16 seeds, GIN on the
  batched-molecule graph task, GatedGCN on a node task, GraphCast
  regressing on the r = 2 multimesh, whose 162 nodes the 4 ranks do not
  divide, so its nodes stay whole while its edges are sharded), and one
  DCN-v2 dense step at lr 1e-3 with the table's rows over both axes.
  Each loss within 5e-4 of the port's unsharded step and of the JAX
  step, every parameter within rtol 1e-4 plus a tenth of one lr step of
  both, every local shard as its spec.  DCN-v2's ``serve_scores`` and
  ``retrieval_topk`` (candidates over both axes, the query whole) equal
  the unsharded calls: scores and top-k values rtol 1e-6, top-k indices
  exactly (no ties among the scores).
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
from repro.configs import get_smoke_config as jget_smoke_cfg
from repro.models import dcn as jdcn
from repro.models import gnn as jgnn
from repro.models import transformer as jtf
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init
from repro.runtime.elastic import rebalance_instances as jrebalance
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data import graphs as tgraphs
from repro_torch.launch import mesh as tmesh
from repro_torch.models import dcn as tdcn
from repro_torch.models import gnn as tgnn
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
# kind -> (arch, seed_count); each kind's task and graph in _gnn_graph
GNN_KINDS = {"gat": ("gat-cora", 16), "gin": ("gin-tu", 0),
             "gatedgcn": ("gatedgcn", 0), "graphcast": ("graphcast", 0)}
GNN_LR, GNN_STEPS = 1e-2, 2
DCN_LR, TOPK = 1e-3, 8
SCORE_RTOL = 1e-6
# the world4 jobs: the five LM steps, constrain and elastic first, then
# the GNN kinds', DCN-v2's and the LM checkpoint's
GNN_AT = 3 + len(OTHER_ARCHS)
DCN_AT = GNN_AT + len(GNN_KINDS)


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def _flat(tree, path=""):
    if isinstance(tree, (dict, list)):
        out = {}
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
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


def _gnn_graph(kind):
    """(numpy batch, task, d_feat, n_out): node counts the 4 ranks divide
    for GAT, GatedGCN and GIN (8 molecules of 10 nodes), the r = 2
    multimesh's 162 for GraphCast."""
    rng = np.random.default_rng(11)
    if kind == "graphcast":
        _, src, dst = tgraphs.icosahedral_multimesh(2)
        return (dict(node_feat=rng.normal(size=(162, 8)).astype(np.float32),
                     edge_src=src, edge_dst=dst,
                     targets=rng.normal(size=(162, 6)).astype(np.float32)),
                "regress", 8, 6)
    if kind == "gin":
        g = tgraphs.batched_molecules(2, 8, 10, 20, 7, 3, device="cpu")
        return {k: v.numpy() for k, v in g.items()}, "graph", 7, 3
    g = tgraphs.random_graph(1, 96, 400, 12, 5, device="cpu")
    return ({k: g[k].numpy() for k in ("node_feat", "edge_src", "edge_dst",
                                       "labels")}, "node", 12, 5)


@pytest.fixture(scope="module")
def gnn_cases():
    """Each GNN kind's job, from the JAX package's smoke parameters, and
    its JAX and unsharded port steps."""
    out = {}
    for kind, (arch, seed_count) in GNN_KINDS.items():
        batch, task, d_feat, n_out = _gnn_graph(kind)
        jc = jget_smoke_cfg(arch)
        tree = jax.tree.map(np.asarray, jgnn.init(jax.random.PRNGKey(3), jc,
                                                  d_feat, n_out))
        jstep = jax.jit(jgnn.make_train_step(jc, JAdamWConfig(lr=GNN_LR),
                                             task, seed_count))
        jp = jax.tree.map(jnp.asarray, tree)
        jo, jb = jadamw_init(jp), {k: jnp.asarray(v) for k, v in batch.items()}
        cfg = get_smoke_config(arch)
        tstep = tgnn.make_train_step(cfg, AdamWConfig(lr=GNN_LR), task,
                                     seed_count)
        tparams = tgnn.params_from_numpy(tree, cfg, device="cpu")
        to = adamw_init(tparams)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        jl, tl = [], []
        for _ in range(GNN_STEPS):
            jp, jo, jm = jstep(jp, jo, jb)
            tparams, to, tm = tstep(tparams, to, tb)
            jl.append(float(jm["loss"]))
            tl.append(float(tm["loss"]))
        out[kind] = dict(
            job=dict(arch=arch, tree=tree, batch=batch, task=task,
                     seed_count=seed_count, lr=GNN_LR, steps=GNN_STEPS),
            jax_losses=jl, port_losses=tl,
            jax_params=_flat(jax.tree.map(np.asarray, jp)),
            port_params=_flat(tgnn.params_to_numpy(tparams)))
    return out


@pytest.fixture(scope="module")
def dcn_case():
    """DCN-v2's job from the JAX package's smoke parameters, its JAX and
    unsharded port steps, and the unsharded serving and retrieval."""
    jc = jget_smoke_cfg("dcn-v2")
    cfg = get_smoke_config("dcn-v2")
    tree = jax.tree.map(np.asarray, jdcn.init(jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(5)
    batch = dict(dense=rng.normal(size=(16, cfg.n_dense)).astype(np.float32),
                 sparse=rng.integers(0, 1000, (16, cfg.n_sparse)).astype(
                     np.int32),
                 labels=rng.integers(0, 2, 16).astype(np.float32))
    cands = rng.normal(size=(64, cfg.mlp[-1])).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    jp, _, jm = jax.jit(jdcn.make_train_step(jc, JAdamWConfig(lr=DCN_LR)))(
        jp, jadamw_init(jp), {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    query = {k: tb[k][:1] for k in ("dense", "sparse")}
    tparams = tdcn.params_from_numpy(tree, cfg, device="cpu")
    scores = tdcn.serve_scores(tparams, tb, cfg)
    values, indices = tdcn.retrieval_topk(tparams, query,
                                          torch.from_numpy(cands), cfg,
                                          k=TOPK)
    all_scores = tdcn.query_embedding(tparams, query, cfg) @ \
        torch.from_numpy(cands).T
    tparams, _, tm = tdcn.make_train_step(cfg, AdamWConfig(lr=DCN_LR))(
        tparams, adamw_init(tparams), tb)
    return dict(job=dict(tree=tree, batch=batch, cands=cands, lr=DCN_LR,
                         k=TOPK),
                jax_loss=float(jm["loss"]), port_loss=float(tm["loss"]),
                jax_params=_flat(jax.tree.map(np.asarray, jp)),
                port_params=_flat(tdcn.params_to_numpy(tparams)),
                scores=scores.numpy(), values=values.numpy(),
                indices=indices.numpy(), all_scores=all_scores.numpy())


def _elastic_job(fleet_case):
    return ("elastic", dict(FLEET, dir=fleet_case["dir"]))


@pytest.fixture(scope="module")
def params_ckpt(lm_case, tmp_path_factory):
    """The JAX package's phi3 smoke parameters saved by the port."""
    d = str(tmp_path_factory.mktemp("params"))
    tckpt.save(d, 3, ttf.params_from_numpy(lm_case["tree"], "cpu"))
    return d


@pytest.fixture(scope="module")
def world4(lm_case, other_cases, fleet_case, params_ckpt, gnn_cases,
           dcn_case, tmp_path_factory):
    jobs = [("lm_step", dict(arch=ARCH, tree=lm_case["tree"],
                             batch=lm_case["batch"], lr=LR)),
            ("constrain", {}), _elastic_job(fleet_case)]
    jobs += [("lm_step", dict(arch=arch, tree=c["tree"], batch=c["batch"],
                              lr=LR)) for arch, c in other_cases.items()]
    jobs += [("gnn_steps", gnn_cases[k]["job"]) for k in GNN_KINDS]
    jobs += [("dcn", dcn_case["job"])]
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


def _params_close(got: dict, want: dict, lr: float) -> None:
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=RTOL, atol=lr / 10,
                                   err_msg=path)


@pytest.mark.parametrize("kind", GNN_KINDS)
def test_sharded_gnn_steps_loss(world4, gnn_cases, kind):
    case = gnn_cases[kind]
    for rank in world4:
        got = rank[GNN_AT + list(GNN_KINDS).index(kind)]
        for against in ("port", "jax"):
            np.testing.assert_allclose(got["losses"],
                                       case[f"{against}_losses"], rtol=0,
                                       atol=LOSS_TOL)
        assert got["moments_placed"]
        for path, local, spec_local in got["shapes"]:
            assert local == spec_local, path


@pytest.mark.parametrize("against", ("port", "jax"))
@pytest.mark.parametrize("kind", GNN_KINDS)
def test_sharded_gnn_steps_params(world4, gnn_cases, kind, against):
    for rank in world4:
        got = rank[GNN_AT + list(GNN_KINDS).index(kind)]
        _params_close(got["params"], gnn_cases[kind][f"{against}_params"],
                      GNN_LR)


def test_sharded_gnn_batches_are_split(world4):
    """The graphs really are cut: edges (and nodes where 4 divides them)
    a quarter a rank."""
    locals_ = {k: world4[0][GNN_AT + i]["batch_local"]
               for i, k in enumerate(GNN_KINDS)}
    assert locals_["gat"] == dict(node_feat=(24, 12), edge_src=(100,),
                                  edge_dst=(100,), labels=(24,))
    assert locals_["gin"]["labels"] == (2,)
    assert locals_["gin"]["graph_ids"] == (20,)
    assert locals_["graphcast"]["node_feat"] == (162, 8)
    assert locals_["graphcast"]["edge_src"] == (1260 // 4,)


@pytest.mark.parametrize("against", ("port", "jax"))
def test_sharded_dcn_step(world4, dcn_case, against):
    for rank in world4:
        got = rank[DCN_AT]
        assert abs(got["loss"] - dcn_case[f"{against}_loss"]) < LOSS_TOL
        _params_close(got["params"], dcn_case[f"{against}_params"], DCN_LR)
        for path, local, spec_local in got["shapes"]:
            assert local == spec_local, path
    # the table's 4096 rows over both axes
    local = {p: l for p, l, _ in world4[0][DCN_AT]["shapes"]}
    assert local["table"] == (1024, 8)


def test_sharded_dcn_serving_and_retrieval(world4, dcn_case):
    ranked = np.sort(dcn_case["all_scores"][0])
    assert len(np.unique(ranked)) == ranked.size           # no ties
    for rank in world4:
        got = rank[DCN_AT]
        np.testing.assert_allclose(got["scores"], dcn_case["scores"],
                                   rtol=SCORE_RTOL)
        np.testing.assert_allclose(got["values"], dcn_case["values"],
                                   rtol=SCORE_RTOL)
        np.testing.assert_array_equal(got["indices"], dcn_case["indices"])
