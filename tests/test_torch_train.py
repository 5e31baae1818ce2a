"""Port parity of training: DCN-v2's dense and hierarchical steps, the
four GNN kinds' steps for their tasks (``remat`` on == off, ``seed_count``),
the node-flow sampler, and the kernel routes refusing autograd — against
``repro.models.{dcn,gnn}`` on the same JAX-initialised weights and numpy
batches, on the CPU.  Losses within rtol 1e-5, DCN-v2 parameters and
``gnorm`` within rtol 1e-4 (f32 matmuls and the table gradient's
duplicate-id sums are taken in another order).

For the GNN kinds the gradients of the first step are held within a max
relative error of 1e-4 per leaf (max |a - b| / max |b|, the measure of
``chip_smoke.py``'s GNN checks), the losses of three steps within rtol
1e-5, and the parameters after them within rtol 1e-4 plus a tenth of one
learning-rate step (atol lr / 10): AdamW's per-element step
m / (sqrt(v) + eps) turns a rounding difference in a gradient of the size
of eps (1e-8) into a visible fraction of lr — in a GatedGCN step a
gradient of -6.4e-9 in one package and -4.2e-9 in the other moves the
weight by 0.39 lr and 0.30 lr."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jcfg
from repro.data import graphs as jgraphs
from repro.models import dcn as jdcn
from repro.models import gnn as jgnn
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.optim.adamw import adamw_init as jadamw_init
from repro_torch.configs import registry as tcfg
from repro_torch.data import graphs as tgraphs
from repro_torch.kernels.embedding_bag import ops as teb_ops
from repro_torch.kernels.segment_agg import ops as tseg_ops
from repro_torch.models import common
from repro_torch.models import dcn as tdcn
from repro_torch.models import gnn as tgnn
from repro_torch.optim.adamw import AdamWConfig, adamw_init

LOSS_RTOL, PARAM_RTOL, ATOL = 1e-5, 1e-4, 1e-6
STEPS = 5


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(got, want, rtol=PARAM_RTOL, what="", atol=ATOL):
    """A port tree (module or nested dicts) against a JAX pytree, leaf for
    leaf in the JAX order."""
    g, w = common.tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        assert tuple(a.shape) == b.shape, what
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=rtol, atol=atol, err_msg=what)


def max_rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b| (chip_smoke.py's measure)."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


# ------------------------------------------------------------------ DCN-v2 --

def _dcn_batches(cfg, b, n, hot=None):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        shape = (b, cfg.n_sparse) if hot is None else (b, cfg.n_sparse, hot)
        out.append(dict(
            dense=rng.normal(size=(b, cfg.n_dense)).astype(np.float32),
            # a small id range: duplicated rows in every batch
            sparse=rng.integers(0, 40, shape).astype(np.int32),
            labels=(rng.random(b) < 0.5).astype(np.float32)))
    return out


def _dcn_setup(hot=None):
    jc = jcfg.get_smoke_config("dcn-v2")
    tc = tcfg.get_smoke_config("dcn-v2")
    tree = _np(jdcn.init(jax.random.PRNGKey(0), jc))
    return jc, tc, tree, _dcn_batches(tc, 16, STEPS, hot)


@pytest.mark.parametrize("hot", [None, 2])
def test_dcn_dense_steps_match_reference(hot):
    jc, tc, tree, batches = _dcn_setup(hot)
    opt = JAdamW(lr=1e-2)
    jstep = jax.jit(jdcn.make_train_step(jc, opt))
    jp = jax.tree.map(jnp.asarray, tree)
    jo = jadamw_init(jp)
    tstep = tdcn.make_train_step(tc, AdamWConfig(lr=1e-2))
    tp = tdcn.params_from_numpy(tree, tc, device="cpu")
    to = adamw_init(tp)
    for b in batches:
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tm = tstep(tp, to, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["gnorm"]), float(jm["gnorm"]),
                                   rtol=PARAM_RTOL)
    _assert_tree_close(tp, jp, what="params")
    _assert_tree_close(to["m"], jo["m"], what="m")
    _assert_tree_close(to["v"], jo["v"], rtol=1e-3, what="v")
    assert int(to["count"]) == int(jo["count"]) == STEPS
    assert to["count"].dtype == torch.int32
    # the serving functions build no graph after training
    assert not any(p.requires_grad for p in tp.parameters())


def test_dcn_hier_steps_match_reference():
    """Cuts small enough that layers spill and the deepest one drains;
    ``drain_every`` 3 forces a periodic drain too.  Keys, nnz, spills,
    overflow and the int32 counter exact."""
    jc, tc, tree, batches = _dcn_setup()
    cuts = (64, 128, 256)
    kw = dict(embed_lr=0.5, drain_every=3)
    jstep = jax.jit(jdcn.make_train_step_hier(jc, JAdamW(lr=1e-2), **kw))
    jp = jax.tree.map(jnp.asarray, tree)
    jrest = {k: v for k, v in jp.items() if k != "table"}
    jo, jh = jadamw_init(jrest), jdcn.hier_embed_init(jc, 16, cuts)
    tstep = tdcn.make_train_step_hier(tc, AdamWConfig(lr=1e-2), **kw)
    tp = tdcn.params_from_numpy(tree, tc, device="cpu")
    to = adamw_init(tdcn.rest_params(tp))
    th = tdcn.hier_embed_init(tc, 16, cuts, device="cpu")
    drained = []
    for b in batches:
        jp, jo, jh, jm = jstep(jp, jo, jh,
                               {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, th, tm = tstep(tp, to, th, {k: torch.from_numpy(v)
                                            for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["gnorm"]), float(jm["gnorm"]),
                                   rtol=PARAM_RTOL)
        for k in ("pending_nnz", "spills", "drained"):
            np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]),
                                          err_msg=k)
        drained.append(bool(tm["drained"]))
    assert any(drained) and not all(drained)
    _assert_tree_close(tp, jp, what="params")
    for tl, jl in zip(th.hier.layers, jh.hier.layers):
        np.testing.assert_array_equal(tl.key.numpy(), np.asarray(jl.key))
        np.testing.assert_array_equal(tl.nnz.numpy(), np.asarray(jl.nnz))
        np.testing.assert_allclose(tl.val.numpy(), np.asarray(jl.val),
                                   rtol=PARAM_RTOL, atol=ATOL)
    for f in ("spills", "overflow", "n_updates"):
        got, want = getattr(th.hier, f), np.asarray(getattr(jh.hier, f))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
    assert int(th.steps) == int(jh.steps) == STEPS


def test_hier_path_applies_exact_mass():
    """The port's counterpart of the reference's
    ``test_hier_path_eventually_applies_exact_mass``: with lr 0, embed_lr 1
    and a drain every step, the table moves by exactly minus the direct
    scatter of the embedding gradient."""
    _, tc, tree, batches = _dcn_setup()
    tp = tdcn.params_from_numpy(tree, tc, device="cpu")
    table0 = tp.table.detach().clone()
    step = tdcn.make_train_step_hier(tc, AdamWConfig(lr=0.0), embed_lr=1.0,
                                     drain_every=1)
    rest = tdcn.rest_params(tp)
    rest0 = [x.clone() for x in common.tree_leaves(rest)]
    h = tdcn.hier_embed_init(tc, 16, (512, 2048, 8192), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    p2, _, h2, m = step(tp, adamw_init(rest), h, batch)
    assert bool(m["drained"]) and int(m["pending_nnz"]) == 0
    for a, b in zip(common.tree_leaves(tdcn.rest_params(p2)), rest0):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    gids = tdcn.global_ids(batch["sparse"], tc)
    embeds = tdcn.embed_lookup(table0, batch["sparse"], tc)

    def loss(e):
        hdn = tdcn.interact(tp, batch["dense"], e, tc)
        logits = (hdn @ tp.logit_w)[:, 0] + tp.logit_b
        return tdcn.bce(logits, batch["labels"]), {}

    (_, _), (g_e,) = common.value_and_grad(loss, embeds)
    direct = table0.index_add(0, gids.reshape(-1).long(),
                              -g_e.reshape(-1, tc.embed_dim))
    np.testing.assert_allclose(p2.table.numpy(), direct.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_bce_splits_the_gradient_at_zero_as_jax():
    x = np.array([-1.0, 0.0, 0.0, 2.0], np.float32)
    y = np.array([0.0, 1.0, 0.0, 1.0], np.float32)
    want = jax.grad(lambda x: jdcn.bce(x, jnp.asarray(y)))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    tdcn.bce(t, torch.from_numpy(y)).backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-6)


# --------------------------------------------------------------------- GNN --

ARCH = {"gat": "gat-cora", "gin": "gin-tu", "gatedgcn": "gatedgcn",
        "graphcast": "graphcast"}


def _gnn_batch(kind):
    """(numpy batch, task, d_feat, n_out) for one kind: GraphCast regresses
    on the r = 2 multimesh, GIN classifies batched molecules, GAT and
    GatedGCN classify the nodes of an R-MAT graph."""
    rng = np.random.default_rng(11)
    if kind == "graphcast":
        _, src, dst = tgraphs.icosahedral_multimesh(2)
        n, d_feat, n_out = 162, 8, 6
        return (dict(node_feat=rng.normal(size=(n, d_feat)).astype(
            np.float32), edge_src=src, edge_dst=dst,
            targets=rng.normal(size=(n, n_out)).astype(np.float32)),
            "regress", d_feat, n_out)
    if kind == "gin":
        g = tgraphs.batched_molecules(2, 6, 10, 20, 7, 3, device="cpu")
        return ({k: v.numpy() for k, v in g.items()}, "graph", 7, 3)
    g = tgraphs.random_graph(1, 90, 400, 12, 5, device="cpu")
    return ({k: g[k].numpy() for k in ("node_feat", "edge_src", "edge_dst",
                                       "labels")}, "node", 12, 5)


GNN_LR = 1e-2


def _gnn_steps(kind, remat=True, seed_count=0, steps=3):
    batch, task, d_feat, n_out = _gnn_batch(kind)
    jc = dataclasses.replace(jcfg.get_smoke_config(ARCH[kind]), remat=remat)
    tc = dataclasses.replace(tcfg.get_smoke_config(ARCH[kind]), remat=remat)
    tree = _np(jgnn.init(jax.random.PRNGKey(3), jc, d_feat, n_out))
    jstep = jax.jit(jgnn.make_train_step(jc, JAdamW(lr=GNN_LR), task,
                                         seed_count))
    tstep = tgnn.make_train_step(tc, AdamWConfig(lr=GNN_LR), task,
                                 seed_count)
    jp = jax.tree.map(jnp.asarray, tree)
    jo = jadamw_init(jp)
    tp = tgnn.params_from_numpy(tree, tc, device="cpu")
    to = adamw_init(tp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    # the first step's gradients
    jloss = jgnn.make_loss_fn(jc, task, seed_count)
    jg = jax.grad(lambda p: jloss(p, jb)[0])(jp)
    tloss = tgnn.make_loss_fn(tc, task, seed_count)
    _, (tg,) = common.value_and_grad(lambda p: tloss(p, tb), tp)
    for a, b in zip(common.tree_leaves(tg), jax.tree.leaves(jg)):
        assert a.shape == b.shape
        assert max_rel_err(a, torch.from_numpy(np.asarray(b))) <= PARAM_RTOL
        assert bool((a == 0).all()) == bool((np.asarray(b) == 0).all())
    tm_all = []
    for _ in range(steps):
        jp, jo, jm = jstep(jp, jo, jb)
        tp, to, tm = tstep(tp, to, tb)
        for k in ("loss", "acc"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=LOSS_RTOL, err_msg=k)
        np.testing.assert_allclose(float(tm["gnorm"]), float(jm["gnorm"]),
                                   rtol=PARAM_RTOL)
        tm_all.append(tm)
    _assert_tree_close(tp, jp, what=kind, atol=GNN_LR / 10)
    return tp, tm_all


@pytest.mark.parametrize("kind", sorted(ARCH))
def test_gnn_steps_match_reference(kind):
    _gnn_steps(kind)


@pytest.mark.parametrize("kind", sorted(ARCH))
def test_remat_on_equals_off(kind):
    """Checkpointed layers recompute the same values: the gradients with
    remat on equal those with it off within a max relative error of 1e-5
    per leaf (a node's gradient contributions are summed in another order
    when the graph is cut at the layers)."""
    batch, task, d_feat, n_out = _gnn_batch(kind)
    grads = []
    for remat in (True, False):
        tc = dataclasses.replace(tcfg.get_smoke_config(ARCH[kind]),
                                 remat=remat)
        params = tgnn.init(2, tc, d_feat, n_out, device="cpu")
        loss_fn = tgnn.make_loss_fn(tc, task)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        _, (g,) = common.value_and_grad(lambda p: loss_fn(p, tb), params)
        grads.append(common.tree_leaves(g))
    for a, b in zip(*grads):
        assert max_rel_err(a, b) <= 1e-5


def test_seed_count_restricts_the_node_loss():
    _, ms = _gnn_steps("gat", seed_count=16, steps=2)
    assert ms[0]["acc"] * 16 == torch.round(ms[0]["acc"] * 16)


# ----------------------------------------------------------------- sampler --

def _csr_graph():
    g = tgraphs.random_graph(4, 300, 2000, 4, device="cpu")
    # node 299 isolated: no edge leaves it
    keep = g["edge_src"] != 299
    return g["edge_src"][keep], g["edge_dst"][keep], 300


def test_to_csr_and_flow_helpers_match_reference():
    src, dst, n = _csr_graph()
    want = jgraphs.to_csr(jnp.asarray(src.numpy()), jnp.asarray(dst.numpy()),
                          n)
    got = tgraphs.to_csr(src, dst, n)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    fanouts = (3, 2)
    rng = np.random.default_rng(0)
    frontiers = [rng.integers(0, n, 4 * int(np.prod(fanouts[:l]))).astype(
        np.int32) for l in range(len(fanouts) + 1)]
    jf = [jnp.asarray(f) for f in frontiers]
    tf = [torch.from_numpy(f) for f in frontiers]
    for (ts, td), (js, jd) in zip(tgraphs.flow_edges(tf, fanouts),
                                  jgraphs.flow_edges(jf, fanouts)):
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    for a, b in zip(tgraphs.flow_subgraph(tf, fanouts),
                    jgraphs.flow_subgraph(jf, fanouts)):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tgraphs.flow_sizes(1024, (15, 10)) == \
        jgraphs.flow_sizes(1024, (15, 10)) == (169_984, 168_960)


def test_sample_node_flow_invariants():
    """Shapes; every sample is a neighbour of its parent (an isolated node
    samples itself); the same generator seed draws the same flow."""
    src, dst, n = _csr_graph()
    indptr, indices = tgraphs.to_csr(src, dst, n)
    seeds = torch.tensor([0, 5, 299, 17], dtype=torch.int32)
    fanouts = (4, 3)
    flow = tgraphs.sample_node_flow(torch.Generator().manual_seed(1), indptr,
                                    indices, seeds, fanouts)
    again = tgraphs.sample_node_flow(torch.Generator().manual_seed(1),
                                     indptr, indices, seeds, fanouts)
    assert [f.shape[0] for f in flow] == [4, 16, 48]
    assert all(torch.equal(a, b) for a, b in zip(flow, again))
    nbrs = {}
    for s, d in zip(src.tolist(), dst.tolist()):
        nbrs.setdefault(s, set()).add(d)
    for l, f in enumerate(fanouts):
        par = flow[l].repeat_interleave(f).tolist()
        for p, c in zip(par, flow[l + 1].tolist()):
            assert c in nbrs.get(p, {p}), (l, p, c)
    assert set(flow[1][8:12].tolist()) == {299}


# ------------------------------------------------- kernels refuse autograd --

def test_kernel_routes_refuse_autograd_in_both_packages():
    """A train step with ``use_kernel=True`` raises NotImplementedError in
    the reference (its pallas_calls have no differentiation rule) and in
    the port (on every device); the plain routes train."""
    jc, tc, tree, batches = _dcn_setup()
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    tb = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    jp = jax.tree.map(jnp.asarray, tree)
    with pytest.raises(NotImplementedError):
        jdcn.make_train_step(dataclasses.replace(jc, use_kernel=True),
                             JAdamW())(jp, jadamw_init(jp), jb)
    tk = dataclasses.replace(tc, use_kernel=True)
    tp = tdcn.params_from_numpy(tree, tk, device="cpu")
    with pytest.raises(NotImplementedError, match="no backward"):
        tdcn.make_train_step(tk, AdamWConfig())(tp, adamw_init(tp), tb)

    batch, task, d_feat, n_out = _gnn_batch("gat")
    jg = dataclasses.replace(jcfg.get_smoke_config("gat-cora"),
                             use_kernel=True)
    tg = dataclasses.replace(tcfg.get_smoke_config("gat-cora"),
                             use_kernel=True)
    gtree = _np(jgnn.init(jax.random.PRNGKey(3), jg, d_feat, n_out))
    gp = jax.tree.map(jnp.asarray, gtree)
    with pytest.raises(NotImplementedError):
        jgnn.make_train_step(jg, JAdamW(), task)(
            gp, jadamw_init(gp), {k: jnp.asarray(v) for k, v in batch.items()})
    tgp = tgnn.params_from_numpy(gtree, tg, device="cpu")
    with pytest.raises(NotImplementedError, match="no backward"):
        tgnn.make_train_step(tg, AdamWConfig(), task)(
            tgp, adamw_init(tgp), {k: torch.from_numpy(v)
                                   for k, v in batch.items()})


def test_kernel_wrappers_refuse_grad_only_when_asked_to_differentiate():
    table = torch.randn(10, 4)
    idx = torch.tensor([[1, 2], [3, 3]], dtype=torch.int32)
    msgs = torch.randn(6, 4)
    ids = torch.tensor([0, 1, 1, 3, 2, 0])
    # no grad required: both routes run, the kernel route as before
    base = teb_ops.embedding_bag(table, idx)
    torch.testing.assert_close(base, teb_ops.embedding_bag(
        table, idx, use_kernel=False))
    seg = tseg_ops.segment_sum(msgs, ids, num_segments=4)
    for x in (table, msgs):
        x.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="embedding_bag"):
        teb_ops.embedding_bag(table, idx)
    with pytest.raises(NotImplementedError, match="segment_sum"):
        tseg_ops.segment_sum(msgs, ids, num_segments=4)
    with pytest.raises(NotImplementedError, match="embedding_bag"):
        teb_ops.embedding_bag(table.detach(), idx,
                              weights=torch.ones(2, 2, requires_grad=True))
    with torch.no_grad():                          # grad mode off: runs
        torch.testing.assert_close(teb_ops.embedding_bag(table, idx), base)
        torch.testing.assert_close(
            tseg_ops.segment_sum(msgs, ids, num_segments=4), seg)
    # the plain routes differentiate, as the reference's do
    teb_ops.embedding_bag(table, idx, use_kernel=False).sum().backward()
    tseg_ops.segment_sum(msgs, ids, num_segments=4,
                         use_kernel=False).sum().backward()
    assert table.grad is not None and msgs.grad is not None
