"""Port parity: the GNN forward pass of all four kinds (GAT, GIN, GatedGCN,
GraphCast), with the segment_agg kernel route on and off, against
``repro.models.gnn`` on the same JAX-initialised weights and the same
numpy graph (built by the port's own graph builders), on the CPU (where
the kernel wrapper runs its plain version); plus ``segment_softmax``,
``graph_readout``, the parameter converters and the multimesh builder.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jcfg
from repro.data import graphs as jgraphs
from repro.models import gnn as jgnn
from repro_torch.configs import registry as tcfg
from repro_torch.data import graphs as tgraphs
from repro_torch.kernels import registry as treg
from repro_torch.models import gnn as tgnn

RTOL = 1e-4   # f32 matmuls, softmax and layer norms in another order

ARCH = {"gat": "gat-cora", "gin": "gin-tu", "gatedgcn": "gatedgcn",
        "graphcast": "graphcast"}


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def _graph(kind):
    """A numpy graph from the port's builders: the multimesh (r = 2) with
    random node features for GraphCast, an R-MAT graph for the others."""
    if kind == "graphcast":
        _, src, dst = tgraphs.icosahedral_multimesh(2)
        feat = np.random.default_rng(0).normal(size=(162, 8))
        return dict(node_feat=feat.astype(np.float32), edge_src=src,
                    edge_dst=dst)
    g = tgraphs.random_graph(1, 90, 400, 12, device="cpu")
    return {k: g[k].numpy() for k in ("node_feat", "edge_src", "edge_dst")}


def _params(kind, use_kernel, d_feat, n_out):
    jc = dataclasses.replace(jcfg.get_smoke_config(ARCH[kind]),
                             use_kernel=use_kernel)
    tc = dataclasses.replace(tcfg.get_smoke_config(ARCH[kind]),
                             use_kernel=use_kernel)
    tree = jax.tree.map(np.asarray, jgnn.init(jax.random.PRNGKey(3), jc,
                                              d_feat, n_out))
    return jc, tc, tree


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("kind", sorted(ARCH))
def test_forward_matches_reference(kind, use_kernel):
    """Smoke configs (2 layers), rtol 1e-4; the reference runs its own
    route with the same switch (the Pallas kernel in interpret mode when
    on).  No launch is counted on the CPU."""
    g = _graph(kind)
    d_feat = g["node_feat"].shape[1]
    n_out = 8 if kind == "graphcast" else 5
    jc, tc, tree = _params(kind, use_kernel, d_feat, n_out)
    want = jgnn.forward(jax.tree.map(jnp.asarray, tree), jc,
                        {k: jnp.asarray(v) for k, v in g.items()})
    params = tgnn.params_from_numpy(tree, tc, device="cpu")
    treg.reset_launches()
    got = tgnn.forward(params, tc, {k: torch.from_numpy(v)
                                    for k, v in g.items()})
    assert treg.launches()["segment_agg.segment_sum"] == 0
    assert got.shape == (g["node_feat"].shape[0], n_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=RTOL)


@pytest.mark.parametrize("kind", sorted(ARCH))
def test_converters_round_trip(kind):
    _, tc, tree = _params(kind, True, 12, 5)
    params = tgnn.params_from_numpy(tree, tc, device="cpu")
    back = tgnn.params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    own = tgnn.params_to_numpy(tgnn.init(0, tc, 12, 5, device="cpu"))
    assert jax.tree.map(np.shape, own) == jax.tree.map(np.shape, tree)
    names = {n for n, _ in params.named_parameters()}
    want = {"gat": "layers.1.a_src", "gin": "layers.0.mlp.1.w",
            "gatedgcn": "layers.1.U", "graphcast": "layers.1.edge_mlp.1.w"}
    assert want[kind] in names and ("head" in names or "head.1.b" in names)


def test_segment_softmax_and_max_match_reference():
    rng = np.random.default_rng(5)
    scores = rng.normal(size=(200, 3)).astype(np.float32)
    dst = rng.integers(0, 60, 200).astype(np.int32)
    dst[dst == 7] = 8                     # node 7 receives nothing
    want = jgnn.segment_softmax(jnp.asarray(scores), jnp.asarray(dst), 60)
    got = tgnn.segment_softmax(torch.from_numpy(scores),
                               torch.from_numpy(dst), 60)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    want_max = jax.ops.segment_max(jnp.asarray(scores), jnp.asarray(dst),
                                   num_segments=60)
    got_max = tgnn.segment_max(torch.from_numpy(scores),
                               torch.from_numpy(dst), 60)
    np.testing.assert_array_equal(got_max.numpy(), np.asarray(want_max))
    assert bool(torch.isneginf(got_max[7]).all())


def test_graph_readout_on_batched_molecules():
    g = tgraphs.batched_molecules(2, 6, 30, 64, 16, device="cpu")
    assert g["node_feat"].shape == (180, 16)
    assert int(g["edge_src"].max()) < 180 and g["edge_src"].shape == (384,)
    assert bool((g["edge_src"] // 30 == g["edge_dst"] // 30).all())
    out = np.random.default_rng(6).normal(size=(180, 2)).astype(np.float32)
    want = jgnn.graph_readout(jnp.asarray(out),
                              jnp.asarray(g["graph_ids"].numpy()), 6)
    got = tgnn.graph_readout(torch.from_numpy(out), g["graph_ids"], 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("r", range(5))
def test_icosahedral_multimesh_equals_reference(r):
    want = jgraphs.icosahedral_multimesh(r)
    got = tgraphs.icosahedral_multimesh(r)
    assert got[0].shape == (10 * 4 ** r + 2, 3)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_random_graph_shapes():
    g = tgraphs.random_graph(4, 2708, 10556, 33, n_classes=7, device="cpu")
    assert g["node_feat"].shape == (2708, 33)
    for k in ("edge_src", "edge_dst"):
        assert g[k].dtype == torch.int32 and g[k].shape == (10556,)
        assert 0 <= int(g[k].min()) and int(g[k].max()) < 2708
    assert int(g["labels"].max()) < 7
    again = tgraphs.random_graph(4, 2708, 10556, 33, n_classes=7,
                                 device="cpu")
    assert torch.equal(g["edge_src"], again["edge_src"])
