"""graphcast [gnn] — arXiv:2212.12794 (Lam et al., GraphCast).

Encoder-processor-decoder mesh GNN: 16 InteractionNetwork processor layers,
d_hidden=512, sum aggregator, n_vars=227 output channels (per-node
regression), mesh_refinement=6 (the icosahedral multi-mesh of
``data/graphs.py::icosahedral_multimesh``: 40,962 nodes, 327,660 edges).
"""
from repro_torch.configs.base import GNNConfig


def config() -> GNNConfig:
    return GNNConfig(name="graphcast", kind="graphcast", n_layers=16,
                     d_hidden=512, aggregator="sum", mesh_refinement=6,
                     n_vars=227)


def smoke_config() -> GNNConfig:
    return GNNConfig(name="graphcast-smoke", kind="graphcast", n_layers=2,
                     d_hidden=32, aggregator="sum", mesh_refinement=2,
                     n_vars=8)
