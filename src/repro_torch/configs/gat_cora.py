"""gat-cora [gnn] — arXiv:1710.10903 (Velickovic et al., GAT).

2 layers, 8 hidden units per head, 8 heads, attention aggregator (edge
scores -> segment softmax -> segment sum).  Final layer averages heads.
"""
from repro_torch.configs.base import GNNConfig


def config() -> GNNConfig:
    return GNNConfig(name="gat-cora", kind="gat", n_layers=2, d_hidden=8,
                     n_heads=8, aggregator="attn")


def smoke_config() -> GNNConfig:
    return GNNConfig(name="gat-cora-smoke", kind="gat", n_layers=2,
                     d_hidden=4, n_heads=2, aggregator="attn")
