"""gatedgcn [gnn] — arXiv:2003.00982 (Dwivedi et al. benchmarking suite).

16 layers, 70 hidden, gated-edge aggregator (Bresson & Laurent GatedGCN
with edge-feature recurrence, residuals, and normalization).
"""
from repro_torch.configs.base import GNNConfig


def config() -> GNNConfig:
    return GNNConfig(name="gatedgcn", kind="gatedgcn", n_layers=16,
                     d_hidden=70, aggregator="gated")


def smoke_config() -> GNNConfig:
    return GNNConfig(name="gatedgcn-smoke", kind="gatedgcn", n_layers=2,
                     d_hidden=16, aggregator="gated")
