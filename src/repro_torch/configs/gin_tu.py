"""gin-tu [gnn] — arXiv:1810.00826 (Xu et al., GIN on TU datasets).

5 layers, 64 hidden, sum aggregator, learnable eps.
"""
from repro_torch.configs.base import GNNConfig


def config() -> GNNConfig:
    return GNNConfig(name="gin-tu", kind="gin", n_layers=5, d_hidden=64,
                     aggregator="sum", learnable_eps=True)


def smoke_config() -> GNNConfig:
    return GNNConfig(name="gin-tu-smoke", kind="gin", n_layers=2,
                     d_hidden=16, aggregator="sum", learnable_eps=True)
