"""dcn-v2 [recsys] — arXiv:2008.13535 (Wang et al., DCN-v2).

13 dense + 26 sparse features, embed_dim=16, 3 full-rank cross layers,
deep MLP 1024-1024-512, stacked Criteo-style tables (~96M rows total).
"""
from repro_torch.configs.base import RecsysConfig


def config() -> RecsysConfig:
    return RecsysConfig(name="dcn-v2")


def smoke_config() -> RecsysConfig:
    return RecsysConfig(
        name="dcn-v2-smoke",
        n_dense=4, n_sparse=6, embed_dim=8, n_cross_layers=2,
        mlp=(32, 16),
        table_sizes=(1000, 500, 200, 100, 50, 20))
