"""Architecture configs of every family, and their registry."""
from repro_torch.configs.base import (  # noqa: F401
    D4M_SHAPES, GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, SHAPES_BY_FAMILY,
    D4MConfig, GNNConfig, LMConfig, RecsysConfig,
)
from repro_torch.configs.registry import (  # noqa: F401
    ARCHS, family, get_config, get_smoke_config, list_archs,
)
