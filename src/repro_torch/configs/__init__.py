"""Architecture configs of the ported families, and their registry."""
from repro_torch.configs.base import (  # noqa: F401
    D4MConfig, GNN_SHAPES, RECSYS_SHAPES, GNNConfig, RecsysConfig,
)
from repro_torch.configs.registry import (  # noqa: F401
    ARCHS, family, get_config, get_smoke_config, list_archs,
)
