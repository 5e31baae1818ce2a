"""Mesh-level distribution: sharding policies and activation constraints
over a ``torch.distributed`` ``DeviceMesh``."""
from repro_torch.distribution.sharding import (  # noqa: F401
    ShardingPolicy, constrain, current_policy, use_policy,
)
