"""Runtime resilience: stragglers and elastic instance counts."""
from repro_torch.runtime.elastic import rebalance_instances  # noqa: F401
from repro_torch.runtime.straggler import (  # noqa: F401
    StragglerEvicted, StragglerMonitor,
)
