"""Optimizers: AdamW, the hierarchical sparse-gradient accumulator and
gradient compression."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, adamw_init, adamw_update, apply_updates, clip_by_global_norm,
    warmup_cosine,
)
