"""Checkpointing: one .npy per leaf + manifest, atomic, async; the JAX
package's on-disk format."""
from repro_torch.checkpoint.ckpt import (  # noqa: F401
    MIGRATED_LEAVES, AsyncCheckpointer, latest_step, restore, save,
)
