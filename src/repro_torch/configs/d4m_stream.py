"""d4m-stream — the paper's own workload: hierarchical associative-array
streaming ingest, each device running ``instances_per_device`` independent
hierarchies over R-MAT update blocks, plus the read path's query knobs.
The same values as ``repro/configs/d4m_stream.py``."""
from repro_torch.configs.base import D4MConfig


def config() -> D4MConfig:
    return D4MConfig(
        name="d4m-stream",
        cuts=(2048, 16384, 131072),
        block_size=1024,
        blocks_per_step=8,
        instances_per_device=4,
        rmat_scale=22,
        fused=True,
        lazy_l0=True,
        chunk=1,
        batch_mode="grouped",
    )


def smoke_config() -> D4MConfig:
    return D4MConfig(
        name="d4m-stream-smoke",
        cuts=(64, 256),
        block_size=32,
        blocks_per_step=4,
        instances_per_device=2,
        rmat_scale=10,
        fused=True,
        lazy_l0=True,
        chunk=2,
        batch_mode="grouped",
    )
