"""smollm-360m [dense] — hf:HuggingFaceTB/SmolLM-360M (llama arch, small).

32L d_model=960 15H (GQA kv=5, d_head=64) d_ff=2560 vocab=49152, tied
embeddings.
"""
from repro_torch.configs.base import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="smollm-360m",
        vocab=49_152, d_model=960, n_layers=32,
        n_heads=15, n_kv_heads=5, d_head=64,
        d_ff=2560,
        rope_theta=10_000.0,
        tie_embeddings=True,
        num_microbatches=4, prefill_microbatch=16,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="smollm-smoke",
        vocab=256, d_model=60, n_layers=2,
        n_heads=3, n_kv_heads=1, d_head=20,
        d_ff=96, tie_embeddings=True, dtype="float32",
    )
