"""mistral-nemo-12b [dense] — hf:mistralai/Mistral-Nemo-Base-2407.

40L d_model=5120 32H (GQA kv=8, d_head=128) d_ff=14336 vocab=131072,
128k context (rope_theta=1e6).
"""
from repro_torch.configs.base import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="mistral-nemo-12b",
        vocab=131_072, d_model=5120, n_layers=40,
        n_heads=32, n_kv_heads=8, d_head=128,
        d_ff=14_336,
        rope_theta=1_000_000.0,
        num_microbatches=8, prefill_microbatch=16,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="mistral-nemo-smoke",
        vocab=256, d_model=64, n_layers=2,
        n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, dtype="float32",
    )
