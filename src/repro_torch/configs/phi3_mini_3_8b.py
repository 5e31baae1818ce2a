"""phi3-mini-3.8b [dense] — arXiv:2404.14219.

32L d_model=3072 32H (kv=32 -> MHA, d_head=96) d_ff=8192 vocab=32064,
RoPE + SwiGLU.
"""
from repro_torch.configs.base import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="phi3-mini-3.8b",
        vocab=32_064, d_model=3072, n_layers=32,
        n_heads=32, n_kv_heads=32, d_head=96,
        d_ff=8192,
        rope_theta=10_000.0,
        num_microbatches=4, prefill_microbatch=16,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="phi3-mini-smoke",
        vocab=256, d_model=64, n_layers=2,
        n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, dtype="float32",
    )
