"""granite-moe-3b-a800m [moe] — hf:ibm-granite/granite-3.0-3b-a800m-base.

32L d_model=1536 24H (GQA kv=8, d_head=64) vocab=49155; MoE 40 experts
top-8, expert d_ff=512, no shared experts — the same values as
``repro/configs/granite_moe_3b_a800m.py``.  ``moe_shard="tp"`` is kept for
``dataclasses.asdict`` equality; the port runs on one card and shards
nothing, so it changes nothing.
"""
from repro_torch.configs.base import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="granite-moe-3b-a800m",
        vocab=49_155, d_model=1536, n_layers=32,
        n_heads=24, n_kv_heads=8, d_head=64,
        d_ff=512,
        moe=True, n_experts=40, top_k=8, n_shared=0, d_ff_expert=512,
        moe_shard="tp",
        rope_theta=10_000.0,
        tie_embeddings=True,
        num_microbatches=8, prefill_microbatch=16,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="granite-moe-smoke",
        vocab=256, d_model=48, n_layers=2,
        n_heads=6, n_kv_heads=2, d_head=8,
        d_ff=64,
        moe=True, n_experts=5, top_k=2, n_shared=0, d_ff_expert=32,
        moe_shard="tp", tie_embeddings=True, dtype="float32",
    )
