"""deepseek-v2-236b [moe] — arXiv:2405.04434 (hf: deepseek-ai/DeepSeek-V2).

60L d_model=5120 128H MLA(kv_lora=512, q_lora=1536, nope=128, rope=64,
v=128) vocab=102400; MoE: 160 routed experts top-6 + 2 shared, expert
d_ff=1536.  (The released model keeps layer 0 dense with d_ff=12288; we run
homogeneous MoE layers, as ``repro/configs/deepseek_v2_236b.py`` does.)

236B total / ~21B active params.
"""
from repro_torch.configs.base import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="deepseek-v2-236b",
        vocab=102_400, d_model=5120, n_layers=60,
        n_heads=128, n_kv_heads=128, d_head=128,
        d_ff=12_288,
        attn="mla", q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        moe=True, n_experts=160, top_k=6, n_shared=2, d_ff_expert=1536,
        moe_shard="ep",                 # 160 % 16 == 0
        rope_theta=10_000.0,
        num_microbatches=16, prefill_microbatch=16,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="deepseek-v2-smoke",
        vocab=256, d_model=64, n_layers=2,
        n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128,
        attn="mla", q_lora_rank=32, kv_lora_rank=16,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        moe=True, n_experts=8, top_k=2, n_shared=1, d_ff_expert=32,
        dtype="float32", num_microbatches=2,
    )
