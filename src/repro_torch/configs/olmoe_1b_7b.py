"""olmoe-1b-7b — [moe] 16L d_model=2048 16H (kv=16) d_ff=1024, MoE 64e top-8.

64 experts, top-8 routing, vocab 50304 [arXiv:2409.02060; hf].
"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_head=128,
        d_ff=1024,
        vocab_size=50304,
        block_pattern=("attn_moe",),
        moe=MoEConfig(n_experts=64, experts_per_token=8, d_ff=1024),
        rope_theta=10_000.0,
        act="silu",
    )
