"""kimi-k2-1t-a32b — [moe] 61L d_model=7168 64H (GQA kv=8) expert d_ff=2048,
MoE 384e top-8, vocab 163840 — trillion-param MoE [arXiv:2501.kimi2; unverified].

DeepSeek-V3-style layout: first layer dense, remaining 60 layers MoE with one
shared expert. Dense-layer FFN width = 8 * expert width (18432 in the real
model; we use 8*2048=16384 to stay within the published table's parameters).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_head=112,
        d_ff=16384,                 # dense first layer width
        vocab_size=163840,
        block_pattern=("attn_moe",),
        first_k_dense=1,
        moe=MoEConfig(n_experts=384, experts_per_token=8, d_ff=2048,
                      n_shared_experts=1),
        rope_theta=50_000.0,
        act="silu",
    )
