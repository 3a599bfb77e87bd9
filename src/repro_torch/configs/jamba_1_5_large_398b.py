"""jamba-1.5-large-398b — [hybrid] 72L d_model=8192 64H (GQA kv=8) d_ff=24576,
MoE 16e top-2, vocab 65536 — Mamba+attention 1:7 interleave [arXiv:2403.19887; hf].

Jamba period-8 block: attention at index 4, Mamba elsewhere; MoE FFN on every
second layer (odd indices), dense FFN otherwise. 72 layers = 9 blocks.
Total params ~398B, active ~94B (top-2 of 16 experts).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_head=128,
        d_ff=24576,
        vocab_size=65536,
        block_pattern=(
            "mamba", "mamba_moe", "mamba", "mamba_moe",
            "attn", "mamba_moe", "mamba", "mamba_moe",
        ),
        moe=MoEConfig(n_experts=16, experts_per_token=2, d_ff=24576),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
        rope_theta=10_000.0,   # jamba attention layers are NoPE in the paper; kept for generality
        act="silu",
    )
