"""llama3.2-3b — [dense] 28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256.

Small llama3 [hf:meta-llama/Llama-3.2-3B; unverified].
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_head=128,
        d_ff=8192,
        vocab_size=128256,
        block_pattern=("attn_mlp",),
        rope_theta=500_000.0,
        tie_embeddings=True,
        act="silu",
    )
