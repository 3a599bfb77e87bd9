"""llama-3.2-vision-90b — [vlm] 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — cross-attn image layers [hf:meta-llama/Llama-3.2-90B-Vision;
unverified].

Backbone only: every 5th layer is a gated cross-attention layer attending to
precomputed image patch embeddings (modality frontend is a STUB; input_specs
provides the patch-embedding tensor directly, per task spec).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        n_layers=100,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_head=128,
        d_ff=28672,
        vocab_size=128256,
        block_pattern=("attn_mlp", "attn_mlp", "attn_mlp", "attn_mlp", "xattn_mlp"),
        n_image_tokens=4096,
        rope_theta=500_000.0,
        act="silu",
    )
