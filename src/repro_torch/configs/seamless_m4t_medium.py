"""seamless-m4t-medium — [audio] 12L d_model=1024 16H (kv=16) d_ff=4096
vocab=256206 — encoder-decoder, multimodal [arXiv:2308.11596; hf].

Backbone only: a 12L transformer encoder over precomputed audio-frame
embeddings (modality frontend is a STUB per task spec) and a 12L decoder with
cross-attention.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        family="encdec",
        n_layers=12,                 # decoder depth
        n_enc_layers=12,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_head=64,
        d_ff=4096,
        vocab_size=256206,
        block_pattern=("cross_mlp",),
        enc_block_pattern=("attn_mlp",),
        rope_theta=10_000.0,
        act="relu",
        norm_eps=1e-5,
    )
