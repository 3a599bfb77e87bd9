"""gemma2-2b — [dense] 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.

Local+global alternating attention, logit softcap [arXiv:2408.00118; hf].
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        d_head=256,
        d_ff=9216,
        vocab_size=256_000,
        # alternating local (sliding-window) / global attention, scanned in pairs
        block_pattern=("attn_mlp_local", "attn_mlp"),
        sliding_window=4096,
        attn_softcap=50.0,
        logit_softcap=30.0,
        rope_theta=10_000.0,
        tie_embeddings=True,
        scale_embeddings=True,
        act="gelu",
        norm_eps=1e-6,
    )
