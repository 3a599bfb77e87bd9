"""rwkv6-3b — [ssm] 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536.

RWKV-6 "Finch": data-dependent decay linear attention [arXiv:2404.05892; hf].
Head size 64 (40 heads); channel-mix hidden 8960 = 3.5 * d_model.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        n_layers=32,
        d_model=2560,
        n_heads=40,                  # d_model / 64 time-mix heads
        n_kv_heads=40,
        d_head=64,
        d_ff=8960,
        vocab_size=65536,
        block_pattern=("rwkv",),
        act="relu",                  # rwkv channel-mix uses squared relu
        norm_eps=1e-5,
    )
