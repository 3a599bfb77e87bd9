"""Architecture registry of the port: every arch of the reference.

``get_config(arch)`` returns the same config as the JAX package for the four
dense decoders, the two MoE decoders, the two recurrent-state decoders
(rwkv6-3b, and the hybrid jamba) and the two cross-attention models
(llama-3.2-vision-90b's gated image layers, seamless-m4t-medium's encoder
and decoder), in the reference's order; ``base.py`` and the per-arch
modules are copies of the reference's.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig, reduce_for_smoke

# arch id -> module name
_ARCH_MODULES: Dict[str, str] = {
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "llama3.2-3b": "repro_torch.configs.llama3_2_3b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "llama-3.2-vision-90b": "repro_torch.configs.llama3_2_vision_90b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
}

ARCH_IDS: Tuple[str, ...] = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port serves "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).config()


__all__ = ["ARCH_IDS", "ModelConfig", "get_config", "reduce_for_smoke"]
