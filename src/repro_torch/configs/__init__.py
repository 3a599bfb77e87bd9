"""Architecture registry of the port: every arch of the reference.

``get_config(arch)`` returns the same config as the JAX package for the four
dense decoders, the two MoE decoders, the two recurrent-state decoders
(rwkv6-3b, and the hybrid jamba) and the two cross-attention models
(llama-3.2-vision-90b's gated image layers, seamless-m4t-medium's encoder
and decoder), in the reference's order; ``base.py`` and the per-arch
modules are copies of the reference's. ``SHAPES`` and ``all_cells`` are
the reference's dry-run cells.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig, reduce_for_smoke

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

# the dry run's shapes, the reference's
SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", seq_len=4096, global_batch=256,
                            kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32768, global_batch=32,
                               kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32768, global_batch=128,
                              kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524288, global_batch=1,
                             kind="decode"),
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port serves "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).config()


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cell_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """None if the (arch, shape) cell is runnable, else the reason (the
    reference's)."""
    if shape.name == "long_500k" and not cfg.has_subquadratic_path:
        return ("long_500k requires a sub-quadratic attention path; "
                f"{cfg.name} is pure full-attention (see DESIGN.md §7)")
    return None


def all_cells(include_skipped: bool = True
              ) -> List[Tuple[str, str, Optional[str]]]:
    """All 40 (arch, shape, skip_reason) cells in registry order."""
    cells = [(arch, sname, cell_skip_reason(get_config(arch), shape))
             for arch in ARCH_IDS for sname, shape in SHAPES.items()]
    return cells if include_skipped else [c for c in cells if c[2] is None]


__all__ = ["ARCH_IDS", "ModelConfig", "SHAPES", "ShapeConfig", "all_cells",
           "cell_skip_reason", "get_config", "get_shape", "reduce_for_smoke"]
