"""Architecture registry of the port: only the archs it serves.

``get_config("llama3.2-1b")`` returns the same config as the JAX package;
``base.py`` and the per-arch modules are byte copies of the reference's.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig, reduce_for_smoke

# arch id -> module name
_ARCH_MODULES: Dict[str, str] = {
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
}

ARCH_IDS: Tuple[str, ...] = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port serves "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).config()


__all__ = ["ARCH_IDS", "ModelConfig", "get_config", "reduce_for_smoke"]
