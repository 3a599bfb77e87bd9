"""Plain PyTorch version of the gemm kernel, after
``repro/kernels/gemm/ref.py``: the product in fp32, the result in a's
dtype."""
from __future__ import annotations

import torch


def gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (M, K) @ b: (K, N) -> (M, N) in a's dtype."""
    return (a.float() @ b.float()).to(a.dtype)
