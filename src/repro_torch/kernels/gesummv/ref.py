"""Plain PyTorch version of the gesummv kernel, after
``repro/kernels/gesummv/ref.py``: both products in fp32, alpha and beta in
fp32, the result in x's dtype."""
from __future__ import annotations

import torch


def gesummv_ref(alpha: float, beta: float, a: torch.Tensor, b: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """a, b: (N, K); x: (K,). -> (N,) in x's dtype."""
    xf = x.float()
    return (alpha * (a.float() @ xf) + beta * (b.float() @ xf)).to(x.dtype)
