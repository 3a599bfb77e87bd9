"""Plain PyTorch version of the axpy kernel.

Written after ``repro/kernels/axpy/ref.py`` and the Pallas kernel, which
casts ``a`` to ``x.dtype`` before the multiply: in bf16 the product is
rounded to bf16 before the add. A Python float times a bf16 tensor in
torch would keep ``a`` in fp32, so ``a`` is rounded to the dtype first.
"""
from __future__ import annotations

import torch


def scalar_in(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (round to nearest even), as a Python
    float that a torch op then uses exactly."""
    return torch.tensor(float(value), dtype=dtype).item()


def axpy_ref(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """a: a real number; x, y: (n,) of one dtype. -> (n,) in x's dtype,
    rounded after the multiply and after the add."""
    return x * scalar_in(a, x.dtype) + y
