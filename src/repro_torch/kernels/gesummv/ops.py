"""Wrapper of the gesummv CUDA kernel.

``gesummv`` takes the plain version for tensors on the CPU and launches
``csrc/gesummv.cu`` for tensors on a CUDA device; it never falls back from
one to the other. ``gesummv.launches`` counts kernel launches. ``gesummv_op``
is the entry point of ``repro/kernels/gesummv/ops.py``; the Pallas row block
is the TPU's tiling and has no counterpart here. alpha and beta are Python
numbers passed to the kernel by value.
"""
from __future__ import annotations

import ctypes
import numbers

import torch

from repro_torch.kernels.gesummv.ref import gesummv_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_launcher = None


def _launch_fn():
    global _launcher
    if _launcher is None:
        from repro_torch.kernels.build import load
        fn = load("gesummv").gesummv_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launcher = fn
    return _launcher


def _check(alpha, beta, a, b, x):
    for name, v in (("alpha", alpha), ("beta", beta)):
        if not isinstance(v, numbers.Real) or isinstance(v, bool):
            raise TypeError(f"{name} must be a real number, not "
                            f"{type(v).__name__}")
    if a.dim() != 2 or b.shape != a.shape or x.dim() != 1 \
            or x.shape[0] != a.shape[1]:
        raise ValueError(f"a and b must be (N, K) and x (K,); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES or a.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(f"a/b/x must share float32 or bfloat16; got "
                        f"{a.dtype}, {b.dtype}, {x.dtype}")
    if a.device != x.device or b.device != x.device:
        raise ValueError("a, b and x must be on one device")
    if not (a.is_contiguous() and b.is_contiguous() and x.is_contiguous()):
        raise ValueError("a, b and x must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def gesummv(alpha: float, beta: float, a: torch.Tensor, b: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
    """``alpha * a @ x + beta * b @ x`` with fp32 accumulation. a, b: (N, K);
    x: (K,), all of one dtype (float32 or bfloat16). Returns (N,) in x's
    dtype."""
    _check(alpha, beta, a, b, x)
    if x.device.type == "cpu":
        return gesummv_ref(alpha, beta, a, b, x)
    n, k = a.shape
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    if n == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launch_fn()(a.data_ptr(), b.data_ptr(), x.data_ptr(), y.data_ptr(),
                       _DTYPES[x.dtype], n, k, float(alpha), float(beta),
                       stream)
    if err != 0:
        raise RuntimeError(f"gesummv launch failed: CUDA error {err}")
    gesummv.launches += 1
    return y


gesummv.launches = 0


def gesummv_op(alpha: float, beta: float, a: torch.Tensor, b: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """``alpha * a @ x + beta * b @ x`` on the tensors' device (see
    ``gesummv``)."""
    return gesummv(alpha, beta, a, b, x)
