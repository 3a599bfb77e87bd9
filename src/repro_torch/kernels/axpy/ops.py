"""Wrapper of the axpy CUDA kernel.

``axpy`` takes the plain version for tensors on the CPU and launches
``csrc/axpy.cu`` for tensors on a CUDA device; it never falls back from one
to the other. ``axpy.launches`` counts kernel launches. ``axpy_op`` is the
entry point of ``repro/kernels/axpy/ops.py``; the Pallas block size is the
TPU's tiling and has no counterpart here.
"""
from __future__ import annotations

import ctypes
import numbers

import torch

from repro_torch.kernels.axpy.ref import axpy_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_launcher = None


def _launch_fn():
    global _launcher
    if _launcher is None:
        from repro_torch.kernels.build import load
        fn = load("axpy").axpy_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                                ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launcher = fn
    return _launcher


def _check(a, x, y):
    if not isinstance(a, numbers.Real) or isinstance(a, bool):
        raise TypeError(f"a must be a real number, not {type(a).__name__}")
    if x.dim() != 1 or y.shape != x.shape:
        raise ValueError(f"x and y must be (n,) of one length; got "
                         f"{tuple(x.shape)}, {tuple(y.shape)}")
    if x.dtype not in _DTYPES or y.dtype != x.dtype:
        raise TypeError(f"x/y must share float32 or bfloat16; got {x.dtype}, "
                        f"{y.dtype}")
    if y.device != x.device:
        raise ValueError("x and y must be on one device")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("x and y must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def axpy(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``a * x + y`` for (n,) x and y of one dtype (float32 or bfloat16),
    with ``a`` rounded to that dtype. Returns a new (n,) tensor."""
    _check(a, x, y)
    if x.device.type == "cpu":
        return axpy_ref(a, x, y)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launch_fn()(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                       _DTYPES[x.dtype], x.numel(), float(a), stream)
    if err != 0:
        raise RuntimeError(f"axpy launch failed: CUDA error {err}")
    axpy.launches += 1
    return out


axpy.launches = 0


def axpy_op(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``a * x + y`` on the tensors' device (see ``axpy``)."""
    return axpy(a, x, y)
