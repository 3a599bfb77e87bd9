"""Wrapper of the gemm CUDA kernel.

``gemm`` takes the plain version for tensors on the CPU and launches
``csrc/gemm.cu`` for tensors on a CUDA device; it never falls back from one
to the other. ``gemm.launches`` counts kernel launches. ``matmul`` is the
entry point of ``repro/kernels/gemm/ops.py``. The Pallas tile sizes and
their divisibility asserts belong to the TPU's tiling: the kernel takes any
shape and guards its edge tiles.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.gemm.ref import gemm_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_launcher = None


def _launch_fn():
    global _launcher
    if _launcher is None:
        from repro_torch.kernels.build import load
        fn = load("gemm").gemm_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launcher = fn
    return _launcher


def _check(a, b):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"a must be (M, K) and b (K, N); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"a/b must share float32 or bfloat16; got {a.dtype}, "
                        f"{b.dtype}")
    if b.device != a.device:
        raise ValueError("a and b must be on one device")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) with fp32 accumulation, a and b of one dtype (float32
    or bfloat16). Returns (M, N) in that dtype."""
    _check(a, b)
    if a.device.type == "cpu":
        return gemm_ref(a, b)
    (m, k), n = a.shape, b.shape[1]
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _launch_fn()(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                       _DTYPES[a.dtype], m, n, k, stream)
    if err != 0:
        raise RuntimeError(f"gemm launch failed: CUDA error {err}")
    gemm.launches += 1
    return c


gemm.launches = 0


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) on the tensors' device (see ``gemm``)."""
    return gemm(a, b)
