"""Wrapper of the gemm CUDA kernels.

``gemm`` takes the plain version for tensors on the CPU and launches one of
the three kernels of ``csrc/gemm.cu`` for tensors on a CUDA device, chosen
by ``kernel_for(dtype, m, n, k, aligned)`` from the inputs' dtype, shape
and alignment before the launch; it never falls back from one to another or
to the plain version after a launch. ``gemm.launches`` counts every
kernel launch, ``gemm.wgmma_launches`` those of the wgmma kernel.
``matmul`` is the entry point of ``repro/kernels/gemm/ops.py``. The Pallas
tile sizes and their divisibility asserts belong to the TPU's tiling: the
kernels take any shape and mask or zero-fill their edge tiles.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.gemm.ref import gemm_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_launchers = {}


def kernel_for(dtype: torch.dtype, m: int, n: int, k: int,
               aligned: bool = True) -> str:
    """The kernel that takes an (m, k) @ (k, n) product on the card:
    "wgmma" (TMA-fed tensor-core kernel) for bfloat16 whose rows of a and b
    are 16-byte strides (k and n multiples of 8, k > 0) at 16-byte-aligned
    bases (``aligned``), "mma" (mma.sync) for other bfloat16 inputs, "simt"
    (CUDA cores, true fp32) for float32. Raises TypeError for a dtype no
    kernel takes."""
    if dtype not in _DTYPES:
        raise TypeError(f"no gemm kernel takes {dtype}")
    if dtype == torch.float32:
        return "simt"
    tma_ok = aligned and k > 0 and k % 8 == 0 and n % 8 == 0
    return "wgmma" if tma_ok else "mma"


def _launch_fn(kind: str):
    fn = _launchers.get(kind)
    if fn is None:
        from repro_torch.kernels.build import load
        lib = load("gemm")
        if kind == "wgmma":
            fn = lib.gemm_wgmma_launch
            n_int = 3
        else:
            fn = lib.gemm_launch
            n_int = 4                           # and the dtype code
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launchers[kind] = fn
    return fn


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
    aligned = all(t.data_ptr() % 16 == 0 for t in (a, b, c))
    kind = kernel_for(a.dtype, m, n, k, aligned)
    args = [a.data_ptr(), b.data_ptr(), c.data_ptr()]
    if kind != "wgmma":
        args.append(_DTYPES[a.dtype])
    args += [m, n, k, torch.cuda.current_stream(a.device).cuda_stream]
    err = _launch_fn(kind)(*args)
    if err != 0:
        what = ("a TMA tensor map was refused" if err < 0
                else f"CUDA error {err}")
        raise RuntimeError(f"gemm ({kind} kernel) launch failed: {what} "
                           f"(code {err})")
    gemm.launches += 1
    if kind == "wgmma":
        gemm.wgmma_launches += 1
    return c


gemm.launches = 0
gemm.wgmma_launches = 0


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) on the tensors' device (see ``gemm``)."""
    return gemm(a, b)
