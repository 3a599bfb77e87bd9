"""Wrapper of the heat3d stencil CUDA kernel.

``heat3d_step`` takes the plain version for tensors on the CPU and launches
``csrc/heat3d.cu``'s one kernel for tensors on a CUDA device, in the
instantiation that ``kernel_for(dtype, nx, aligned)`` picks before the
launch; it never falls back from one to the other.
``heat3d_step.launches`` counts kernel launches, one per step. ``heat3d``
is the multi-step entry point of ``repro/kernels/heat3d/ops.py``; the
Pallas z-slab depth is the TPU's tiling and has no counterpart here.

Every step writes out of place: the kernel writes every point of a new
output (the stencil on the interior, a copy of the input on the boundary),
so no step writes what it reads and the input is never written. On the card
the output starts at the input's offset within 16 bytes (a view a few
elements into its own buffer where the input's base is not 16-byte
aligned), so both share one grid of 16-byte words.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.heat3d.ref import C0, C1, heat3d_step_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_launcher = None


def kernel_for(dtype: torch.dtype, nx: int, aligned: bool = True) -> str:
    """The instantiation of ``heat3d_ring_kernel`` that takes a (Z, Y, nx)
    step on the card: "rows16" where every row is a 16-byte stride and the
    input's base is 16-byte aligned (``aligned``), so every read is one
    aligned 16-byte load; "shifted" otherwise, which reads a neighbour row
    that starts at another offset within 16 bytes as the two aligned words
    around its points, shifted into place. Raises TypeError for a dtype the
    kernel does not take."""
    if dtype not in _DTYPES:
        raise TypeError(f"no heat3d kernel takes {dtype}")
    return "rows16" if aligned and nx * dtype.itemsize % 16 == 0 else "shifted"


def _launch_fn():
    global _launcher
    if _launcher is None:
        from repro_torch.kernels.build import load
        fn = load("heat3d").heat3d_step_launch
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launcher = fn
    return _launcher


def _empty_at_phase(u: torch.Tensor) -> torch.Tensor:
    """A new contiguous tensor like u whose base lies at u's offset within
    16 bytes."""
    if u.data_ptr() % 16 == 0:
        return torch.empty_like(u)
    n, es = u.numel(), u.element_size()
    flat = torch.empty(n + 16 // es, dtype=u.dtype, device=u.device)
    shift = (u.data_ptr() - flat.data_ptr()) % 16 // es
    return flat[shift:shift + n].view(u.shape)


def _check(u):
    if u.dim() != 3:
        raise ValueError(f"u must be (Z, Y, X); got {tuple(u.shape)}")
    if u.dtype not in _DTYPES:
        raise TypeError(f"u must be float32 or bfloat16; got {u.dtype}")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {u.device}")


def heat3d_step(u: torch.Tensor, *, c0: float = C0,
                c1: float = C1) -> torch.Tensor:
    """One 7-point step over (Z, Y, X), float32 or bfloat16: ``c0 * center
    + c1 * (sum of the six neighbours)`` on the interior, with c0 and c1
    rounded to u's dtype and a rounding after every op; the boundary is
    kept. Returns a new tensor. A volume with a dimension under 3 has no
    interior: it is copied, and no kernel is launched."""
    _check(u)
    if u.device.type == "cpu":
        return heat3d_step_ref(u, c0=c0, c1=c1)
    if min(u.shape) < 3:
        return u.clone()
    out = _empty_at_phase(u)
    kind = kernel_for(u.dtype, u.shape[2], u.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = _launch_fn()(u.data_ptr(), out.data_ptr(), _DTYPES[u.dtype],
                       int(kind == "rows16"), *u.shape, float(c0), float(c1),
                       stream)
    if err != 0:
        raise RuntimeError(f"heat3d_step ({kind} kernel) launch failed: "
                           f"CUDA error {err}")
    heat3d_step.launches += 1
    return out


heat3d_step.launches = 0


def heat3d(u: torch.Tensor, *, steps: int = 1) -> torch.Tensor:
    """``steps`` timesteps of ``heat3d_step``. Returns a new tensor; u is
    not written."""
    _check(u)
    if steps < 0:
        raise ValueError(f"steps={steps} must be >= 0")
    if steps == 0:
        return u.clone()
    for _ in range(steps):
        u = heat3d_step(u)
    return u
