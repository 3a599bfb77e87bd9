"""Wrapper of the flash-attention forward CUDA kernel.

``flash_attention_fwd`` takes the plain version for tensors on the CPU and
launches ``csrc/flash_attention.cu`` for tensors on a CUDA device; it never
falls back from one to the other. ``flash_attention_fwd.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64)
_launcher = None


def _launch_fn():
    global _launcher
    if _launcher is None:
        from repro_torch.kernels.build import load
        fn = load("flash_attention").flash_attention_fwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launcher = fn
    return _launcher


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, Sq, Hq, D) and k, v (B, Skv, Hkv, "
                         f"D); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[2]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None, q_offset: int = 0,
                        kv_chunk: int = 1024, q_chunk: int = 512
                        ) -> torch.Tensor:
    """Attention forward with native GQA. q: (B, Sq, Hq, D); k, v:
    (B, Skv, Hkv, D). Masks: causal ``kv_pos <= q_pos``, ``window``
    ``q_pos - kv_pos < window``, with ``q_pos = row + q_offset``. The chunk
    sizes shape only the plain version's loop. Returns (B, Sq, Hq, D)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset,
                                   kv_chunk=kv_chunk, q_chunk=q_chunk)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported (kernel takes "
                         f"{HEAD_DIMS})")
    if window is not None and window <= 0:
        raise ValueError(f"window={window} must be positive")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launch_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), _DTYPES[q.dtype], B, Sq, Skv, Hq, Hkv,
                       D, int(bool(causal)),
                       int(window) if window is not None else 0,
                       int(q_offset), D ** -0.5,
                       softcap if softcap is not None else 0.0, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
