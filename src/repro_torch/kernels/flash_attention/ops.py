"""Wrapper of the flash-attention forward CUDA kernel.

``flash_attention_fwd`` takes the plain version for tensors on the CPU and
launches one of the two kernels of ``csrc/flash_attention.cu`` for tensors
on a CUDA device, chosen by ``kernel_for(dtype, head_dim)`` alone; it never
falls back from one to another. With ``return_lse`` both kernels also
write each row's log-sum-exp, which the training path's backward
(``models/attention.py``) recomputes its scores from.
``flash_attention_fwd.launches`` counts every kernel launch,
``flash_attention_fwd.wgmma_launches`` those of the wgmma kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (dtype, head dim) -> kernel: "wgmma" is the TMA-fed tensor-core kernel
# (bf16 only), "simt" the one-thread-a-row kernel on the CUDA cores.
_KERNEL_FOR = {**{(torch.float32, d): "simt" for d in (16, 32, 64)},
               **{(torch.bfloat16, d): "simt" for d in (16, 32)},
               **{(torch.bfloat16, d): "wgmma" for d in (64, 112, 128, 256)}}
_launchers = {}


def kernel_for(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that takes (dtype, head_dim) on the card: "wgmma" or
    "simt". Raises TypeError for a dtype no kernel takes and ValueError for
    a head dim the dtype's kernels do not take."""
    if dtype not in _DTYPES:
        raise TypeError(f"no flash kernel takes {dtype}")
    kind = _KERNEL_FOR.get((dtype, head_dim))
    if kind is None:
        dims = sorted(d for t, d in _KERNEL_FOR if t == dtype)
        raise ValueError(f"head dim {head_dim} not supported in {dtype} "
                         f"(the kernels take {dims})")
    return kind


def _launch_fn(kind: str):
    fn = _launchers.get(kind)
    if fn is None:
        from repro_torch.kernels.build import load
        lib = load("flash_attention")
        if kind == "wgmma":
            fn = lib.flash_attention_wgmma_launch
            n_int = 9
        else:
            fn = lib.flash_attention_fwd_launch
            n_int = 10                          # and the dtype code
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * n_int
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launchers[kind] = fn
    return fn


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
                        kv_chunk: int = 1024, q_chunk: int = 512,
                        return_lse: bool = False):
    """Attention forward with native GQA. q: (B, Sq, Hq, D); k, v:
    (B, Skv, Hkv, D). Masks: causal ``kv_pos <= q_pos``, ``window``
    ``q_pos - kv_pos < window``, with ``q_pos = row + q_offset``. The chunk
    sizes shape only the plain version's loop. Returns (B, Sq, Hq, D), and
    with ``return_lse`` also the rows' log-sum-exp (B, Sq, Hq) fp32 in the
    reference's convention: ``(m if finite else 0) + log(max(l, 1e-20))``,
    so a row with no visible key reads log(1e-20)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset,
                                   kv_chunk=kv_chunk, q_chunk=q_chunk,
                                   return_lse=return_lse)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    kind = kernel_for(q.dtype, D)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if window is not None and window <= 0:
        raise ValueError(f"window={window} must be positive")
    out = torch.empty_like(q)
    lse = (torch.empty((B, Sq, Hq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if kind == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("the wgmma kernel's TMA loads need q, k, v and out "
                         "at 16-byte-aligned addresses")
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None]
    if kind == "simt":
        args.append(_DTYPES[q.dtype])
    args += [B, Sq, Skv, Hq, Hkv, D, int(bool(causal)),
             int(window) if window is not None else 0, int(q_offset),
             D ** -0.5, softcap if softcap is not None else 0.0,
             torch.cuda.current_stream(q.device).cuda_stream]
    err = _launch_fn(kind)(*args)
    if err != 0:
        what = ("a TMA tensor map was refused" if err < 0
                else f"CUDA error {err}")
        raise RuntimeError(f"flash_attention_fwd ({kind} kernel) launch "
                           f"failed: {what} (code {err})")
    flash_attention_fwd.launches += 1
    if kind == "wgmma":
        flash_attention_fwd.wgmma_launches += 1
    return (out, lse) if return_lse else out


flash_attention_fwd.launches = 0
flash_attention_fwd.wgmma_launches = 0
