"""Wrapper of the paged decode-attention CUDA kernel (global pool layout).

``paged_attention_global`` takes the plain version for tensors on the CPU and
launches ``csrc/paged_attention.cu`` for tensors on a CUDA device; it never
falls back from one to the other. ``paged_attention_global.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels.paged_attention.ref import paged_attention_global_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_launcher = None


def _launch_fn():
    global _launcher
    if _launcher is None:
        from repro_torch.kernels.build import load
        fn = load("paged_attention").paged_attention_global_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launcher = fn
    return _launcher


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def n_splits(batch: int, hkv: int, capacity: int, sms: int) -> int:
    """Splits of each sequence's tokens (flash-decoding): enough blocks for
    two per SM, never more than one per ~64-token tile of the capacity."""
    want = -(-2 * sms // max(batch * hkv, 1))
    return max(1, min(want, -(-capacity // 64)))


def _check(q, k_pool, v_pool, block_table, lengths):
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"q must be (B, Hq, D) and pools (total, page, Hkv, "
                         f"D); got {tuple(q.shape)} and {tuple(k_pool.shape)}")
    B, Hq, D = q.shape
    _, _, Hkv, Dk = k_pool.shape
    if v_pool.shape != k_pool.shape or Dk != D or Hq % Hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k_pool "
                         f"{tuple(k_pool.shape)}, v_pool {tuple(v_pool.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError(f"table must be (B, P) and lengths (B,) with B={B}; "
                         f"got {tuple(block_table.shape)}, "
                         f"{tuple(lengths.shape)}")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"q/k_pool/v_pool must share float32 or bfloat16; got "
                        f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_table and lengths must be int32")
    tensors = (q, k_pool, v_pool, block_table, lengths)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")


def paged_attention_global(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor, *,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """One-token decode attention over a shared pool through block tables.
    q: (B, Hq, D); pools: (total, page, Hkv, D); block_table: (B, P) int32,
    NULL (>= total) entries read as zero pages; lengths: (B,) int32.
    Returns (B, Hq, D) in q's dtype."""
    _check(q, k_pool, v_pool, block_table, lengths)
    if q.device.type == "cpu":
        return paged_attention_global_ref(q, k_pool, v_pool, block_table,
                                          lengths, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, Hq, D = q.shape
    total, page, Hkv, _ = k_pool.shape
    P = block_table.shape[1]
    splits = n_splits(B, Hkv, P * page, _sm_count(q.device))
    part = torch.empty((B, Hq, splits, D + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launch_fn()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                       block_table.data_ptr(), lengths.data_ptr(),
                       part.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], B,
                       Hkv, Hq // Hkv, D, total, page, P, splits, D ** -0.5,
                       softcap if softcap is not None else 0.0, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_global launch failed: CUDA "
                           f"error {err}")
    paged_attention_global.launches += 1
    return out


paged_attention_global.launches = 0
