"""Wrappers of the paged decode-attention CUDA kernel, one per KV layout.

``paged_attention`` (per-slot pools) and ``paged_attention_global`` (one
shared pool) take the plain version for tensors on the CPU and launch
``csrc/paged_attention.cu`` for tensors on a CUDA device; they never fall
back from one to the other. Each wrapper's ``.launches`` counts its kernel
launches. ``paged_decode`` dispatches on the pool's rank, as
``repro/kernels/paged_attention/ops.py`` does.

``table_residency="hbm"`` is the LLC-off baseline of the JAX kernels: the
translations are not read next to the page loads; the pages are first
gathered through the table into a private per-slot pool with plain torch
indexing, and the per-slot kernel then reads it through an identity table.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels.paged_attention.ref import (
    gather_global_pages, gather_slot_pages, paged_attention_global_ref,
    paged_attention_ref)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_RESIDENCIES = ("smem", "hbm")
_launchers = {}


def _launch_fn(symbol: str):
    fn = _launchers.get(symbol)
    if fn is None:
        from repro_torch.kernels.build import load
        fn = getattr(load("paged_attention"), symbol)
        n_ints = 9 if symbol == "paged_attention_global_launch" else 8
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * n_ints
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launchers[symbol] = fn
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def n_splits(batch: int, hkv: int, capacity: int, sms: int) -> int:
    """Splits of each sequence's tokens (flash-decoding): enough blocks for
    two per SM, never more than one per ~64-token tile of the capacity."""
    want = -(-2 * sms // max(batch * hkv, 1))
    return max(1, min(want, -(-capacity // 64)))


def _check(q, k_pool, v_pool, block_table, lengths, table_residency,
           per_slot: bool):
    pool_rank = 5 if per_slot else 4
    if q.dim() != 3 or k_pool.dim() != pool_rank:
        layout = ("(B, n_pages, page, Hkv, D)" if per_slot
                  else "(total, page, Hkv, D)")
        raise ValueError(f"q must be (B, Hq, D) and pools {layout}; got "
                         f"{tuple(q.shape)} and {tuple(k_pool.shape)}")
    B, Hq, D = q.shape
    Hkv, Dk = k_pool.shape[-2:]
    if v_pool.shape != k_pool.shape or Dk != D or Hq % Hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k_pool "
                         f"{tuple(k_pool.shape)}, v_pool {tuple(v_pool.shape)}")
    if per_slot and (k_pool.shape[0] != B
                     or tuple(block_table.shape) != (B, k_pool.shape[1])):
        raise ValueError(f"per-slot pools must be (B, n_pages, ...) and the "
                         f"table (B, n_pages) with B={B}; got "
                         f"{tuple(k_pool.shape)}, {tuple(block_table.shape)}")
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
    if table_residency not in _RESIDENCIES:
        raise ValueError(f"table_residency={table_residency!r} (expected one "
                         f"of {_RESIDENCIES})")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def _identity_table(B: int, n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device).expand(B, n) \
        .contiguous()


def _launch(symbol, q, k_pool, v_pool, block_table, lengths, sizes, softcap):
    """Launch ``symbol`` on q's current stream; ``sizes`` are the layout's
    int arguments between D and n_split."""
    B, Hq, D = q.shape
    page, Hkv = k_pool.shape[-3], k_pool.shape[-2]
    capacity = block_table.shape[1] * page
    splits = n_splits(B, Hkv, capacity, _sm_count(q.device))
    part = torch.empty((B, Hq, splits, D + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launch_fn(symbol)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(), part.data_ptr(),
        out.data_ptr(), _DTYPES[q.dtype], B, Hkv, Hq // Hkv, D, *sizes, splits,
        D ** -0.5, softcap if softcap is not None else 0.0, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {err}")
    return out


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_table: torch.Tensor,
                    lengths: torch.Tensor, *, softcap: Optional[float] = None,
                    table_residency: str = "smem") -> torch.Tensor:
    """One-token decode attention over per-slot pools through permutation
    tables. q: (B, Hq, D); pools: (B, n_pages, page, Hkv, D); block_table:
    (B, n_pages) int32 into slot b's own pages (entries >= n_pages read as
    zero pages); lengths: (B,) int32. Returns (B, Hq, D) in q's dtype."""
    _check(q, k_pool, v_pool, block_table, lengths, table_residency,
           per_slot=True)
    B, n_pages = block_table.shape
    if table_residency == "hbm":
        k_pool = gather_slot_pages(k_pool, block_table)
        v_pool = gather_slot_pages(v_pool, block_table)
        block_table = _identity_table(B, n_pages, q.device)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_table, lengths,
                                   softcap=softcap)
    out = _launch("paged_attention_launch", q, k_pool, v_pool, block_table,
                  lengths, (n_pages, k_pool.shape[2]), softcap)
    paged_attention.launches += 1
    return out


def paged_attention_global(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor, *,
                           softcap: Optional[float] = None,
                           table_residency: str = "smem") -> torch.Tensor:
    """One-token decode attention over a shared pool through block tables.
    q: (B, Hq, D); pools: (total, page, Hkv, D); block_table: (B, P) int32,
    NULL (>= total) entries read as zero pages; lengths: (B,) int32.
    Returns (B, Hq, D) in q's dtype. With ``table_residency="hbm"`` the
    per-slot kernel runs on the gathered pages (``paged_attention`` counts
    that launch)."""
    _check(q, k_pool, v_pool, block_table, lengths, table_residency,
           per_slot=False)
    B, P = block_table.shape
    if table_residency == "hbm":
        return paged_attention(q, gather_global_pages(k_pool, block_table),
                               gather_global_pages(v_pool, block_table),
                               _identity_table(B, P, q.device), lengths,
                               softcap=softcap)
    if q.device.type == "cpu":
        return paged_attention_global_ref(q, k_pool, v_pool, block_table,
                                          lengths, softcap=softcap)
    total, page = k_pool.shape[:2]
    out = _launch("paged_attention_global_launch", q, k_pool, v_pool,
                  block_table, lengths, (total, page, P), softcap)
    paged_attention_global.launches += 1
    return out


paged_attention.launches = 0
paged_attention_global.launches = 0


def paged_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 block_table: torch.Tensor, lengths: torch.Tensor, *,
                 softcap: Optional[float] = None,
                 table_residency: str = "smem") -> torch.Tensor:
    """Decode attention for either layout, told apart by the pool's rank:
    (B, n_pages, page, Hkv, D) is per-slot, (total, page, Hkv, D) global."""
    fn = paged_attention_global if k_pool.dim() == 4 else paged_attention
    return fn(q, k_pool, v_pool, block_table, lengths, softcap=softcap,
              table_residency=table_residency)
