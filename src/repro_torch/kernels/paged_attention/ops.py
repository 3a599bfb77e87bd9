"""Wrappers of the paged decode-attention CUDA kernel, one per KV layout.

``paged_attention`` (per-slot pools) and ``paged_attention_global`` (one
shared pool) take the plain version for tensors on the CPU and launch
``csrc/paged_attention.cu`` for tensors on a CUDA device, one kernel a call;
they never fall back from one to the other. Each wrapper's ``.launches``
counts its kernel launches. On a card the wrapper raises ``ValueError``
before the launch for what the kernel's bulk copies cannot take: a pool
base off 16 bytes, or D * itemsize not a multiple of 16. ``paged_decode``
dispatches on the pool's rank, as ``repro/kernels/paged_attention/ops.py``
does.

``paged_attention(..., return_lse=True)`` returns a partial for a merge:
the output in fp32, unrounded, and each row's log-sum-exp ``(B, Hq)``
fp32, both written by the same launch (``-inf`` for a row of length 0):
the weight with which a decode over some of a sequence's pages merges
with decodes over the others (the sequence-parallel decode of
``models/attention.py``).

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
_STAGE_BYTES = 32 * 1024     # K + V of one stage of the kernel's ring
_MAX_D = 256                 # the kernel's largest head dim
_launchers = {}
_counters = {}


def _launch_fn(symbol: str):
    fn = _launchers.get(symbol)
    if fn is None:
        from repro_torch.kernels.build import load
        fn = getattr(load("paged_attention"), symbol)
        n_ints = 12 if symbol == "paged_attention_global_launch" else 11
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * n_ints
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launchers[symbol] = fn
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def n_splits(rows: int, n_pages: int, sms: int) -> int:
    """Splits of each row's pages (flash-decoding): enough CTAs for two an
    SM over ``rows`` (sequences times head groups), at least one, and never
    more than one a page of the table's capacity ``n_pages``."""
    return max(1, min(2 * sms // max(rows, 1), n_pages))


def head_groups(hkv: int, g: int) -> tuple:
    """(KV heads a CTA, query heads a KV head a CTA, CTAs a split of a row):
    every KV head when there are at most 8, else the largest divisor of Hkv
    that is; up to 8 of each KV head's G query heads."""
    hg = max(h for h in range(1, min(hkv, 8) + 1) if hkv % h == 0)
    gq = min(g, 8)
    return hg, gq, (hkv // hg) * -(-g // gq)


def tokens_per_copy(page: int, hg: int, d: int, itemsize: int) -> int:
    """Tokens of one page a stage holds: the largest divisor of ``page``
    whose K and V for ``hg`` heads fit in 32 KB (the whole page at the
    serving width: bf16, 8 heads, D 64, page 16)."""
    token = 2 * hg * d * itemsize
    return max([t for t in range(1, page + 1)
                if page % t == 0 and t * token <= _STAGE_BYTES] or [1])


@functools.lru_cache(maxsize=None)
def plan(batch: int, hkv: int, g: int, d: int, itemsize: int, page: int,
         n_pages: int, sms: int) -> tuple:
    """(hg, gq, n_z, tpc, n_split) of a launch: never reads the lengths."""
    hg, gq, n_z = head_groups(hkv, g)
    return (hg, gq, n_z, tokens_per_copy(page, hg, d, itemsize),
            n_splits(batch * n_z, n_pages, sms))


def _counter_buffer(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The kernel's per-(row, head group) arrival counters for launches on
    ``stream`` (so calls on two streams never share one): zeroed once, and
    reset to zero by the kernel itself."""
    key = (device, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


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


def _check_bulk(k_pool, v_pool):
    """What a bulk copy cannot take: a pool base off 16 bytes, or a K/V row
    (D * itemsize) that is not a multiple of 16 bytes; and D over 256."""
    D = k_pool.shape[-1]
    row = D * k_pool.element_size()
    if row % 16 or D > _MAX_D:
        raise ValueError(f"the decode kernel copies 16-byte vectors: D * "
                         f"itemsize = {row} bytes must be a multiple of 16, "
                         f"and D (here {D}) at most {_MAX_D}")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("the decode kernel's bulk copies need the K and V "
                         "pools at 16-byte-aligned addresses")


def _identity_table(B: int, n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device).expand(B, n) \
        .contiguous()


def _launch(symbol, q, k_pool, v_pool, block_table, lengths, sizes, softcap,
            lse=None):
    """Launch ``symbol`` on q's current stream, one kernel; ``sizes`` are
    the layout's int arguments between D and hg; ``lse``, a (B, Hq) fp32
    buffer or None, receives each row's log-sum-exp (the output is then
    fp32)."""
    _check_bulk(k_pool, v_pool)
    B, Hq, D = q.shape
    page, Hkv = k_pool.shape[-3], k_pool.shape[-2]
    hg, gq, n_z, tpc, splits = plan(B, Hkv, Hq // Hkv, D, q.element_size(),
                                    page, block_table.shape[1],
                                    _sm_count(q.device))
    part = torch.empty(B * Hq * splits * (D + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty(q.shape, device=q.device,
                      dtype=q.dtype if lse is None else torch.float32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launch_fn(symbol)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(), part.data_ptr(),
        _counter_buffer(q.device, stream, B * n_z).data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None, _DTYPES[q.dtype], B, Hkv, Hq // Hkv, D, *sizes, hg, gq, tpc, splits,
        D ** -0.5, softcap if softcap is not None else 0.0, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {err}")
    return out


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_table: torch.Tensor,
                    lengths: torch.Tensor, *, softcap: Optional[float] = None,
                    table_residency: str = "smem", return_lse: bool = False):
    """One-token decode attention over per-slot pools through permutation
    tables. q: (B, Hq, D); pools: (B, n_pages, page, Hkv, D); block_table:
    (B, n_pages) int32 into slot b's own pages (entries >= n_pages read as
    zero pages); lengths: (B,) int32. Returns (B, Hq, D) in q's dtype; with
    ``return_lse``, a partial for a merge: (B, Hq, D) in fp32 and each
    row's log-sum-exp (B, Hq) fp32."""
    _check(q, k_pool, v_pool, block_table, lengths, table_residency,
           per_slot=True)
    B, n_pages = block_table.shape
    if table_residency == "hbm":
        k_pool = gather_slot_pages(k_pool, block_table)
        v_pool = gather_slot_pages(v_pool, block_table)
        block_table = _identity_table(B, n_pages, q.device)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_table, lengths,
                                   softcap=softcap, return_lse=return_lse)
    lse = (torch.empty((B, q.shape[1]), dtype=torch.float32, device=q.device)
           if return_lse else None)
    out = _launch("paged_attention_launch", q, k_pool, v_pool, block_table,
                  lengths, (n_pages, k_pool.shape[2]), softcap, lse)
    paged_attention.launches += 1
    return (out, lse) if return_lse else out


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
