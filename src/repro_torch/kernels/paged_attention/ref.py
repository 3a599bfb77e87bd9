"""Plain PyTorch versions of the paged decode-attention kernels.

Written after ``repro/kernels/paged_attention/ref.py`` (``paged_attention_ref``
for the per-slot layout, ``paged_attention_global_ref`` for the shared pool)
with the mask-before-max softmax of ``repro/models/attention.py::
paged_decode_attention``: invalid positions are masked to -inf before the
max, so a row of length 0 yields zeros (the JAX oracle's plain softmax
yields NaN there).
"""
from __future__ import annotations

from typing import Optional

import torch


def gather_global_pages(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(B, P, page, Hkv, D) logical view of a global pool (total, page, Hkv,
    D) through (B, P) tables. NULL entries (>= total) read as zero pages."""
    total = pool.shape[0]
    tbl = table.long()
    null = tbl >= total
    g = pool[torch.where(null, 0, tbl)]
    return g.masked_fill(null[..., None, None, None], 0)


def gather_slot_pages(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(B, n_pages, page, Hkv, D) logical view of per-slot pools (B, n_pages,
    page, Hkv, D) through (B, n_pages) tables: slot b's logical page p is
    its own physical page ``table[b, p]``. Entries >= n_pages read as zero
    pages, never as an out-of-bounds index."""
    n_pages = pool.shape[1]
    tbl = table.long()
    null = tbl >= n_pages
    rows = torch.arange(pool.shape[0], device=pool.device)[:, None]
    g = pool[rows, torch.where(null, 0, tbl)]
    return g.masked_fill(null[..., None, None, None], 0)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            lengths: torch.Tensor, softcap: Optional[float],
            return_lse: bool = False):
    """q: (B, Hq, D); k, v: logical (B, P, page, Hkv, D); the first
    ``lengths[b]`` tokens of row b are valid. -> (B, Hq, D) in q's dtype;
    with ``return_lse``, (B, Hq, D) in fp32 and each row's log-sum-exp of
    its scores (B, Hq) fp32, -inf for a row of length 0."""
    B, Hq, D = q.shape
    _, P, page, Hkv, _ = k.shape
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bhgd,bpthd->bhgpt", qg, k.float()) * (D ** -0.5)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = (torch.arange(P, device=q.device)[:, None] * page
           + torch.arange(page, device=q.device)[None, :])
    valid = pos[None] < torch.clamp(lengths.long(), max=P * page)[:, None, None]
    invalid = ~valid[:, None, None]                         # (B,1,1,P,T)
    s = s.masked_fill(invalid, float("-inf"))
    m = s.amax(dim=(-2, -1), keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m).masked_fill(invalid, 0.0)
    l = p.sum(dim=(-2, -1), keepdim=True)
    o = torch.einsum("bhgpt,bpthd->bhgd", p, v.float())
    o = (o / torch.clamp(l[..., 0], min=1e-20)).reshape(B, Hq, D)
    if not return_lse:
        return o.to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(l), float("-inf"))
    return o, lse.reshape(B, Hq)


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_table: torch.Tensor,
                        lengths: torch.Tensor, *,
                        softcap: Optional[float] = None,
                        return_lse: bool = False):
    """q: (B, Hq, D); pools: (B, n_pages, page, Hkv, D) per slot; table:
    (B, n_pages) int32 (entries >= n_pages as zero pages); lengths: (B,).
    -> (B, Hq, D), or with ``return_lse`` the output in fp32 and each
    row's log-sum-exp (B, Hq) fp32."""
    return _attend(q, gather_slot_pages(k_pool, block_table),
                   gather_slot_pages(v_pool, block_table), lengths, softcap,
                   return_lse)


def paged_attention_global_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, block_table: torch.Tensor,
                               lengths: torch.Tensor, *,
                               softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, D); pools: (total, page, Hkv, D); table: (B, P) int32 with
    NULL entries (>= total) as zero pages; lengths: (B,). -> (B, Hq, D)."""
    return _attend(q, gather_global_pages(k_pool, block_table),
                   gather_global_pages(v_pool, block_table), lengths, softcap)
