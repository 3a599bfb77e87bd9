"""Plain PyTorch version of the paged decode-attention kernel (global layout).

Written after ``repro/kernels/paged_attention/ref.py::paged_attention_global_ref``
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


def paged_attention_global_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, block_table: torch.Tensor,
                               lengths: torch.Tensor, *,
                               softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, D); pools: (total, page, Hkv, D); table: (B, P) int32 with
    NULL entries (>= total) as zero pages; lengths: (B,). -> (B, Hq, D)."""
    B, Hq, D = q.shape
    _, page, Hkv, _ = k_pool.shape
    P = block_table.shape[1]
    k = gather_global_pages(k_pool, block_table)
    v = gather_global_pages(v_pool, block_table)
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
    o = o / torch.clamp(l[..., 0], min=1e-20)
    return o.reshape(B, Hq, D).to(q.dtype)
