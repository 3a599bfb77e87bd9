"""Attention on the serving path (port of ``repro/models/attention.py``,
main-path subset): GQA projections, flash attention for prefill, the
GLOBAL paged KV pool with its append, decode attention and prefix-context
attention.

``flash_attention`` and ``paged_decode_attention`` run the hand-written CUDA
kernels for tensors on a CUDA device and their plain versions on the CPU
(the dispatch is in the kernel wrappers). ``prefix_context_attention`` is
plain PyTorch on both, as its JAX original is dense XLA code.

In-place updates: JAX returns new pools from every write (and the engine
donates the cache). Here ``paged_append`` writes the shared pools in place
and returns a PagedKV that holds the same pool tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention_fwd
from repro_torch.kernels.paged_attention.ops import paged_attention_global
from repro_torch.kernels.paged_attention.ref import \
    gather_global_pages as _gather


# ------------------------------------------------------------ projections

def qkv_proj(p: dict, x: torch.Tensor):
    """x: (B, S, d) -> q (B, S, Hq, Dh), k/v (B, S, Hkv, Dh)."""
    def proj(w):
        d, h, k = w.shape
        return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)
    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def out_proj(p: dict, o: torch.Tensor) -> torch.Tensor:
    h, k, d = p["wo"].shape
    return o.reshape(*o.shape[:-2], h * k) @ p["wo"].reshape(h * k, d)


def _softcap(s: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    return cap * torch.tanh(s / cap) if cap is not None else s


# ------------------------------------------------------------ flash attention

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None, q_offset: int = 0,
                    kv_chunk: int = 1024, q_chunk: int = 512) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D), forward
    only. Native GQA: K/V are not repeated."""
    return flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, window=window, softcap=softcap,
                               q_offset=q_offset, kv_chunk=kv_chunk,
                               q_chunk=q_chunk)


# ------------------------------------------------------------ paged KV cache

class PagedKV(NamedTuple):
    """The GLOBAL (zero-copy serving) layout: ONE physical pool shared by all
    slots.
      k_pool / v_pool: (total_pages, page, Hkv, D)
      block_table:     (B, max_pages) int32 into the pool; entries >=
                       total_pages are the NULL page (writes dropped, reads
                       zero) marking unallocated table slots.
      length:          (B,) int32 tokens currently valid per sequence.
    """
    k_pool: torch.Tensor
    v_pool: torch.Tensor
    block_table: torch.Tensor
    length: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k_pool.shape[-3]

    @property
    def capacity(self) -> int:
        """Per-sequence token capacity."""
        return self.block_table.shape[-1] * self.page_size


def gather_global_pages(kv: PagedKV):
    """Logical (B, P, page, Hkv, D) views of the pools through the block
    table; NULL entries read as exact zeros."""
    return _gather(kv.k_pool, kv.block_table), _gather(kv.v_pool, kv.block_table)


def paged_decode_attention(q: torch.Tensor, kv: PagedKV, *,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """One-token decode over the global pool. q: (B, 1, Hq, D)."""
    B = q.shape[0]
    lengths = torch.broadcast_to(kv.length, (B,)).to(torch.int32).contiguous()
    out = paged_attention_global(q[:, 0].contiguous(), kv.k_pool, kv.v_pool,
                                 kv.block_table.to(torch.int32).contiguous(),
                                 lengths, softcap=softcap)
    return out[:, None]


def prefix_context_attention(q: torch.Tensor, k_suf: torch.Tensor,
                             v_suf: torch.Tensor, kv: PagedKV,
                             prefix_lens: torch.Tensor,
                             suffix_lens: torch.Tensor, *,
                             softcap: Optional[float] = None) -> torch.Tensor:
    """Suffix-only prefill attention over a CACHED prefix: row b's queries
    sit at logical positions ``prefix_lens[b] + s``; keys are the prefix KV
    read back through the row's block table plus this call's suffix K/V.
    q/k_suf/v_suf: (B, S, H*, D). Returns (B, S, Hq, D). Dense fp32."""
    B, S, Hq, D = q.shape
    T = kv.page_size
    P_ = kv.block_table.shape[1]
    k_pre, v_pre = gather_global_pages(kv)
    k_pre = k_pre.reshape(B, P_ * T, -1, D)
    v_pre = v_pre.reshape(B, P_ * T, -1, D)
    G = Hq // k_pre.shape[2]
    if G > 1:
        k_pre = k_pre.repeat_interleave(G, dim=2)
        v_pre = v_pre.repeat_interleave(G, dim=2)
        k_suf = k_suf.repeat_interleave(G, dim=2)
        v_suf = v_suf.repeat_interleave(G, dim=2)
    k = torch.cat([k_pre, k_suf.to(k_pre.dtype)], dim=1)
    v = torch.cat([v_pre, v_suf.to(v_pre.dtype)], dim=1)
    dev = q.device
    pre_valid = torch.arange(P_ * T, device=dev)[None] < prefix_lens[:, None]
    sidx = torch.arange(S, device=dev)
    suf_valid = sidx[None, :] < suffix_lens[:, None]                # (B, S)
    causal = sidx[None, :] <= sidx[:, None]                         # (S, S)
    mask = torch.cat([pre_valid[:, None].expand(B, S, P_ * T),
                      suf_valid[:, None] & causal[None]], dim=-1)   # (B,S,P*T+S)
    s = torch.einsum("bshd,bthd->bsht", q.float(), k.float()) * (D ** -0.5)
    s = _softcap(s, softcap)
    m4 = mask[:, :, None, :]
    s = s.masked_fill(~m4, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m).masked_fill(~m4, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bsht,bthd->bshd", p, v.float())
    o = o / torch.clamp(l, min=1e-20)
    return o.to(q.dtype)


def _live_rows(phys: torch.Tensor, total: int) -> torch.Tensor:
    """Indices of scatter rows whose target page is real (not NULL): JAX
    drops out-of-bounds scatter writes, torch would fault on them."""
    return torch.nonzero(phys < total, as_tuple=True)[0]


def paged_append(kv: PagedKV, k_new: torch.Tensor, v_new: torch.Tensor
                 ) -> PagedKV:
    """Write one token's K/V (B, 1, Hkv, D) at position ``length`` through the
    block table, in place. Writes through NULL entries are dropped."""
    B = k_new.shape[0]
    page = kv.page_size
    length_b = torch.broadcast_to(kv.length, (B,)).long() % kv.capacity
    logical_page = length_b // page
    slot = length_b % page
    phys = torch.gather(kv.block_table.long(), 1, logical_page[:, None])[:, 0]
    rows = _live_rows(phys, kv.k_pool.shape[0])
    kv.k_pool[phys[rows], slot[rows]] = k_new[rows, 0].to(kv.k_pool.dtype)
    kv.v_pool[phys[rows], slot[rows]] = v_new[rows, 0].to(kv.v_pool.dtype)
    return kv._replace(length=kv.length + 1)


def scatter_pages(pool: torch.Tensor, table: torch.Tensor,
                  pages: torch.Tensor) -> None:
    """``pool[table] = pages`` in place for (N,) table entries and
    (N, page, H, D) pages; NULL entries (>= total) are dropped."""
    tbl = table.reshape(-1).long()
    rows = _live_rows(tbl, pool.shape[0])
    pool[tbl[rows]] = pages[rows].to(pool.dtype)
