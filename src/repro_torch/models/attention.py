"""Attention (port of ``repro/models/attention.py``): GQA projections (self- and cross-attention, the
latter gated), flash attention for training, prefill and cross-attention,
with its backward, the paged KV cache in both layouts (the GLOBAL shared
pool of zero-copy serving and the PER-SLOT pools of the copy baseline)
with its append and decode attention, prefix-context attention, the
sequence-parallel decode of a long sequence whose pages are sharded over
the ranks of a mesh axis (``sp_paged_decode``), and the decode over a
per-slot cache whose pages' tokens are split over the model axis
(``split_paged_decode``); both merge their ranks' partials by
``merge_partials``.

``flash_attention`` and ``paged_decode_attention`` run the hand-written CUDA
kernels for tensors on a CUDA device and their plain versions on the CPU
(the dispatch is in the kernel wrappers). Where autograd records,
``flash_attention`` is a ``torch.autograd.Function`` whose forward asks the
kernel for the rows' log-sum-exp too and whose backward,
``flash_attention_bwd``, is plain PyTorch, as the reference's ``core_bwd``
is jnp under ``jax.custom_vjp`` (no Pallas kernel). ``prefix_context_attention``
is plain PyTorch on both, as its JAX original is dense XLA code.

In-place updates: JAX returns new pools from every write (and the engine
donates the cache). Here ``paged_append`` writes the pools in place and
returns a PagedKV that holds the same pool tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import _block_mask, _chunk_of
from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                     paged_decode)
from repro_torch.kernels.paged_attention.ref import \
    gather_global_pages as _gather
from repro_torch.models.dist import MeshInfo, axis_group, axis_rank


# ------------------------------------------------------------ projections

def _proj(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) through w: (d, H, Dh) -> (B, S, H, Dh)."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def qkv_proj(p: dict, x: torch.Tensor, kv_x: Optional[torch.Tensor] = None):
    """x: (B, S, d) -> q (B, S, Hq, Dh), and k/v (B, Skv, Hkv, Dh) from
    ``kv_x`` (B, Skv, d) (cross-attention) or, without it, from x."""
    kv_x = x if kv_x is None else kv_x
    q, k, v = _proj(p["wq"], x), _proj(p["wk"], kv_x), _proj(p["wv"], kv_x)
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def q_proj(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The query projection alone (cross-attention's decode, whose K/V are
    cached): x (B, S, d) -> (B, S, Hq, Dh)."""
    return _proj(p["wq"], x)


def out_proj(p: dict, o: torch.Tensor, gated: bool = True) -> torch.Tensor:
    """(B, S, Hq, Dh) -> (B, S, d); a cross-attention's ``gate`` scales the
    result (:func:`gate`) unless ``gated`` is False."""
    h, k, d = p["wo"].shape
    y = o.reshape(*o.shape[:-2], h * k) @ p["wo"].reshape(h * k, d)
    return gate(p, y) if gated else y


def gate(p: dict, y: torch.Tensor) -> torch.Tensor:
    """``y`` scaled by tanh(``p["gate"]``), taken in fp32 and cast to
    ``y``'s dtype, where ``p`` has a gate; else ``y``."""
    if "gate" in p:
        y = torch.tanh(p["gate"].float()).to(y.dtype) * y
    return y


def _softcap(s: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    return cap * torch.tanh(s / cap) if cap is not None else s


# ------------------------------------------------------------ flash attention

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None, q_offset: int = 0,
                    kv_chunk: int = 1024, q_chunk: int = 512) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D). Native
    GQA: K/V are not repeated. Differentiable where autograd records (a
    gradient is wanted for q, k or v): the forward then also keeps the
    rows' log-sum-exp, and the backward is :func:`flash_attention_bwd`.
    Otherwise (serving) it is the forward alone, with no residuals."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset, kv_chunk=kv_chunk, q_chunk=q_chunk)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, kw)
    return flash_attention_fwd(q, k, v, **kw)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp`` core: saves (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        out, lse = flash_attention_fwd(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, out, lse, do, **ctx.kw), None)


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None, q_offset: int = 0,
                        kv_chunk: int = 1024, q_chunk: int = 512):
    """(dq, dk, dv) of flash attention from its residuals (``lse`` (B, Sq,
    Hq) fp32), as the reference's ``core_bwd``: ``delta = sum(do * out)``,
    each (q chunk, kv chunk) score block recomputed from ``lse`` in fp32
    (the softcap's derivative at the score before the cap, the masks as in
    the forward), fp32 sums, the results cast to the inputs' dtypes. K/V
    are repeated to the Hq heads for the products, and each group's G
    heads sum into its KV head, as ``jnp.repeat``'s transpose does. A block
    every entry of which the causal or window mask hides adds exact zeros
    in the reference, and is skipped here."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kr = k.repeat_interleave(G, dim=2) if G > 1 else k
    vr = v.repeat_interleave(G, dim=2) if G > 1 else v
    C, QC = _chunk_of(Skv, kv_chunk), _chunk_of(Sq, q_chunk)
    scale = D ** -0.5
    dev = q.device
    delta = (do.float() * out.float()).sum(-1)                 # (B, Sq, H)
    dq = torch.zeros((B, Sq, Hq, D), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, Skv, Hq, D), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, Skv, Hq, D), dtype=torch.float32, device=dev)
    for i in range(Sq // QC):
        qs = slice(i * QC, (i + 1) * QC)
        lo, hi = i * QC + q_offset, (i + 1) * QC - 1 + q_offset
        qi, doi = q[:, qs].float(), do[:, qs].float()
        lsei, di = lse[:, qs, :, None], delta[:, qs, :, None]
        q_pos = torch.arange(lo, hi + 1, device=dev)
        for j in range(Skv // C):
            if (causal and j * C > hi) or (
                    window is not None and lo - ((j + 1) * C - 1) >= window):
                continue
            ks = slice(j * C, (j + 1) * C)
            kj, vj = kr[:, ks].float(), vr[:, ks].float()
            mask = _block_mask(q_pos, torch.arange(j * C, (j + 1) * C,
                                                   device=dev),
                               causal, window)[None, :, None, :]
            s_raw = torch.einsum("bqhd,bchd->bqhc", qi, kj) * scale
            s = _softcap(s_raw, softcap).masked_fill(~mask, float("-inf"))
            p = torch.exp(s - lsei)                            # (B,QC,H,C)
            dp = torch.einsum("bqhd,bchd->bqhc", doi, vj)
            ds = p * (dp - di)
            if softcap is not None:
                ds = ds * (1.0 - torch.square(torch.tanh(s_raw / softcap)))
            ds = ds.masked_fill(~mask, 0.0) * scale
            dq[:, qs] += torch.einsum("bqhc,bchd->bqhd", ds, kj)
            dk[:, ks] += torch.einsum("bqhc,bqhd->bchd", ds, qi)
            dv[:, ks] += torch.einsum("bqhc,bqhd->bchd", p, doi)
    if G > 1:
        dk = dk.view(B, Skv, Hkv, G, D).sum(3)
        dv = dv.view(B, Skv, Hkv, G, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------ cross-attention KV

class CrossKV(NamedTuple):
    """A cross-attention layer's K/V over the source (the encoder's output
    or the image embeddings), one row a slot: k, v (B, src_len, Hkv, D),
    written whole by a prefill and read, not changed, by every decode."""
    k: torch.Tensor
    v: torch.Tensor


# ------------------------------------------------------------ paged KV cache

class PagedKV(NamedTuple):
    """A paged KV cache in one of two layouts, told apart by rank
    (``is_global_layout``):

    GLOBAL (zero-copy serving): ONE physical pool shared by all slots.
      k_pool / v_pool: (total_pages, page, Hkv, D)
      block_table:     (B, max_pages) int32 into the pool; entries >=
                       total_pages are the NULL page (writes dropped, reads
                       zero) marking unallocated table slots.
    PER-SLOT (the copy baseline): one pool per sequence.
      k_pool / v_pool: (B, n_pages, page, Hkv, D)
      block_table:     (B, n_pages) int32, a permutation of slot b's own
                       pages (logical -> physical).

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
        if is_global_layout(self):
            return self.block_table.shape[-1] * self.page_size
        return self.k_pool.shape[1] * self.k_pool.shape[2]


def is_global_layout(kv: PagedKV) -> bool:
    """True for the shared global pool: a (total, page, H, D) pool beside a
    (B, P) table (+2 ranks); per-slot pools carry (pages, page, H, D) behind
    the table's (B, P) dims (+3 ranks)."""
    return kv.k_pool.dim() == kv.block_table.dim() + 2


def gather_global_pages(kv: PagedKV):
    """Logical (B, P, page, Hkv, D) views of the pools through the block
    table; NULL entries read as exact zeros."""
    return _gather(kv.k_pool, kv.block_table), _gather(kv.v_pool, kv.block_table)


def gather_pages(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Per-slot pools (B, n_pages, page, H, D) gathered through (B, n_pages)
    tables into logical order -> (B, S, H, D)."""
    B, n_pages, page, H, D = pool.shape
    g = torch.take_along_dim(pool, table.long()[:, :, None, None, None], dim=1)
    return g.reshape(B, n_pages * page, H, D)


def paged_decode_attention(q: torch.Tensor, kv: PagedKV, *,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """One-token decode through the block table, in either layout (the
    per-slot or the global kernel). q: (B, 1, Hq, D)."""
    B = q.shape[0]
    lengths = torch.broadcast_to(kv.length, (B,)).to(torch.int32).contiguous()
    out = paged_decode(q[:, 0].contiguous(), kv.k_pool, kv.v_pool,
                       kv.block_table.to(torch.int32).contiguous(), lengths,
                       softcap=softcap)
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
    block table, in place; the write is rolling modulo the capacity. Global
    layout: writes through NULL entries are dropped. Per-slot layout: the
    tables are permutations, so every row writes (an inactive slot writes
    one stale token, which its next admission overwrites)."""
    B = k_new.shape[0]
    page = kv.page_size
    length_b = torch.broadcast_to(kv.length, (B,)).long() % kv.capacity
    logical_page = length_b // page
    slot = length_b % page
    phys = torch.gather(kv.block_table.long(), 1, logical_page[:, None])[:, 0]
    if is_global_layout(kv):
        rows = _live_rows(phys, kv.k_pool.shape[0])
        idx = (phys[rows], slot[rows])
    else:
        rows = torch.arange(B, device=phys.device)
        idx = (rows, phys, slot)
    kv.k_pool[idx] = k_new[rows, 0].to(kv.k_pool.dtype)
    kv.v_pool[idx] = v_new[rows, 0].to(kv.v_pool.dtype)
    return kv._replace(length=kv.length + 1)


def scatter_pages(pool: torch.Tensor, table: torch.Tensor,
                  pages: torch.Tensor) -> None:
    """``pool[table] = pages`` in place for (N,) table entries and
    (N, page, H, D) pages; NULL entries (>= total) are dropped."""
    tbl = table.reshape(-1).long()
    rows = _live_rows(tbl, pool.shape[0])
    pool[tbl[rows]] = pages[rows].to(pool.dtype)


# ------------------------------------------------------------ SP decode

def sp_paged_decode(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                    kv: PagedKV, mesh, *, softcap: Optional[float] = None,
                    seq_axis: str = "data"):
    """Sequence-parallel paged decode (long_500k): pages sharded on
    ``seq_axis``, one rank a shard.

    ``kv`` is this rank's shard of a per-slot cache: pools (B, local_pages,
    page, Hkv, D), physical pages [r * local_pages, (r + 1) * local_pages)
    of the sequence's; the whole block table (B, n_pages), which every rank
    holds; the lengths (B,) of the whole sequence. As in the reference, a
    shard reads its own columns of the table modulo ``local_pages`` (its
    local translation): placement is sequence-affine, shard i owns logical
    pages [i * local_pages, (i + 1) * local_pages), so the block-table walk
    never crosses a shard.

    The new token's K/V is written on its owner shard only (rolling modulo
    the whole capacity); each shard then attends over its local pages
    through the decode kernel, which also writes each row's log-sum-exp
    (positions up to and including ``length``: a shard past the length
    has none, and its lse is -inf); the shards' partials are merged by
    all-reduces over ``seq_axis``: m = max lse_r, w_r = exp(lse_r - m),
    out = sum w_r o_r / sum w_r (the owner shard always holds the new
    token, so m is finite). The reference's ``pmax``/``psum`` merge of (m,
    l, acc) is the same sum; here each partial arrives normalised, in
    fp32 as the reference's acc, and P keeps the kernel's precision (the
    reference rounds P to V's dtype before P.V). The collectives run after the kernel on the
    caller's stream (NCCL and gloo order them after the current stream's
    work).

    The pools are updated in place. Returns (out (B, 1, Hq, D), the PagedKV
    with lengths + 1).
    """
    if mesh is None:
        raise ValueError("sequence-parallel decode needs a mesh: the SP "
                         "cache layout shards a sequence's pages over the "
                         f"{seq_axis!r} axis")
    mi = MeshInfo(mesh)
    n_shards, shard = mi.size(seq_axis), axis_rank(mi, seq_axis)
    B, _, Hq, D = q.shape
    local_pages, page = kv.k_pool.shape[1], kv.page_size
    local_tokens = local_pages * page
    length = torch.broadcast_to(kv.length, (B,)).long()
    # ---- append on the owner shard (rolling modulo pool capacity) ----
    wpos = length % (n_shards * local_tokens)
    owner = (wpos // local_tokens) == shard
    local_pos = wpos % local_tokens
    lpage, slot = local_pos // page, local_pos % page
    tbl = kv.block_table[:, shard * local_pages:(shard + 1) * local_pages] \
        .long() % local_pages                        # shard-local translation
    phys = torch.gather(tbl, 1, lpage[:, None])[:, 0]
    rows = torch.arange(B, device=q.device)
    for pool, new in ((kv.k_pool, k_new), (kv.v_pool, v_new)):
        cur = pool[rows, phys, slot]
        pool[rows, phys, slot] = torch.where(owner[:, None, None],
                                             new[:, 0].to(pool.dtype), cur)
    # ---- local partial attention: positions shard * local_tokens + i,
    # valid while <= length ----
    n_local = torch.clamp(length + 1 - shard * local_tokens, 0,
                          local_tokens).to(torch.int32)
    o, lse = paged_attention(q[:, 0].contiguous(), kv.k_pool, kv.v_pool,
                             tbl.to(torch.int32).contiguous(), n_local,
                             softcap=softcap, return_lse=True)
    out = merge_partials(o, lse, mi, seq_axis)
    return (out.reshape(B, 1, Hq, D).to(q.dtype),
            kv._replace(length=kv.length + 1))


def merge_partials(o: torch.Tensor, lse: torch.Tensor, mi: MeshInfo,
                   axis: str) -> torch.Tensor:
    """The flash-decoding merge of partial decodes over ``axis``'s ranks:
    each rank's ``o`` (B, Hq, D) fp32, normalised over its own keys, and
    ``lse`` (B, Hq) fp32 (-inf where it holds none); m = max lse_r, w_r =
    exp(lse_r - m), out = sum w_r o_r / sum w_r (fp32), by one all-reduce
    MAX and one SUM. Some rank must hold a key of every row."""
    import torch.distributed as dist
    group = axis_group(mi, axis)
    D = o.shape[-1]
    m = lse.clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    w = torch.exp(lse - m)[..., None]                  # (B, Hq, 1)
    acc = torch.cat([w * o, w], dim=-1)
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    return acc[..., :D] / acc[..., D:]


def split_local_lengths(length: torch.Tensor, capacity: int, page: int,
                        split: int, part: int) -> torch.Tensor:
    """Valid tokens of one rank's slice of a per-slot pool whose pages'
    tokens are split over ``split`` ranks: rank ``part`` holds offsets
    [part * pl, (part + 1) * pl) of every page of ``page`` tokens (pl =
    page / split). In local page-major order its tokens keep their global
    order, so of the first ``min(length, capacity)`` tokens (a ring past
    its capacity holds every slot) its valid ones are a prefix of
    (L // page) * pl + clamp(L mod page - part * pl, 0, pl)."""
    pl = page // split
    L = torch.clamp(length.long(), max=capacity)
    tail = torch.clamp(L % page - part * pl, 0, pl)
    return ((L // page) * pl + tail).to(torch.int32)


def split_paged_decode(q: torch.Tensor, k_new: torch.Tensor,
                       v_new: torch.Tensor, kv: PagedKV, mi: MeshInfo,
                       split: int, *, softcap: Optional[float] = None,
                       axis: str = "model"):
    """Decode over a per-slot cache whose pages' tokens are split over the
    ``split`` ranks of ``axis`` (the reference's placement of a pool whose
    KV heads are fewer than 16, ``("batch", None, "tp", None, None)``:
    its decode merges partials over ``model``, flash-decoding). ``kv`` is
    this rank's slice: pools (B, n_pages, page / split, Hkv, D) holding
    offsets [r * pl, (r + 1) * pl) of every page, the whole table (B,
    n_pages) and the whole sequence's lengths (B,). q (B, 1, Hq, D) and
    k/v_new (B, 1, Hkv, D) are every head's.

    The new token, at position ``length`` (modulo the capacity n_pages *
    page: a ring wraps), is written by its owner rank alone, ``(length mod
    page) // pl``. Each rank then runs the per-slot decode kernel at page
    ``pl`` over its valid prefix (``split_local_lengths``) with the rows'
    log-sum-exp, and the partials merge over ``axis``
    (:func:`merge_partials`); rank 0 holds token 0, so every row has a
    key somewhere. With ``split`` 1 it is ``paged_append`` and
    ``paged_decode_attention``. Pools are updated in place; returns (out
    (B, 1, Hq, D), the PagedKV with lengths + 1)."""
    if split == 1:
        kv_new = paged_append(kv, k_new, v_new)
        return paged_decode_attention(q, kv_new, softcap=softcap), kv_new
    B, _, Hq, D = q.shape
    n_pages, pl = kv.k_pool.shape[1], kv.k_pool.shape[2]
    page = pl * split
    capacity = n_pages * page
    part = axis_rank(mi, axis)
    length = torch.broadcast_to(kv.length, (B,)).long()
    # ---- append on the owner rank (rolling modulo the capacity) ----
    wpos = length % capacity
    slot = wpos % page
    owner = (slot // pl) == part
    phys = torch.gather(kv.block_table.long(), 1, (wpos // page)[:, None])[:, 0]
    local = torch.clamp(slot - part * pl, 0, pl - 1)
    rows = torch.arange(B, device=q.device)
    for pool, new in ((kv.k_pool, k_new), (kv.v_pool, v_new)):
        cur = pool[rows, phys, local]
        pool[rows, phys, local] = torch.where(owner[:, None, None],
                                              new[:, 0].to(pool.dtype), cur)
    n_local = split_local_lengths(length + 1, capacity, page, split, part)
    o, lse = paged_attention(q[:, 0].contiguous(), kv.k_pool, kv.v_pool,
                             kv.block_table.to(torch.int32).contiguous(),
                             n_local, softcap=softcap, return_lse=True)
    out = merge_partials(o, lse, mi, axis)
    return (out.reshape(B, 1, Hq, D).to(q.dtype),
            kv._replace(length=kv.length + 1))
