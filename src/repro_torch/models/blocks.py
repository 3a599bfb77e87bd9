"""Per-layer forward (port of ``repro/models/blocks.py``, ``attn_mlp`` path).

Two execution modes reach a layer here:
  prefill  a right-padded batch of prompts; KV is scattered into the shared
           global pool through per-sequence block tables (zero-copy), or,
           with a cached prefix, only the suffix is computed
  decode   one token per sequence: append through the table, then attend
           over the pool through it
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import glu_mlp, rmsnorm, rope


@dataclass(frozen=True)
class FwdCtx:
    cfg: ModelConfig
    mode: str                   # prefill | decode
    q_offset: Any = 0           # rope/mask offset of token 0 (decode: (B,) lengths)
    seq_lengths: Optional[torch.Tensor] = None     # (B,) real prompt lengths
    # CoW prefix sharing (suffix-only prefill): tokens already resident in
    # the shared pool per row, and the scatter tables whose shared entries
    # are NULLed so the prefill write never touches a shared page.
    kv_prefix_lens: Optional[torch.Tensor] = None  # (B,) int32
    write_tables: Optional[torch.Tensor] = None    # (B, max_pages) int32


def _self_attention(p, x, ctx: FwdCtx, kv: Optional[attn.PagedKV]):
    cfg = ctx.cfg
    B, S, _ = x.shape
    q, k, v = attn.qkv_proj(p, x)
    if ctx.mode == "decode":
        pos = torch.as_tensor(ctx.q_offset, device=x.device)
        pos_b = (pos.expand(B) if pos.dim() == 0 else pos)[:, None]
        q = rope(q, pos_b, cfg.rope_theta)
        k = rope(k, pos_b, cfg.rope_theta)
        kv_new = attn.paged_append(kv, k, v)
        o = attn.paged_decode_attention(q, kv_new, softcap=cfg.attn_softcap)
        return attn.out_proj(p, o), kv_new
    if ctx.kv_prefix_lens is not None:
        # Suffix-only prefill (CoW prefix sharing): row b's token 0 sits at
        # logical position kv_prefix_lens[b]; the skipped prefix's KV is
        # read back from the shared pool pages instead of being recomputed.
        positions = (torch.arange(S, device=x.device)[None]
                     + ctx.kv_prefix_lens[:, None])
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        o = attn.prefix_context_attention(
            q, k, v, kv, ctx.kv_prefix_lens,
            torch.broadcast_to(ctx.seq_lengths, (B,)),
            softcap=cfg.attn_softcap)
        return attn.out_proj(p, o), _prefill_write_global(kv, k, v, ctx, S)
    positions = torch.arange(S, device=x.device)[None] + ctx.q_offset
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = attn.flash_attention(q, k, v, causal=True, softcap=cfg.attn_softcap,
                             q_chunk=cfg.flash_q_chunk,
                             kv_chunk=cfg.flash_kv_chunk)
    y = attn.out_proj(p, o)
    if kv is None:
        return y, None
    return y, _prefill_write_global(kv, k, v, ctx, S)


def _prefill_write_global(kv: attn.PagedKV, k, v, ctx: FwdCtx, S: int
                          ) -> attn.PagedKV:
    """Scatter a batched prefill's KV through per-sequence block tables into
    the SHARED global pool, in place: no staging cache, no slot copy.

    Right-padded positions (>= seq_lengths) are zeroed and EVERY table entry
    of each row is written (real KV first, then zero pages), so recycled
    pages are scrubbed. Writes through NULL entries are dropped. With a
    cached prefix, row b's token s lands at logical position
    ``prefix[b] + s`` and the scatter goes through ``ctx.write_tables`` (the
    shared entries NULLed), so a shared page is never written.
    """
    lens = ctx.seq_lengths
    if lens is None:
        raise ValueError("global-layout prefill requires per-sequence "
                         "lengths")
    B = k.shape[0]
    page = kv.page_size
    P_ = kv.block_table.shape[-1]
    prefix = ctx.kv_prefix_lens
    if prefix is None:
        scatter_tbl = kv.block_table
        total_len = lens
    else:
        scatter_tbl = torch.broadcast_to(ctx.write_tables, kv.block_table.shape)
        total_len = lens + prefix
    dev = k.device
    keep = (torch.arange(S, device=dev)[None, :] < lens[:, None])[:, :, None, None]

    def pages_of(kv_seq, pool):
        kw = torch.where(keep, kv_seq, 0).to(pool.dtype)
        feat = kv_seq.shape[2:]
        if prefix is None:
            pad = P_ * page - S
            if pad > 0:
                kw = torch.cat([kw, kw.new_zeros((B, pad, *feat))], dim=1)
            elif pad < 0:
                kw = kw[:, :P_ * page]
        else:
            # Re-align each row so token s lands at logical slot prefix + s
            # (out-of-suffix slots read the scrub value 0).
            sidx = torch.arange(P_ * page, device=dev)[None, :] - prefix[:, None]
            valid = (sidx >= 0) & (sidx < lens[:, None])
            gidx = torch.clamp(sidx, 0, max(S - 1, 0)).long()
            kw = torch.gather(kw, 1, gidx[:, :, None, None].expand(
                -1, -1, *feat))
            kw = torch.where(valid[:, :, None, None], kw, 0)
        return kw.reshape(B * P_, page, *feat)

    attn.scatter_pages(kv.k_pool, scatter_tbl, pages_of(k, kv.k_pool))
    attn.scatter_pages(kv.v_pool, scatter_tbl, pages_of(v, kv.v_pool))
    return kv._replace(length=torch.broadcast_to(total_len, kv.length.shape)
                       .to(kv.length.dtype))


def apply_layer(kind: str, p, x, ctx: FwdCtx, kv: Optional[attn.PagedKV]):
    """One ``attn_mlp`` layer; returns (x, updated PagedKV or None)."""
    if kind != "attn_mlp":
        raise NotImplementedError(f"layer kind {kind!r} is not ported")
    cfg = ctx.cfg
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    y, kv = _self_attention(p["attn"], h, ctx, kv)
    x = x + y
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    x = x + glu_mlp(p["mlp"], h, cfg.act)
    return x, kv
