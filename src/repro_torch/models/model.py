"""Model assembly (port of ``repro/models/model.py``, serving subset):
embedding -> blocks (a Python loop) -> final norm -> tied head.

The cache is a list with one global-layout :class:`PagedKV` per layer (the
JAX package stacks the same leaves under a leading ``(n_blocks,)`` axis).

  init_cache(cfg, batch, max_len, page_size, global_pages, device)
  forward_prefill(cfg, params, batch, cache) -> (last_logits, cache)
  forward_decode(cfg, params, token, pos, cache) -> (logits, cache)
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.blocks import FwdCtx, apply_layer
from repro_torch.models.layers import embed, logits_fn, rmsnorm
from repro_torch.models.params import resolve_device, torch_dtype

Cache = List[attn.PagedKV]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, page_size: int,
               global_pages: int, device="cuda") -> Cache:
    """Zero-filled global-layout cache: per layer, one pool of
    ``global_pages`` pages shared by all ``batch`` slots, every table entry
    NULL (== global_pages) until the engine uploads real rows, lengths 0."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.activation_dtype)
    n_pages = -(-max_len // page_size)
    shape = (global_pages, page_size, cfg.n_kv_heads, cfg.d_head)
    table = torch.full((batch, n_pages), global_pages, dtype=torch.int32,
                       device=dev)
    length = torch.zeros((batch,), dtype=torch.int32, device=dev)
    return [attn.PagedKV(torch.zeros(shape, dtype=dt, device=dev),
                         torch.zeros(shape, dtype=dt, device=dev),
                         table, length)
            for _ in cfg.layer_kinds()]


def set_cache_length(cache: Cache, length) -> Cache:
    """``length``: scalar or (B,) per-sequence lengths."""
    out = []
    for kv in cache:
        ln = torch.as_tensor(length, device=kv.length.device)
        out.append(kv._replace(length=torch.broadcast_to(ln, kv.length.shape)
                               .to(kv.length.dtype)))
    return out


def install_tables(cache: Cache, tables: torch.Tensor,
                   lengths: torch.Tensor) -> Cache:
    """Point every layer's PagedKV at ``tables`` (B, P) and ``lengths``."""
    return [kv._replace(block_table=tables, length=lengths) for kv in cache]


def _run_blocks(cfg: ModelConfig, params, x, ctx: FwdCtx,
                cache: Optional[Cache]):
    new_cache = [] if cache is not None else None
    li = 0
    for p_blk in params["blocks"]:
        for i, kind in enumerate(cfg.block_pattern):
            kv = cache[li] if cache is not None else None
            x, kv = apply_layer(kind, p_blk[str(i)], x, ctx, kv)
            if new_cache is not None:
                new_cache.append(kv)
            li += 1
    return x, new_cache


def _embed_in(cfg: ModelConfig, params, tokens):
    x = embed(params["embed"], tokens).to(torch_dtype(cfg.activation_dtype))
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def forward_prefill(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
                    cache: Optional[Cache]):
    """``batch``: tokens (B, S) right-padded; lengths (B,) real lengths;
    optionally prefix_lens (B,) (tokens already resident in the shared pool;
    ``tokens`` then holds only each prompt's suffix) and write_tables (B, P)
    (the scatter tables with shared entries NULLed). Returns the logits at
    each row's last real token, (B, 1, V), and the cache."""
    tokens = batch["tokens"]
    lengths = batch.get("lengths")
    prefix_lens = batch.get("prefix_lens")
    ctx = FwdCtx(cfg=cfg, mode="prefill", seq_lengths=lengths,
                 kv_prefix_lens=prefix_lens,
                 write_tables=batch.get("write_tables"))
    x = _embed_in(cfg, params, tokens)
    x, cache = _run_blocks(cfg, params, x, ctx, cache)
    if lengths is None:
        x = x[:, -1:]
    else:
        idx = torch.clamp(lengths.long() - 1, min=0)[:, None, None]
        x = torch.gather(x, 1, idx.expand(-1, 1, x.shape[-1]))
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    logits = logits_fn(params["embed"], x, cfg.logit_softcap)
    if cache is not None:
        total = tokens.shape[1] if lengths is None else lengths
        if prefix_lens is not None:
            total = total + prefix_lens        # cache holds prefix + suffix
        cache = set_cache_length(cache, total)
    return logits, cache


def forward_decode(cfg: ModelConfig, params, token: torch.Tensor, pos,
                   cache: Cache):
    """token: (B, 1) int; pos: (B,) or scalar current cache length."""
    ctx = FwdCtx(cfg=cfg, mode="decode", q_offset=pos)
    x = _embed_in(cfg, params, token)
    x, cache = _run_blocks(cfg, params, x, ctx, cache)
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    return logits_fn(params["embed"], x, cfg.logit_softcap), cache
