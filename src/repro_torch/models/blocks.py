"""Per-layer forward (port of ``repro/models/blocks.py``: the ``attn_mlp``
and ``attn_mlp_local`` layers of the dense decoders and jamba's ``attn``,
the same layer; ``attn_moe``, the same attention before an MoE FFN;
``rwkv``, a time mix and a channel mix, each with its own token shift;
jamba's ``mamba`` and ``mamba_moe``, the selective SSM before a GLU MLP or
an MoE FFN; llama-vision's ``xattn_mlp``, a gated cross-attention over the
image embeddings before its MLP; and seamless's ``cross_mlp``,
self-attention, then cross-attention over the encoder's output, then its
MLP, the 2-layer relu MLP where ``cfg.act`` is relu).

A layer's cache entry is a :class:`PagedKV` for an attention layer, an
:class:`RWKVState` or a :class:`MambaState` for a recurrent one, a
:class:`CrossKV` for ``xattn_mlp`` and the pair (PagedKV, CrossKV) for
``cross_mlp``. A cross-attention layer attends, without rope or a mask,
over its source: in a prefill it projects ``ctx.cross_x`` to K/V (the
layer's new CrossKV), in a decode it reads the cached ones. A
recurrent layer ignores ``seq_lengths``: it scans every position of its
rows, so the engine prefills such archs at exact lengths. Its new state is
returned (not written in place); a prefill without a cache starts from
zero state.

Two execution modes reach a layer here:
  prefill  a right-padded batch of prompts; KV is scattered into the shared
           global pool through per-sequence block tables (zero-copy), or,
           with a cached prefix, only the suffix is computed; or, on a
           per-slot cache (the copy baseline, or a sliding-window layer's
           ring), written into each slot's own pages through its table.
           Without a cache and with ``causal`` False, it is the encoder's
           pass over its full source
  decode   one token per sequence: append through the table, then attend
           over the pool through it

In training on a mesh (``ctx.tp``, the model axis larger than 1) a dense
layer runs its tensor-parallel form on this rank's blocks of the weights
(Megatron's column- and row-parallel layers): the normed input enters
through ``copy_to`` (its gradient summed over ``model``), ``wq`` (and
``wk``/``wv`` and the biases, where their heads split) are the rank's
heads and the flash kernel runs over them alone, ``wo`` is row parallel
and its output summed over ``model`` (``reduce_from``); the MLP's
``w_gate``/``w_up`` are column parallel over ``d_ff`` and ``w_down`` row
parallel, with its sum. K/V projections whose heads do not split (fewer
KV heads than the axis) are whole on every rank: each takes the KV
heads its own q heads read, and their gradient is summed over ``model``.
Norm weights are whole and their gradients are whole on every rank.
A cross-attention (``xattn_mlp``'s, ``cross_mlp``'s second) takes the
same form over its source (``_tp_cross_inputs``): the source enters
through ``copy_to`` too, since each rank projects it with its own KV
heads (for seamless its gradient is the encoder output's, which would
otherwise stay a part of the whole); the scalar ``gate``, whole on every
rank, scales the output after ``wo``'s sum (``_tp_gated_out``), so its
gradient is whole on every rank without a sum over ``model``. Seamless's
encoder layers are dense layers in this form, their blocks gathered by
``model._run_encoder``.

The recurrent layers' tensor-parallel forms (``rwkv`` and the mamba
kinds) live in their mixers, ``rwkv6.rwkv_time_mix``,
``rwkv6.rwkv_channel_mix`` and ``mamba.mamba_mix`` with ``tp``; their
modules' docstrings say where each collective happens. Their states
start at zero over the rank's heads or channels. A mamba layer's MLP is
the dense one above and a ``mamba_moe`` layer's FFN the MoE form below;
jamba's ``attn`` layer is the dense layer.

An MoE layer's tensor-parallel form (``_apply_moe``) is expert
parallelism: a rank holds E / model experts (the reference's ``("tp",
"fsdp", None)`` expert specs) and its block of the shared expert's hidden
units (a GLU like the dense MLP's, column then row parallel). The input
enters through ``copy_to``, as the router does (every model rank's
partial output reaches a part of its gradient); each rank routes every
token over all E experts, runs its own experts on the pairs routed to
them, and the routed and shared partial sums meet in one ``reduce_from``.
The reference needs an all-to-all here, because its token groups shard
over ``model`` too: it reshards the dispatched (G, E, C, d) buffer from G
over the whole mesh to E over ``model``. The port's activations are whole
across ``model`` (``model.batch_sharding`` splits rows over the data axes
alone), so every model rank already holds every token of its rows, and
the all-to-all becomes an all-reduce of the (T_local, d) output: fewer
bytes than the dispatched K * capacity_factor * T * d, and no collective
that gloo lacks.

Serving on a mesh through the engine, every rank runs the same layer on
the same, whole tensors, except under the sequence-parallel layout
(``ctx.sp``: one sequence whose pages are sharded over the ``data`` axis,
the long_500k shape): a rank's per-slot pools hold only its shard of the
pages, a prefill writes only the positions the rank owns, and a decode
appends on the owner shard and merges the shards' partial attention
(``attention.sp_paged_decode``).

Serving on a mesh through ``launch/steps.py``'s steps (``ctx.placed``,
set by ``model.forward_prefill``/``forward_decode`` with ``placed``, the
reference's lowered serve steps) a dense layer runs on this rank's rows,
its blocks of the weights in the tensor-parallel form above, and its
block of the per-slot cache as the reference's ``layer_cache_specs``
places it: the KV heads over ``model`` where there are at least 16, else
the tokens of every page (``_placed_attention``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models.dist import (NO_MESH, MeshInfo, all_gather,
                                     axis_rank, copy_to, reduce_from)
from repro_torch.models.layers import glu_mlp, mlp2, rmsnorm, rope
from repro_torch.models.moe import moe_ffn
from repro_torch.models.params import MAMBA_KINDS, SERVED_KINDS


@dataclass(frozen=True)
class FwdCtx:
    cfg: ModelConfig
    mode: str                   # prefill | decode
    causal: bool = True         # self-attention's mask (the encoder: False)
    q_offset: Any = 0           # rope/mask offset of token 0 (decode: (B,) lengths)
    # image or encoder embeddings (B, src_len, d) a prefill's cross-attention
    # projects to K/V
    cross_x: Optional[torch.Tensor] = None
    seq_lengths: Optional[torch.Tensor] = None     # (B,) real prompt lengths
    # CoW prefix sharing (suffix-only prefill): tokens already resident in
    # the shared pool per row, and the scatter tables whose shared entries
    # are NULLed so the prefill write never touches a shared page.
    kv_prefix_lens: Optional[torch.Tensor] = None  # (B,) int32
    write_tables: Optional[torch.Tensor] = None    # (B, max_pages) int32
    mi: MeshInfo = NO_MESH
    # sequence-parallel layout (long_500k): the per-slot pools are this
    # rank's shard of the pages over 'data' (prefill writes its positions,
    # decode runs attention.sp_paged_decode)
    sp: bool = False
    # training on a mesh whose model axis is larger than 1: the dense
    # layers' tensor-parallel forms over this rank's weight blocks
    tp: bool = False
    # training on a mesh: the axes whose ranks hold other rows of the batch
    # (a parameter's gradient sums over them)
    grad_axes: Tuple[str, ...] = ()
    # serving on a mesh with placed weights and cache (launch/steps.py's
    # steps): each attention layer's cache is this rank's block of
    # model.cache_specs, its weights the rank's blocks (tensor parallel
    # under ``tp``); ``page_split`` ranks of 'model' split each page's
    # tokens (1 where the placement keeps a page whole)
    placed: bool = False
    page_split: int = 1


SP_MIN_LEN = 262144


def _sp_mode(cfg: ModelConfig, batch: int, max_len: int) -> bool:
    """Sequence-parallel cache layout when batch can't cover the data axis
    (the reference's test: one sequence of at least 262144 tokens)."""
    return batch == 1 and max_len >= SP_MIN_LEN


def _tp_kv_heads(p, ctx: FwdCtx):
    """The attention's leaves for this rank's q heads under tensor
    parallelism. Where ``wk``/``wv`` hold all ``n_kv_heads`` (too few to
    split over ``model``), each takes the KV heads the rank's q heads read
    (global q head h reads KV head h // G): a slice where those q heads
    fall in equal runs, so GQA keeps its groups, else one KV head a q
    head. Every rank uses a part of them, so their gradient is summed
    over ``model``."""
    cfg, mi = ctx.cfg, ctx.mi
    if p["wk"].shape[1] != cfg.n_kv_heads:
        return p                                  # KV heads split too
    sel = _rank_kv_index(ctx, p["wq"].shape[1]).to(p["wk"].device)
    out = dict(p)
    for name in ("wk", "wv"):
        out[name] = copy_to(p[name], mi, "model").index_select(1, sel)
    for name in ("bk", "bv"):
        if name in p:
            out[name] = copy_to(p[name], mi, "model").index_select(0, sel)
    return out


def _rank_kv_index(ctx: FwdCtx, hq_l: int) -> torch.Tensor:
    """The KV heads this rank's ``hq_l`` q heads read, out of all
    ``n_kv_heads`` (global q head h reads KV head h // G): one index a KV
    head where the q heads fall in equal runs, so GQA keeps its groups,
    else one a q head."""
    G = ctx.cfg.n_heads // ctx.cfg.n_kv_heads
    first = axis_rank(ctx.mi, "model") * hq_l
    idx = torch.div(first + torch.arange(hq_l), G, rounding_mode="floor")
    heads, counts = torch.unique_consecutive(idx, return_counts=True)
    return heads if bool((counts == counts[0]).all()) else idx


def _placed_attention(p, x, ctx: FwdCtx, kv: Optional[attn.PagedKV],
                      window: Optional[int]):
    """Self-attention in serving on a mesh with placed weights and cache
    (``ctx.placed``): ``p`` the rank's blocks, ``kv`` its block of the
    per-slot cache (``model.cache_specs``), ``x`` its rows. Under ``tp``
    the rank's q heads (and its KV heads, where they split over
    ``model``; else all of them) come from its blocks of ``wq``/``wk``/
    ``wv``, ``wo`` is row parallel and its output summed over ``model``.

    Prefill: flash over the rank's q heads and the KV heads they read
    (``_rank_kv_index`` where ``wk`` is whole). The write needs every KV
    head the rank's pool holds for its rows: where the pool keeps all
    heads (the tokens of a page split over ``model``, or nothing split)
    but ``wk`` gave the rank a block of them, K/V are all-gathered over
    ``model`` along the heads. Gathering the activations, not ``wk`` and
    ``wv``: each rank projects its own heads once, no rank repeats the
    others' projections, and the gathered bytes (B_l S Hkv D) are those
    the pool stores. The write takes each row's pages as
    ``_prefill_write_slots`` lays them out and keeps the rank's slice of
    every page (``ctx.page_split``) or its heads.

    Decode, KV heads over ``model`` (the pool holds the rank's heads):
    the rank's q heads over its pool through the per-slot decode kernel.
    Otherwise q is all-gathered over ``model`` (B_l x Hq x D) and the new
    token's K/V likewise where ``wk`` is split; ``split_paged_decode``
    writes the token on its owner rank, runs the kernel over the rank's
    slice at page p / page_split and merges the partials over ``model``
    by their lse; the rank keeps its q heads for ``wo``. A ring (a
    sliding-window layer) wraps modulo its capacity in both."""
    cfg, mi = ctx.cfg, ctx.mi
    B, S, _ = x.shape
    q, k, v = attn.qkv_proj(p, x)
    hq_l = q.shape[2]
    part = axis_rank(mi, "model") if ctx.tp else 0
    kv_whole = k.shape[2] == cfg.n_kv_heads
    gather_heads = lambda t: (t if t.shape[2] == kv.k_pool.shape[3] else
                              all_gather(t, 2, mi, "model"))
    if ctx.mode == "decode":
        pos = torch.as_tensor(ctx.q_offset, device=x.device)
        pos_b = (pos.expand(B) if pos.dim() == 0 else pos)[:, None]
        q = rope(q, pos_b, cfg.rope_theta)
        k = rope(k, pos_b, cfg.rope_theta)
        if kv.k_pool.shape[3] < cfg.n_kv_heads:      # KV heads over 'model'
            kv_new = attn.paged_append(kv, k, v)
            o = attn.paged_decode_attention(q, kv_new,
                                            softcap=cfg.attn_softcap)
        else:
            q_all = all_gather(q, 2, mi, "model") if ctx.tp else q
            o, kv_new = attn.split_paged_decode(
                q_all, gather_heads(k), gather_heads(v), kv, mi,
                ctx.page_split, softcap=cfg.attn_softcap)
            o = o[:, :, part * hq_l:(part + 1) * hq_l]
        y = attn.out_proj(p, o)
        return (reduce_from(y, mi, "model") if ctx.tp else y), kv_new
    positions = torch.arange(S, device=x.device)[None] + ctx.q_offset
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    kr, vr = k, v
    if ctx.tp and kv_whole:
        sel = _rank_kv_index(ctx, hq_l).to(k.device)
        kr, vr = k.index_select(2, sel), v.index_select(2, sel)
    o = attn.flash_attention(q, kr, vr, causal=ctx.causal, window=window,
                             softcap=cfg.attn_softcap,
                             q_chunk=cfg.flash_q_chunk,
                             kv_chunk=cfg.flash_kv_chunk)
    y = attn.out_proj(p, o)
    if ctx.tp:
        y = reduce_from(y, mi, "model")
    if kv is None:
        return y, None
    return y, _prefill_write_slots(kv, gather_heads(k), gather_heads(v),
                                   ctx, S, ctx.page_split, part)


def _self_attention(p, x, ctx: FwdCtx, kv: Optional[attn.PagedKV],
                    window: Optional[int]):
    cfg = ctx.cfg
    B, S, _ = x.shape
    if ctx.placed:
        return _placed_attention(p, x, ctx, kv, window)
    if ctx.tp:
        x = copy_to(x, ctx.mi, "model")
        p = _tp_kv_heads(p, ctx)
    q, k, v = attn.qkv_proj(p, x)
    if ctx.mode == "decode":
        pos = torch.as_tensor(ctx.q_offset, device=x.device)
        pos_b = (pos.expand(B) if pos.dim() == 0 else pos)[:, None]
        q = rope(q, pos_b, cfg.rope_theta)
        k = rope(k, pos_b, cfg.rope_theta)
        if ctx.sp:
            o, kv_new = attn.sp_paged_decode(q, k, v, kv, ctx.mi.mesh,
                                             softcap=cfg.attn_softcap)
        else:
            kv_new = attn.paged_append(kv, k, v)
            o = attn.paged_decode_attention(q, kv_new,
                                            softcap=cfg.attn_softcap)
        return attn.out_proj(p, o), kv_new
    if ctx.kv_prefix_lens is not None and kv is not None \
            and attn.is_global_layout(kv):
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
    o = attn.flash_attention(q, k, v, causal=ctx.causal, window=window,
                             softcap=cfg.attn_softcap,
                             q_chunk=cfg.flash_q_chunk,
                             kv_chunk=cfg.flash_kv_chunk)
    y = attn.out_proj(p, o)
    if ctx.tp:
        y = reduce_from(y, ctx.mi, "model")
    if kv is None:
        return y, None
    if attn.is_global_layout(kv):
        return y, _prefill_write_global(kv, k, v, ctx, S)
    if ctx.sp:
        return y, _prefill_write_sp(kv, k, v, ctx, S)
    return y, _prefill_write_slots(kv, k, v, ctx, S)


def _prefill_write_slots(kv: attn.PagedKV, k, v, ctx: FwdCtx, S: int,
                         split: int = 1, part: int = 0) -> attn.PagedKV:
    """Write a prefill's KV into PER-SLOT pools (B, n_pages, page, H, D)
    through each row's permutation table, in place. Every page of every row
    is rewritten. With ``split`` > 1 the pools hold one rank's slice of
    each page, offsets [part * pl, (part + 1) * pl) of pages of pl *
    ``split`` tokens (``attention.split_paged_decode``'s placement).

    Ring alignment: token t lives at slot t % eff (eff = the pool's
    capacity), so the decode append, which writes position
    ``length % eff``, overwrites the OLDEST resident token.
    """
    B = k.shape[0]
    n_pages, pl = kv.k_pool.shape[1], kv.k_pool.shape[2]
    page = pl * split
    eff = n_pages * page
    dev = k.device
    # Physical page j of row b holds logical page inv[b, j].
    inv = torch.argsort(kv.block_table.long(), dim=1)

    def write(pool, kv_seq):
        feat = kv_seq.shape[2:]
        if ctx.seq_lengths is not None:
            # Right-padded batched prefill: per row, keep each sequence's
            # LAST min(len, eff) REAL tokens ring-aligned and zero the rest.
            lens = torch.broadcast_to(ctx.seq_lengths, (B,)).long()
            start = torch.clamp(lens - eff, min=0)[:, None]       # (B, 1)
            i = torch.arange(eff, device=dev)[None, :]
            idx = start + torch.remainder(i - start, eff)          # (B, eff)
            valid = idx < lens[:, None]
            idx = torch.clamp(idx, max=max(S - 1, 0))
            seg = torch.gather(kv_seq, 1, idx[:, :, None, None].expand(
                -1, -1, *feat))
            seg = torch.where(valid[:, :, None, None], seg, 0)
        elif eff < S:                      # pool shorter than the prompt:
            seg = torch.roll(kv_seq[:, -eff:], (S - eff) % eff, dims=1)
        elif eff > S:                      # pool capacity > prompt: pad
            seg = torch.cat([kv_seq, kv_seq.new_zeros((B, eff - S, *feat))],
                            dim=1)
        else:
            seg = kv_seq
        pages = seg.reshape(B, n_pages, page, *feat)
        if split > 1:
            pages = pages[:, :, part * pl:(part + 1) * pl]
        pool.copy_(torch.take_along_dim(pages, inv[:, :, None, None, None],
                                        dim=1))

    write(kv.k_pool, k)
    write(kv.v_pool, v)
    return kv._replace(length=torch.full_like(kv.length, min(S, eff)))


def _prefill_write_sp(kv: attn.PagedKV, k, v, ctx: FwdCtx, S: int
                      ) -> attn.PagedKV:
    """The per-slot prefill write under the sequence-parallel layout, in
    place. The table is the whole sequence's, (B, n_pages), on every rank;
    this rank's pools hold physical pages [r * lp, (r + 1) * lp) of it (lp
    = its local pages), the shard the reference's pool sharding over
    'data' gives rank r. Each local page receives the logical page the
    table maps to it, as :func:`_prefill_write_slots` places a ring's
    tokens (token t at position t % eff, eff the whole capacity; a
    right-padded row's last real tokens, the rest zero): a prompt longer
    than one shard's tokens spans ranks."""
    n_shards, r = ctx.mi.size("data"), axis_rank(ctx.mi, "data")
    B = k.shape[0]
    local_pages, page = kv.k_pool.shape[1], kv.k_pool.shape[2]
    if local_pages * n_shards != kv.block_table.shape[-1]:
        raise ValueError(f"{kv.block_table.shape[-1]} pages do not shard "
                         f"as {n_shards} x {local_pages}")
    eff = kv.block_table.shape[-1] * page
    dev = k.device
    lens = (torch.broadcast_to(ctx.seq_lengths, (B,)).long()
            if ctx.seq_lengths is not None
            else torch.full((B,), S, dtype=torch.long, device=dev))
    # Physical page j of row b holds logical page inv[b, j].
    inv = torch.argsort(kv.block_table.long(), dim=1)
    mine = inv[:, r * local_pages:(r + 1) * local_pages]        # (B, lp)
    i = (mine[:, :, None] * page
         + torch.arange(page, device=dev)).reshape(B, -1)        # positions
    start = torch.clamp(lens - eff, min=0)[:, None]              # (B, 1)
    idx = start + torch.remainder(i - start, eff)
    valid = idx < lens[:, None]
    idx = torch.clamp(idx, max=max(S - 1, 0))

    def write(pool, kv_seq):
        feat = kv_seq.shape[2:]
        seg = torch.gather(kv_seq, 1, idx[:, :, None, None].expand(
            -1, -1, *feat))
        seg = torch.where(valid[:, :, None, None], seg, 0)
        pool.copy_(seg.reshape(B, local_pages, page, *feat))

    write(kv.k_pool, k)
    write(kv.v_pool, v)
    return kv._replace(length=torch.full_like(kv.length, min(S, eff)))


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


def _cross_attention(p, x, ctx: FwdCtx, xkv: Optional[attn.CrossKV]):
    """Cross-attention, non-causal, no rope. Prefill: K/V projected from
    ``ctx.cross_x`` become the layer's new entry (where it has one).
    Decode: the query alone, over the cached K/V (Sq = 1). Under tensor
    parallelism (training) the self-attention's form over this rank's
    heads (``_tp_cross_inputs``), the gate applied after ``wo``'s sum
    (``_tp_gated_out``)."""
    cfg = ctx.cfg
    if ctx.mode == "decode":
        q, k, v = attn.q_proj(p, x), xkv.k, xkv.v
    else:
        src = ctx.cross_x.to(x.dtype)
        if ctx.tp:
            p, x, src = _tp_cross_inputs(p, x, src, ctx)
        q, k, v = attn.qkv_proj(p, x, kv_x=src)
    o = attn.flash_attention(q, k, v, causal=False,
                             q_chunk=cfg.flash_q_chunk,
                             kv_chunk=cfg.flash_kv_chunk)
    if ctx.mode != "decode" and xkv is not None:
        xkv = attn.CrossKV(k, v)
    if ctx.tp:
        return _tp_gated_out(p, o, ctx), xkv
    return attn.out_proj(p, o), xkv


def _tp_cross_inputs(p, x, src, ctx: FwdCtx):
    """The cross-attention's leaves and inputs under tensor parallelism:
    the K/V projections as :func:`_tp_kv_heads` gives them, and the query's
    input ``x`` and the source ``src`` through ``copy_to``: each rank
    projects them with its own heads, so its gradient of each is a part
    of the whole one (for seamless, the source's is the encoder output's
    gradient)."""
    return (_tp_kv_heads(p, ctx), copy_to(x, ctx.mi, "model"),
            copy_to(src, ctx.mi, "model"))


def _tp_gated_out(p, o, ctx: FwdCtx):
    """A rank's heads through its rows of ``wo``, summed over ``model``,
    then scaled by tanh(gate). The gate is whole on every rank and scales
    the sum, so each rank's gate gradient is already the whole one (its
    sum over the data ranks is ``_use_params``'s); before the sum it would
    be a partial one."""
    y = reduce_from(attn.out_proj(p, o, gated=False), ctx.mi, "model")
    return attn.gate(p, y)


def _apply_mlp(p, x, ctx: FwdCtx):
    """The layer's MLP; under tensor parallelism over this rank's hidden
    units, its partial output summed over ``model``."""
    if ctx.tp:
        x = copy_to(x, ctx.mi, "model")
    y = mlp2(p, x, ctx.cfg.act) if "w1" in p else glu_mlp(p, x, ctx.cfg.act)
    return reduce_from(y, ctx.mi, "model") if ctx.tp else y


def _apply_moe(p, x, ctx: FwdCtx):
    """The layer's MoE FFN; under tensor parallelism over this rank's
    experts and shared hidden units, with the input and the router through
    ``copy_to`` and the partial sums through one ``reduce_from`` (the
    module's docstring). In a train step on a mesh the token groups are
    the global batch's (``moe.local_groups`` over ``ctx.grad_axes``)."""
    if not ctx.tp:
        return moe_ffn(p, x, ctx.cfg, ctx.mi, row_axes=ctx.grad_axes)
    x = copy_to(x, ctx.mi, "model")
    p = {**p, "router": copy_to(p["router"], ctx.mi, "model")}
    y = moe_ffn(p, x, ctx.cfg, ctx.mi, row_axes=ctx.grad_axes)
    return reduce_from(y, ctx.mi, "model")


def _split(ctx: FwdCtx) -> int:
    """The ranks a layer's tensor-parallel widths split over: the model
    axis's size under ``ctx.tp``, else 1."""
    return ctx.mi.size("model") if ctx.tp else 1


def _rwkv_layer(p, x, ctx: FwdCtx, st: Optional[rwkv.RWKVState]):
    cfg = ctx.cfg
    st0 = st if st is not None else \
        rwkv.zero_state(cfg, x.shape[0], x.dtype, x.device, _split(ctx))
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    h_prev, new_tm = rwkv.token_shift(h, st0.shift_tm)
    if ctx.mode == "decode":
        y, wkv = rwkv.rwkv_time_mix_step(p["tm"], h, h_prev, cfg, st0.wkv)
    else:
        y, wkv = rwkv.rwkv_time_mix(p["tm"], h, h_prev, cfg, st0.wkv,
                                    mi=ctx.mi, tp=ctx.tp)
    x = x + y
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    h_prev, new_cm = rwkv.token_shift(h, st0.shift_cm)
    x = x + rwkv.rwkv_channel_mix(p["cm"], h, h_prev, mi=ctx.mi, tp=ctx.tp)
    return x, (rwkv.RWKVState(wkv, new_tm, new_cm) if st is not None
               else None)


def apply_layer(kind: str, p, x, ctx: FwdCtx, cache):
    """One layer of ``kind``; ``cache`` is its PagedKV (attention kinds),
    RWKVState (rwkv), MambaState (mamba kinds), CrossKV (xattn_mlp) or
    (PagedKV, CrossKV) (cross_mlp), or None. Returns (x, the updated entry,
    or None without one). An attention layer attends over its last
    ``sliding_window`` tokens where it is ``attn_mlp_local`` (in decode its
    ring holds only those)."""
    if kind not in SERVED_KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported")
    cfg = ctx.cfg
    if kind == "rwkv":
        return _rwkv_layer(p, x, ctx, cache)
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kind in MAMBA_KINDS:
        st = cache if cache is not None else \
            mam.zero_state(cfg, x.shape[0], x.dtype, x.device, _split(ctx))
        if ctx.mode == "decode":
            y, st = mam.mamba_mix_step(p["mamba"], h, cfg, st)
        else:
            y, st = mam.mamba_mix(p["mamba"], h, cfg, st, mi=ctx.mi,
                                  tp=ctx.tp)
        cache = st if cache is not None else None
    elif kind == "xattn_mlp":
        y, cache = _cross_attention(p["xattn"], h, ctx, cache)
    elif kind == "cross_mlp":
        kv, xkv = cache if cache is not None else (None, None)
        y, kv = _self_attention(p["attn"], h, ctx, kv, None)
        x = x + y
        h = rmsnorm(x, p["lnx"], cfg.norm_eps)
        y, xkv = _cross_attention(p["xattn"], h, ctx, xkv)
        cache = (kv, xkv) if cache is not None else None
    else:
        window = cfg.sliding_window if kind == "attn_mlp_local" else None
        y, cache = _self_attention(p["attn"], h, ctx, cache, window)
    x = x + y
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if kind in ("attn_moe", "mamba_moe"):
        return x + _apply_moe(p["moe"], h, ctx), cache
    return x + _apply_mlp(p["mlp"], h, ctx), cache
