"""Model assembly (port of ``repro/models/model.py``): (the encoder, for
an encoder-decoder) -> embedding -> first dense layers -> blocks (a Python
loop) -> final norm -> head, or in training the chunked cross-entropy.

The cache is a flat list of entries, one per layer in ``cfg.layer_kinds()``
order (``first_k_dense`` layers first) and two for a ``cross_mlp`` layer:
a :class:`PagedKV` for an attention layer, in the global or the per-slot
layout, chosen per layer; a per-slot recurrent state, :class:`RWKVState`
or :class:`MambaState`, for a recurrent one; a per-slot :class:`CrossKV`
for a cross-attention (``xattn_mlp``'s only entry, ``cross_mlp``'s second
beside its PagedKV). An encoder-decoder's list ends with one more per-slot
entry, :class:`EncOut`, the encoder's output, which the reference keeps as
``cache["enc_out"]`` (the JAX package keeps the first layers' entries under
``"first"`` and stacks the blocks' under a leading ``(n_blocks,)`` axis).
Every entry that is not a PagedKV is a NamedTuple of tensors with one row
a slot, which the walkers below treat alike.

  cache_specs(cfg, batch, max_len, page_size=DEFAULT_PAGE_SIZE,
              src_len=ENCDEC_SRC_LEN, global_pages=None) -> ParamSpec list
  init_cache(cfg, batch, max_len, page_size, global_pages=None, device,
             src_len=ENCDEC_SRC_LEN, mi=NO_MESH, placed=False)
  forward_prefill(cfg, params, batch, cache, mi=NO_MESH, placed=False,
                  page_size=DEFAULT_PAGE_SIZE) -> (last_logits, cache)
  forward_decode(cfg, params, token, pos, cache, mi=NO_MESH, sp=None,
                 placed=False, page_size=DEFAULT_PAGE_SIZE)
      -> (logits, cache)
  forward_train(cfg, params, batch, mi=NO_MESH) -> loss

Training on a mesh (``mi``; every arch whose widths split over the model
axis, ``check_mesh_trainable``) each rank holds its blocks of the
parameters (FSDP over ``data``, TP over ``model``, ``params.shardings``)
and takes its rows of the global batch; see :func:`forward_train`.

Serving on a mesh through the engine, every rank runs the same forward
on the same inputs. One sequence of at least 262144 tokens
(``blocks._sp_mode``) takes the sequence-parallel layout: each attention
layer's per-slot pools hold only this rank's shard of the pages over
``data`` (every rank holds the whole block table), a prefill writes the
rank's positions, and a decode merges the shards' partial attention
(``attention.sp_paged_decode``).

Serving on a mesh through the serve steps (``placed``; the dense kinds,
``mesh_serve_refusal``), each rank holds its blocks of the weights as
training places them and its block of the per-slot cache as
``cache_specs`` places it (``init_cache(..., mi=, placed=True)``), and
takes its rows of the global batch; see :func:`forward_prefill`.

A prefill's ``batch`` carries ``enc_x`` (B, src_len, d) for an
encoder-decoder, whose encoder runs non-causal over it, or ``img_x``
(B, n_image_tokens, d) for an image model.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import torch
# Imported with the module, not on ``checkpoint``'s first call (its
# ``torch._disable_dynamo`` wrapper imports it lazily): that import keeps
# its callers' frames, and with them a first training step's tensors, in
# a reference cycle until the garbage collector runs.
import torch._dynamo  # noqa: F401
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models.blocks import (SP_MIN_LEN, FwdCtx, _sp_mode,
                                       apply_layer)
from repro_torch.models.dist import (NO_MESH, MeshInfo, all_gather,
                                     gather_param, reduce_from)
from repro_torch.models.layers import (chunked_xent, embed, logits_fn,
                                      rmsnorm, vocab_parallel_embed,
                                      vocab_parallel_xent)
from repro_torch.models.params import (MAMBA_KINDS, ParamSpec, Sharding,
                                       abstract, model_specs, resolve_device,
                                       sharding_of, shardings, split_axes,
                                       torch_dtype)
from repro_torch.tree import tree_map

DEFAULT_PAGE_SIZE = 64
ENCDEC_SRC_LEN = 3072          # the reference's stubbed audio-frame count
# the reference places a per-slot pool's KV heads over 'model' from this
# many on (blocks.py's layer_cache_specs), else each page's tokens
KV_HEADS_SPLIT = 16


class EncOut(NamedTuple):
    """An encoder-decoder's encoder output, one row a slot: x (B, src_len,
    d), kept beside the cache as the reference keeps it."""
    x: torch.Tensor


Cache = List[Union[attn.PagedKV, attn.CrossKV, rwkv.RWKVState,
                   mam.MambaState, EncOut]]


def _layer_entries(kind: str) -> int:
    """Cache entries of one layer of ``kind``: a cross_mlp layer's PagedKV
    and CrossKV, one entry for every other kind."""
    return 2 if kind == "cross_mlp" else 1


def layer_capacity(cfg: ModelConfig, kind: str, max_len: int) -> int:
    """Tokens a layer's cache holds per sequence: a sliding-window layer
    keeps only its last ``sliding_window`` (a ring), every other layer all
    ``max_len``."""
    if kind == "attn_mlp_local" and cfg.sliding_window:
        return min(max_len, cfg.sliding_window)
    return max_len


def _kv_specs(cfg: ModelConfig, kind: str, batch: int, max_len: int,
              page_size: int, global_pages: Optional[int]) -> attn.PagedKV:
    """One attention layer's PagedKV of ParamSpecs, as the reference's
    ``layer_cache_specs`` places it (see :func:`cache_specs`)."""
    act = cfg.activation_dtype
    tail = (page_size, cfg.n_kv_heads, cfg.d_head)
    cap = layer_capacity(cfg, kind, max_len)
    n_pages = -(-cap // page_size)
    sp = _sp_mode(cfg, batch, max_len)
    heads = cfg.n_kv_heads >= KV_HEADS_SPLIT
    if global_pages is not None and cap == max_len and not sp:
        shape = (global_pages, *tail)
        pool = (None, None, "tp", None) if heads else (None, "tp", None, None)
        table = ("batch", None)
    else:
        shape = (batch, n_pages, *tail)
        if sp:          # long-context decode: pages over 'data'
            pool, table = (None, "data", None, None, None), (None, "data")
        elif heads:     # KV heads divide the model axis: head TP
            pool, table = ("batch", None, None, "tp", None), ("batch", None)
        else:           # each page's tokens over 'model' (flash-decoding)
            pool, table = ("batch", None, "tp", None, None), ("batch", None)
    return attn.PagedKV(
        ParamSpec(shape, "zeros", dtype=act, pspec=pool),
        ParamSpec(shape, "zeros", dtype=act, pspec=pool),
        ParamSpec((batch, n_pages), "zeros", dtype="int32", pspec=table),
        ParamSpec((batch,), "zeros", dtype="int32", pspec=("batch",)))


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                page_size: int = DEFAULT_PAGE_SIZE,
                src_len: int = ENCDEC_SRC_LEN,
                global_pages: Optional[int] = None) -> Cache:
    """The reference's ``cache_specs`` (and ``layer_cache_specs``) in the
    port's flat layout: one entry a layer (two for ``cross_mlp``), each a
    NamedTuple of ParamSpecs with the reference's logical specs; where the
    reference stacks a leaf over ``n_blocks``, each block's layer has its
    own entry. A per-slot pool (B, n_pages, page, Hkv, D) places its rows
    over the batch axes and, with at least 16 KV heads, its heads over
    ``model``, else each page's tokens; under the sequence-parallel
    layout (B 1, >= 262144 tokens) its pages over ``data``; the global
    pool (``global_pages``) its heads or tokens over ``model``. Cross K/V
    (B, src_len, Hkv, D) and the encoder output (B, src_len, d) place
    their source rows over ``model``; recurrent states as
    ``rwkv6.state_specs`` and ``mamba.state_specs``. One difference is
    kept: a PagedKV's ``length`` is (B,), one a row, over the batch axes;
    the reference's per-slot length is one scalar (``per_seq=False``)."""
    act = cfg.activation_dtype
    out = []
    cross = lambda: ParamSpec((batch, src_len, cfg.n_kv_heads, cfg.d_head),
                              "zeros", dtype=act,
                              pspec=("batch", "tp", None, None))
    for kind in cfg.layer_kinds():
        if kind == "xattn_mlp":
            out.append(attn.CrossKV(cross(), cross()))
        elif kind == "rwkv":
            out.append(rwkv.state_specs(cfg, batch))
        elif kind in MAMBA_KINDS:
            out.append(mam.state_specs(cfg, batch))
        else:
            out.append(_kv_specs(cfg, kind, batch, max_len, page_size,
                                 global_pages))
            if kind == "cross_mlp":
                out.append(attn.CrossKV(cross(), cross()))
    if cfg.is_encdec:
        out.append(EncOut(ParamSpec((batch, src_len, cfg.d_model), "zeros",
                                    dtype=act, pspec=("batch", "tp", None))))
    return out


def _placed_cache(cfg: ModelConfig, batch: int, max_len: int,
                  page_size: int, device, src_len: int,
                  mi: MeshInfo) -> Cache:
    """This rank's blocks of :func:`cache_specs` (per-slot layout), zero,
    with its rows of the identity tables."""
    if _sp_mode(cfg, batch, max_len):
        raise NotImplementedError(
            f"serving {cfg.name} with placed weights: the sequence-parallel "
            f"layout (batch 1, >= {SP_MIN_LEN} tokens) is not ported")
    specs = cache_specs(cfg, batch, max_len, page_size, src_len)
    sh = shardings(specs, mi)
    cache = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                           device=device),
                     abstract(specs, mi))
    out = []
    for e, s_ in zip(cache, sh):
        if not is_state(e):
            n = e.block_table.shape[-1]
            whole = torch.arange(n, dtype=torch.int32, device=device) \
                .expand(batch, n)
            e = e._replace(block_table=s_.block_table.cut(whole).clone(
                memory_format=torch.contiguous_format))
        out.append(e)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, page_size: int,
               global_pages: Optional[int] = None, device="cuda",
               src_len: int = ENCDEC_SRC_LEN, mi: MeshInfo = NO_MESH,
               placed: bool = False) -> Cache:
    """Zero-filled cache, lengths 0, one layout chosen per layer.

    With ``global_pages``, a layer that holds all ``max_len`` tokens gets one
    pool of that many pages shared by all ``batch`` slots, every table entry
    NULL (== global_pages) until the engine uploads real rows. Every other
    layer, and every layer without ``global_pages``, gets per-slot pools
    (batch, n_pages, page, Hkv, D) with identity tables: a sliding-window
    layer's is a ring of ``ceil(window / page)`` pages, which needs no
    dynamic paging. A recurrent layer gets its zero state, one row a slot,
    in the shapes and dtypes of the reference's ``rwkv_state_specs`` and
    ``mamba_state_specs``. A cross-attention gets zero K/V of ``src_len``
    rows a slot, and an encoder-decoder a zero encoder output as long.

    Under the sequence-parallel layout (``batch`` 1 and ``max_len`` >=
    262144, with or without ``global_pages``, as the reference) each
    attention layer's pools hold only this rank's shard of the pages over
    the mesh's ``data`` axis, physical pages [r * lp, (r + 1) * lp) of the
    identity table, which every rank holds whole; without a mesh the
    shard is the whole pool (and a decode refuses it).

    With ``placed`` on a mesh (the serve steps of ``launch/steps.py``),
    this rank's blocks of :func:`cache_specs`' per-slot placements: its
    rows, and its KV heads or its slice of every page's tokens over
    ``model``; ``global_pages`` and the sequence-parallel layout raise
    ``NotImplementedError`` there.
    """
    dev = resolve_device(device)
    if placed and mi.active:
        if global_pages is not None:
            raise NotImplementedError(
                "placed serving takes the per-slot cache; the global "
                "layout's placement is not ported")
        return _placed_cache(cfg, batch, max_len, page_size, dev, src_len,
                             mi)
    dt = torch_dtype(cfg.activation_dtype)
    tail = (page_size, cfg.n_kv_heads, cfg.d_head)
    max_pages = -(-max_len // page_size)
    cache = []
    cross = (batch, src_len, cfg.n_kv_heads, cfg.d_head)
    sp = _sp_mode(cfg, batch, max_len)
    n_shards = mi.size("data") if sp else 1

    def zero_cross():
        return attn.CrossKV(torch.zeros(cross, dtype=dt, device=dev),
                            torch.zeros(cross, dtype=dt, device=dev))

    for kind in cfg.layer_kinds():
        if kind == "xattn_mlp":
            cache.append(zero_cross())
            continue
        if kind == "rwkv":
            cache.append(rwkv.zero_state(cfg, batch, dt, dev))
            continue
        if kind in MAMBA_KINDS:
            cache.append(mam.zero_state(cfg, batch, dt, dev))
            continue
        cap = layer_capacity(cfg, kind, max_len)
        if global_pages is not None and cap == max_len and not sp:
            shape = (global_pages, *tail)
            table = torch.full((batch, max_pages), global_pages,
                               dtype=torch.int32, device=dev)
        else:
            n_pages = -(-cap // page_size)
            if n_pages % n_shards:
                raise ValueError(f"{n_pages} pages do not shard over "
                                 f"{n_shards} ranks of 'data'")
            local = n_pages // n_shards
            shape = (batch, local, *tail)
            table = torch.arange(n_pages, dtype=torch.int32, device=dev) \
                .expand(batch, n_pages).contiguous()
        cache.append(attn.PagedKV(
            torch.zeros(shape, dtype=dt, device=dev),
            torch.zeros(shape, dtype=dt, device=dev), table,
            torch.zeros((batch,), dtype=torch.int32, device=dev)))
        if kind == "cross_mlp":
            cache.append(zero_cross())
    if cfg.is_encdec:
        cache.append(EncOut(torch.zeros((batch, src_len, cfg.d_model),
                                        dtype=dt, device=dev)))
    return cache


def is_state(entry) -> bool:
    """Whether a cache entry is a per-slot NamedTuple of rows (a recurrent
    layer's RWKVState or MambaState, a CrossKV, an EncOut) rather than an
    attention layer's PagedKV."""
    return not isinstance(entry, attn.PagedKV)


def per_slot(entry) -> bool:
    """Whether an entry holds one row a slot (a recurrent state, cross K/V,
    the encoder output, or per-slot pools such as a sliding-window ring)
    rather than a view of the shared global pool."""
    return is_state(entry) or not attn.is_global_layout(entry)


def fresh_rows(entry, nb: int):
    """``nb`` zero rows of a per-slot entry: a state's zero leaves, or zero
    pools with identity tables and lengths 0."""
    if is_state(entry):
        return type(entry)(*(t.new_zeros((nb, *t.shape[1:])) for t in entry))
    n_pages = entry.block_table.shape[-1]
    shape = (nb, *entry.k_pool.shape[1:])
    return attn.PagedKV(
        entry.k_pool.new_zeros(shape), entry.v_pool.new_zeros(shape),
        torch.arange(n_pages, dtype=torch.int32,
                     device=entry.block_table.device).expand(nb, n_pages),
        entry.length.new_zeros(nb))


def scatter_rows(entry, rows, slots: torch.Tensor) -> None:
    """Write the first ``len(slots)`` rows of ``rows`` (the entry as a
    prefill returned it) to ``slots`` of a per-slot entry, in place."""
    n = slots.shape[0]
    pairs = (zip(entry, rows) if is_state(entry) else
             ((entry.k_pool, rows.k_pool), (entry.v_pool, rows.v_pool)))
    for dst, src in pairs:
        dst[slots] = src[:n]


def install(entry, tables: Optional[torch.Tensor], lengths: torch.Tensor):
    """A PagedKV pointed at ``tables`` (B, P) (None: its own) and
    ``lengths``; a recurrent state passes through."""
    if is_state(entry):
        return entry
    if tables is None:
        return entry._replace(length=lengths)
    return entry._replace(block_table=tables, length=lengths)


def set_cache_length(cache: Cache, length) -> Cache:
    """``length``: scalar or (B,) per-sequence lengths; recurrent states
    pass through."""
    out = []
    for kv in cache:
        if is_state(kv):
            out.append(kv)
            continue
        ln = torch.as_tensor(length, device=kv.length.device)
        out.append(kv._replace(length=torch.broadcast_to(ln, kv.length.shape)
                               .to(kv.length.dtype)))
    return out


def install_tables(cache: Cache, tables: torch.Tensor,
                   lengths: torch.Tensor) -> Cache:
    """Point every layer's PagedKV at ``tables`` (B, P) and ``lengths``;
    recurrent states pass through."""
    return [install(kv, tables, lengths) for kv in cache]


def _decode_is_sp(cfg: ModelConfig, cache: Cache) -> bool:
    """Whether ``cache`` has the sequence-parallel layout, by the
    reference's test on its first PagedKV: a per-slot cache of one
    sequence whose table (the whole sequence's, on every rank) spans at
    least 262144 tokens."""
    kv = next((e for e in cache if not is_state(e)), None)
    if kv is None or attn.is_global_layout(kv):
        return False
    return _sp_mode(cfg, kv.k_pool.shape[0],
                    kv.block_table.shape[-1] * kv.page_size)


def layers(cfg: ModelConfig, params) -> List[Tuple[str, dict]]:
    """(kind, parameters) of every layer in ``cfg.layer_kinds()`` order:
    the ``first_k_dense`` dense layers, then the blocks'."""
    first = [("attn_mlp", params["first"][str(i)])
             for i in range(cfg.first_k_dense)]
    return first + [(kind, blk[str(i)]) for blk in params["blocks"]
                    for i, kind in enumerate(cfg.block_pattern)]


def by_layer(cfg: ModelConfig, cache: Cache) -> list:
    """The layers' entries of a flat cache, one item a layer in
    ``cfg.layer_kinds()`` order: the entry, or a cross_mlp layer's
    (PagedKV, CrossKV) pair. An encoder-decoder's EncOut is left out."""
    out, i = [], 0
    for kind in cfg.layer_kinds():
        n = _layer_entries(kind)
        out.append(cache[i] if n == 1 else tuple(cache[i:i + n]))
        i += n
    return out


def flat(cfg: ModelConfig, entries: list) -> Cache:
    """The inverse of :func:`by_layer` (without the EncOut)."""
    out = []
    for kind, e in zip(cfg.layer_kinds(), entries):
        out.extend(e if _layer_entries(kind) > 1 else [e])
    return out


def _run_blocks(cfg: ModelConfig, params, x, ctx: FwdCtx,
                cache: Optional[Cache]):
    entries = by_layer(cfg, cache) if cache is not None else None
    new = [] if cache is not None else None
    for li, (kind, p) in enumerate(layers(cfg, params)):
        x, e = apply_layer(kind, p, x, ctx,
                           entries[li] if entries is not None else None)
        if new is not None:
            new.append(e)
    return x, (flat(cfg, new) if new is not None else None)


def _run_encoder(cfg: ModelConfig, params, enc_x: torch.Tensor,
                 ctx: Optional[FwdCtx] = None, sh=None) -> torch.Tensor:
    """The encoder over ``enc_x`` (B, src_len, d): its blocks over the full
    sequence, non-causal and without a cache (the reference runs them in
    its ``"train"`` mode), then its final norm. In a train step on a mesh
    (``ctx``, the step's; ``sh``, the encoder's Shardings) each block and
    the final norm are gathered at use as the decoder's are
    (``_use_params``), and the layers run their tensor-parallel forms;
    not rematerialised, as the reference's encoder is not."""
    ctx = (FwdCtx(cfg=cfg, mode="prefill", causal=False) if ctx is None
           else dataclasses.replace(ctx, causal=False, cross_x=None))
    x = enc_x.to(torch_dtype(cfg.activation_dtype))
    enc = params["encoder"]
    for b, blk in enumerate(enc["blocks"]):
        blk = _use_params(blk, sh and sh["blocks"][b], ctx)
        for i, kind in enumerate(cfg.enc_block_pattern):
            x, _ = apply_layer(kind, blk[str(i)], x, ctx, None)
    return rmsnorm(x, _use_params(enc["final_ln"], sh and sh["final_ln"],
                                  ctx), cfg.norm_eps)


def _cross_source(cfg: ModelConfig, params, batch, ctx: Optional[FwdCtx] = None,
                  sh=None) -> Optional[torch.Tensor]:
    """What a prefill's cross-attention attends over: the encoder's output
    over ``enc_x`` (on a mesh, ``_run_encoder`` with the train step's
    ``ctx`` and the encoder's Shardings ``sh``), or ``img_x`` itself; None
    for a decoder alone."""
    if cfg.is_encdec:
        return _run_encoder(cfg, params, batch["enc_x"], ctx, sh)
    if cfg.n_image_tokens:
        return batch["img_x"].to(torch_dtype(cfg.activation_dtype))
    return None


def _embed_in(cfg: ModelConfig, params, tokens, vocab_mi=None):
    """The scaled embedding of ``tokens``; with ``vocab_mi`` the table is
    this rank's vocab block on that mesh (``vocab_parallel_embed``)."""
    x = (embed(params["embed"], tokens) if vocab_mi is None else
         vocab_parallel_embed(params["embed"], tokens, vocab_mi))
    x = x.to(torch_dtype(cfg.activation_dtype))
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def mesh_serve_refusal(cfg: ModelConfig, model: int) -> Optional[str]:
    """Why serving ``cfg`` with placed weights on a mesh whose model axis
    is ``model`` (the serve steps of ``launch/steps.py``) is not ported,
    or None: every layer kind but the dense ones (``attn_mlp``,
    ``attn_mlp_local``), and widths that do not split over the model
    axis (q heads, ``d_ff``), where a layer would run whole on every rank
    and its sum over ``model`` count it ``model`` times."""
    kinds = set(cfg.layer_kinds())
    if cfg.is_encdec:
        kinds |= set(cfg.enc_block_pattern)
    other = sorted(kinds - set(DENSE_KINDS))
    if other:
        return (f"serving {cfg.name} with placed weights on a mesh: layer "
                f"kind(s) {', '.join(other)} have no serving form on a "
                f"mesh (ported: {', '.join(DENSE_KINDS)})")
    bad = {k: v for k, v in (("heads", cfg.n_heads), ("d_ff", cfg.d_ff))
           if v % model}
    if bad:
        return (f"serving {cfg.name} on a mesh: "
                + ", ".join(f"{k} {v}" for k, v in bad.items())
                + f" must split over a model axis of {model}")
    return None


def check_mesh_servable(cfg: ModelConfig, mi: MeshInfo) -> None:
    """Raise ``NotImplementedError`` where serving ``cfg`` with placed
    weights on ``mi``'s mesh is not ported (:func:`mesh_serve_refusal`)."""
    why = mesh_serve_refusal(cfg, model_size(mi)) if mi.active else None
    if why:
        raise NotImplementedError(why)


def page_split(cfg: ModelConfig, page_size: int, mi: MeshInfo) -> int:
    """The ranks of ``model`` each page's tokens split over in
    :func:`cache_specs`' per-slot placement: the model axis where the
    pool's token dimension keeps it (fewer than 16 KV heads, and a page
    the axis divides: ``resolve_spec`` drops it otherwise), else 1."""
    m = model_size(mi)
    if cfg.n_kv_heads >= KV_HEADS_SPLIT or page_size % m:
        return 1
    return m


def _placed_forward(cfg: ModelConfig, params, tokens: torch.Tensor,
                    cache: Cache, mi: MeshInfo, page_size: int, **ctx_kw):
    """The serve steps' forward on a mesh with placed weights and cache:
    ``params`` this rank's blocks, ``tokens`` its rows, ``cache`` its
    blocks of ``cache_specs(..., page_size)``. Each layer's blocks are
    gathered over the batch axes at use (the reference's FSDP, as
    :func:`forward_train`), and run in their tensor-parallel forms over
    ``model`` (``blocks._placed_attention``, the MLP's column and row
    parallel products); the embedding is vocab-parallel where the specs
    split the vocab over ``model`` (``vocab_split``). Returns (x after
    the final norm, the new cache, the embedding leaves as used, the
    vocab mesh or None)."""
    check_mesh_servable(cfg, mi)
    sh = shardings(model_specs(cfg), mi)
    ctx = FwdCtx(cfg=cfg, mi=mi, tp=model_size(mi) > 1, placed=True,
                 page_split=page_split(cfg, page_size, mi), **ctx_kw)
    vocab_mi = mi if vocab_split(sh, ctx) else None
    emb = _use_params(params["embed"], sh["embed"], ctx)
    x = _embed_in(cfg, {"embed": emb}, tokens, vocab_mi)
    entries = by_layer(cfg, cache)
    new = []
    for (kind, p), (_, s_), e in zip(layers(cfg, params), layers(cfg, sh),
                                     entries):
        x, e = apply_layer(kind, _use_params(p, s_, ctx), x, ctx, e)
        new.append(e)
    x = rmsnorm(x, _use_params(params["final_ln"], sh["final_ln"], ctx),
                cfg.norm_eps)
    return x, flat(cfg, new), emb, vocab_mi


def _check_placed(cfg: ModelConfig, cache: Cache, batch: int,
                  page_size: int) -> None:
    """Refuse what placed serving does not take: the global layout, and
    the sequence-parallel layout (batch 1, >= 262144 tokens)."""
    kv = next((e for e in cache if not is_state(e)), None)
    if kv is None:
        return
    if attn.is_global_layout(kv):
        raise NotImplementedError("placed serving takes the per-slot "
                                  "cache, not the global layout")
    if _sp_mode(cfg, batch, kv.block_table.shape[-1] * page_size):
        raise NotImplementedError(
            f"serving {cfg.name} with placed weights: the sequence-parallel "
            f"layout (batch 1, >= {SP_MIN_LEN} tokens) is not ported")


def placed_logits(cfg: ModelConfig, emb, x: torch.Tensor, vocab_mi,
                  mi: MeshInfo) -> torch.Tensor:
    """The head over the whole vocab: with a vocab-parallel embedding each
    rank's block of the logits, all-gathered over ``model``."""
    logits = logits_fn(emb, x, cfg.logit_softcap)
    return logits if vocab_mi is None else all_gather(logits, -1, mi,
                                                      "model")


def forward_prefill(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
                    cache: Optional[Cache], mi: MeshInfo = NO_MESH,
                    placed: bool = False,
                    page_size: int = DEFAULT_PAGE_SIZE):
    """``batch``: tokens (B, S) right-padded; lengths (B,) real lengths;
    optionally prefix_lens (B,) (tokens already resident in the shared pool;
    ``tokens`` then holds only each prompt's suffix) and write_tables (B, P)
    (the scatter tables with shared entries NULLed); ``enc_x`` or ``img_x``
    where the arch has cross-attention. Returns the logits at each row's
    last real token, (B, 1, V), and the cache. Under the
    sequence-parallel layout each rank computes the whole prefill and
    writes the pages it holds.

    With ``placed`` on a mesh (``launch/steps.py::make_prefill_step``,
    the reference's lowered prefill), ``params`` are this rank's blocks,
    ``cache`` its blocks of ``cache_specs(..., page_size)`` (per-slot),
    ``batch`` the global batch, of which it takes its rows
    (``batch_sharding``); the layers run their placed forms
    (:func:`_placed_forward`), and the logits are the rank's rows over
    the whole vocab. Kinds other than the dense ones refuse
    (``mesh_serve_refusal``), as do the global and sequence-parallel
    layouts."""
    if placed and mi.active:
        tokens = batch["tokens"]
        rows = batch_sharding(tokens.shape, mi)
        _check_placed(cfg, cache, tokens.shape[0], page_size)
        if "prefix_lens" in batch:
            raise NotImplementedError("placed serving does not prefill a "
                                      "suffix over a shared prefix")
        lengths = batch.get("lengths")
        lengths = rows.cut(lengths) if lengths is not None else None
        tokens = rows.cut(tokens)
        x, cache, emb, vocab_mi = _placed_forward(
            cfg, params, tokens, cache, mi, page_size, mode="prefill",
            seq_lengths=lengths)
        x = _last_rows(x, lengths)
        cache = set_cache_length(cache, tokens.shape[1] if lengths is None
                                 else lengths)
        return placed_logits(cfg, emb, x, vocab_mi, mi), cache
    tokens = batch["tokens"]
    lengths = batch.get("lengths")
    prefix_lens = batch.get("prefix_lens")
    cross_x = _cross_source(cfg, params, batch)
    ctx = FwdCtx(cfg=cfg, mode="prefill", seq_lengths=lengths,
                 kv_prefix_lens=prefix_lens,
                 write_tables=batch.get("write_tables"), cross_x=cross_x,
                 mi=mi, sp=cache is not None and _decode_is_sp(cfg, cache))
    x = _embed_in(cfg, params, tokens)
    x, new = _run_blocks(cfg, params, x, ctx, cache)
    if cache is not None and cfg.is_encdec:
        new.append(EncOut(cross_x))
    cache = new
    x = rmsnorm(_last_rows(x, lengths), params["final_ln"], cfg.norm_eps)
    logits = logits_fn(params["embed"], x, cfg.logit_softcap)
    if cache is not None:
        total = tokens.shape[1] if lengths is None else lengths
        if prefix_lens is not None:
            total = total + prefix_lens        # cache holds prefix + suffix
        cache = set_cache_length(cache, total)
    return logits, cache


def _last_rows(x: torch.Tensor, lengths) -> torch.Tensor:
    """Each row's last real position of x (B, S, d): the last one, or
    ``lengths - 1`` of a right-padded batch -> (B, 1, d)."""
    if lengths is None:
        return x[:, -1:]
    idx = torch.clamp(lengths.long() - 1, min=0)[:, None, None]
    return torch.gather(x, 1, idx.expand(-1, 1, x.shape[-1]))


def placed_decode(cfg: ModelConfig, params, token: torch.Tensor, pos,
                  cache: Cache, mi: MeshInfo,
                  page_size: int = DEFAULT_PAGE_SIZE):
    """:func:`forward_decode` with ``placed``, before the vocab gather:
    (the rank's rows' logits, or its vocab block of them where the
    embedding is vocab-parallel; that vocab mesh or None; the cache)."""
    rows = batch_sharding(token.shape, mi)
    _check_placed(cfg, cache, token.shape[0], page_size)
    pos = torch.as_tensor(pos)
    if pos.dim():
        pos = rows.cut(pos)
    x, cache, emb, vocab_mi = _placed_forward(
        cfg, params, rows.cut(token), cache, mi, page_size, mode="decode",
        q_offset=pos)
    return logits_fn(emb, x, cfg.logit_softcap), vocab_mi, cache


def forward_decode(cfg: ModelConfig, params, token: torch.Tensor, pos,
                   cache: Cache, mi: MeshInfo = NO_MESH,
                   sp: Optional[bool] = None, placed: bool = False,
                   page_size: int = DEFAULT_PAGE_SIZE):
    """token: (B, 1) int; pos: (B,) or scalar current cache length. ``sp``
    (None: from the cache's layout) decodes sequence-parallel over
    ``mi``'s ``data`` axis. With ``placed`` on a mesh
    (``launch/steps.py::make_decode_step``), as :func:`forward_prefill`'s:
    ``token`` (and ``pos`` where it has one a row) the global batch's,
    the rank's blocks of the weights and the cache, its rows' logits over
    the whole vocab."""
    if placed and mi.active:
        logits, vocab_mi, cache = placed_decode(cfg, params, token, pos,
                                                cache, mi, page_size)
        return (logits if vocab_mi is None else
                all_gather(logits, -1, mi, "model")), cache
    if sp is None:
        sp = _decode_is_sp(cfg, cache)
    ctx = FwdCtx(cfg=cfg, mode="decode", q_offset=pos, mi=mi, sp=sp)
    x = _embed_in(cfg, params, token)
    x, new = _run_blocks(cfg, params, x, ctx, cache)
    if cfg.is_encdec:
        new.append(cache[-1])          # the encoder output, unchanged
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    return logits_fn(params["embed"], x, cfg.logit_softcap), new


def _save_2d_products(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the outputs of products of 2-D matrices
    (``aten.mm``: every projection, whatever the leading dims of its
    input), recompute the rest; the counterpart of JAX's
    ``dots_with_no_batch_dims_saveable``, which keeps the dots without
    batch dimensions (the batched MoE and attention products recompute)."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _use_params(p, sh, ctx: FwdCtx, gather=None):
    """On a mesh, the parameter blocks ``p`` (placed by the Shardings
    ``sh``) as the layers use them: gathered over every axis of
    ``gather`` (by default every axis but ``model``, whose blocks the
    tensor-parallel layers use as they are), their gradients summed over
    the axes whose ranks hold other rows (``ctx.grad_axes``). Without a
    mesh, ``p``."""
    if not ctx.mi.active:
        return p
    if gather is None:
        gather = [a for a in ctx.mi.axis_names if a != "model"]
    return tree_map(lambda t, s_: gather_param(t, s_, ctx.mi, gather,
                                               ctx.grad_axes), p, sh)


def _apply_block(x, p_blk, ctx: FwdCtx, sh_blk=None):
    """One block; on a mesh its parameter blocks are gathered here, inside
    the rematerialised function, so the recompute gathers them again and
    no gathered weight outlives the block."""
    p_blk = _use_params(p_blk, sh_blk, ctx)
    for i, kind in enumerate(ctx.cfg.block_pattern):
        x, _ = apply_layer(kind, p_blk[str(i)], x, ctx, None)
    return x


def _maybe_remat(fn, cfg: ModelConfig):
    """A block's forward as ``cfg.remat`` asks (the reference's
    ``_maybe_remat`` of its scan body): "none" keeps every activation,
    "full" keeps only the block's input and recomputes the block on
    backward (non-reentrant ``checkpoint``), "dots" recomputes all but the
    2-D matrix products' outputs."""
    if cfg.remat == "none":
        return fn
    kw = dict(use_reentrant=False)
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_2d_products)
    elif cfg.remat != "full":
        raise ValueError(f"remat {cfg.remat!r} is not one of none, dots, "
                         f"full")
    return functools.partial(checkpoint, fn, **kw)


DENSE_KINDS = ("attn_mlp", "attn_mlp_local")


def mesh_train_refusal(cfg: ModelConfig, model: int) -> Optional[str]:
    """Why training ``cfg`` on a mesh whose model axis is ``model`` is not
    ported, or None. Every layer kind the port serves has its
    tensor-parallel form; a width that does not split over the model axis
    refuses, where a layer would run whole on every rank and its sum over
    ``model`` count it ``model`` times: the heads (self- and
    cross-attention, an encoder's too, and rwkv's time mix); ``d_ff``
    where a dense MLP exists (a dense, an ``attn``, a ``mamba``, an
    ``xattn_mlp`` or a ``cross_mlp`` layer, an encoder's layers,
    ``first_k_dense``) or rwkv's channel mix; mamba's ``d_in = ssm.expand
    * d_model``; an MoE layer's experts, and its shared expert's width
    ``moe.d_ff * n_shared_experts``. KV heads too few to split are whole
    on every rank (``blocks._tp_kv_heads``)."""
    kinds = set(cfg.layer_kinds())
    if cfg.is_encdec:
        kinds |= set(cfg.enc_block_pattern)
    need = {}
    if kinds - set(MAMBA_KINDS):
        need["heads"] = cfg.n_heads
    if kinds & set(DENSE_KINDS + ("attn", "mamba", "rwkv", "xattn_mlp",
                                  "cross_mlp")):
        need["d_ff"] = cfg.d_ff
    if kinds & set(MAMBA_KINDS):
        need["d_in"] = cfg.ssm.expand * cfg.d_model
    if kinds & {"attn_moe", "mamba_moe"}:
        m = cfg.moe
        need["experts"] = m.n_experts
        if m.n_shared_experts:
            need["the shared expert's width"] = m.d_ff * m.n_shared_experts
    bad = {k: v for k, v in need.items() if v % model}
    if bad:
        return (f"training {cfg.name} on a mesh: "
                + ", ".join(f"{k} {v}" for k, v in bad.items())
                + f" must split over a model axis of {model}")
    return None


def check_mesh_trainable(cfg: ModelConfig, mi: MeshInfo) -> None:
    """Raise ``NotImplementedError`` where training ``cfg`` on ``mi``'s
    mesh is not ported (:func:`mesh_train_refusal`)."""
    why = mesh_train_refusal(cfg, model_size(mi)) if mi.active else None
    if why:
        raise NotImplementedError(why)


def model_size(mi: MeshInfo) -> int:
    """The model axis's size (1 without a mesh or without the axis)."""
    return mi.size("model") if "model" in mi.axis_names else 1


def batch_sharding(shape, mi: MeshInfo) -> Sharding:
    """The Sharding of a batch leaf of ``shape`` (rows first) by the
    reference's ``("batch", None)`` input spec: rows over the batch axes
    where they divide them, else whole."""
    return sharding_of(("batch",), shape[:1], mi)


def vocab_split(sh, ctx: FwdCtx) -> bool:
    """Whether the embedding leaves, placed by the Shardings ``sh``, split
    the vocab over a model axis larger than 1 (``resolve_spec`` keeps
    ``model`` on the vocab dimension only where it divides it; the table
    and an untied head share it)."""
    return ctx.tp and "model" in sh["embed"]["table"].axes(0)


def forward_train(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
                  mi: MeshInfo = NO_MESH) -> torch.Tensor:
    """The mean next-token loss. ``batch``: tokens (B, S) and labels (B, S),
    and ``enc_x`` or ``img_x`` where the arch has cross-attention. The
    reference's train mode is a prefill without a cache (recurrent states
    start at zero), so every layer runs in mode "prefill"; each block is
    rematerialised as ``cfg.remat`` says, the first dense layers and the
    encoder are not (as in the reference).

    On a mesh ``params`` are this rank's blocks and ``batch`` the global
    batch, of which the rank takes its rows (``batch_sharding``; ``enc_x``
    and ``img_x`` with the tokens' rows). Each block's parameters, and
    each first dense layer's, are gathered over ``data`` at use
    (``_apply_block``, ``_use_params``); so are the encoder's, block by
    block, and its final norm (``_run_encoder`` with the step's context,
    its layers in their tensor-parallel forms). The encoder's output, or
    ``img_x``, enters every cross-attention through ``copy_to``, so its
    gradient sums the model ranks' parts; each cross gate scales the
    layer's output after ``wo``'s sum over ``model``, so its gradient is
    whole on every rank and sums over the data ranks alone
    (``blocks._tp_cross_inputs``, ``blocks._tp_gated_out``).

    The embedding table (and an untied head) is gathered over the batch
    axes at use (``_use_params``), so a rank keeps over ``model`` what the
    reference's specs give it. Where they split the vocab there
    (``vocab_split``), the rank looks its tokens up in its vocab block
    (zero rows for the others) and sums the rows over ``model``
    (``vocab_parallel_embed``: one all-reduce of (B/data, S, d)), and
    computes its block's logits of each chunk, the logsumexp and the
    gold logit summed over ``model`` (``vocab_parallel_xent``: per chunk
    one all-reduce MAX and one SUM of (B/data, S/n) rows, and on backward
    the all-reduce of x's gradient in ``copy_to``); the gradients reach
    the rank's block alone. Where the vocab does not split (seamless's
    256206 rows on a model axis of 4: the reference leaves them whole
    too), the table and head are whole over ``model`` and every rank of a
    data group computes the same embedding and cross-entropy. The rank's
    loss is its rows' share of the global mean, summed over the batch
    axes (``reduce_from``), so every rank returns the global loss and its
    backward gives the rank's blocks of the global gradient."""
    B, S = batch["tokens"].shape
    if mi.active:
        check_mesh_trainable(cfg, mi)
        rows = batch_sharding(batch["tokens"].shape, mi)
        batch = {k: rows.cut(v) for k, v in batch.items()}
        grad_axes = tuple(a for a in split_axes(rows.spec[0])
                          if mi.size(a) > 1)
        sh = shardings(model_specs(cfg), mi)
    else:
        grad_axes, sh = (), None
    ctx = FwdCtx(cfg=cfg, mode="prefill", mi=mi, tp=model_size(mi) > 1,
                 grad_axes=grad_axes)
    ctx = dataclasses.replace(ctx, cross_x=_cross_source(
        cfg, params, batch, ctx, sh and sh.get("encoder")))
    vocab_mi = mi if vocab_split(sh, ctx) else None
    emb = _use_params(params["embed"], sh and sh["embed"], ctx)
    x = _embed_in(cfg, {"embed": emb}, batch["tokens"], vocab_mi)
    for i in range(cfg.first_k_dense):
        p_i = _use_params(params["first"][str(i)],
                          sh and sh["first"][str(i)], ctx)
        x, _ = apply_layer("attn_mlp", p_i, x, ctx, None)
    body = _maybe_remat(_apply_block, cfg)
    for b, p_blk in enumerate(params["blocks"]):
        x = body(x, p_blk, ctx, sh and sh["blocks"][b])
    x = rmsnorm(x, _use_params(params["final_ln"], sh and sh["final_ln"],
                               ctx), cfg.norm_eps)
    if vocab_mi is None:
        loss = chunked_xent(emb, x, batch["labels"], cfg.logit_softcap,
                            count=B * S)
    else:
        loss = vocab_parallel_xent(emb, x, batch["labels"],
                                   cfg.logit_softcap, vocab_mi, count=B * S)
    return reduce_from(loss, mi, grad_axes) if mi.active else loss
