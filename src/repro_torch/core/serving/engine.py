"""Serving engine over the paged SVA layer (port of
``repro/core/serving/engine.py``: both offload modes, the fixed and the
continuous scheduler).

  zero_copy  Zero-copy offload at serving granularity (the paper's
             map-don't-copy result applied to KV admission): ONE global
             physical page pool per KV layer is shared by every batch slot.
             Admission writes block-table rows (ints), and a single batched,
             bucketed prefill scatters KV directly into the shared pool
             through those tables. Decode consumes delta table uploads: only
             rows whose tables changed since the last step are re-sent, with
             a full upload only on epoch invalidation.

  copy       The staging baseline (paper Fig. 2's memcpy mode), over
             per-slot pools: every admission materializes a fresh
             single-sequence cache, prefills into it at the prompt's exact
             length, duplicates it on the device (the staging copy), and
             copies it into its batch slot. Decode re-uploads every table
             each step.

Copy-on-write prefix sharing (zero_copy only): admission maps a prompt's
already-resident prefix pages via refcount++ in the manager's PrefixIndex;
the batched prefill feeds only each prompt's suffix, reading the prefix's KV
back out of the shared pool and scattering through ``write_tables`` whose
shared entries are NULLed. A decode append into a page another sequence still maps
queues a CoW page copy, executed here as one batched pool-to-pool copy.

The host-side layer (``core/sva``: page pool, IOMMU, IOTLB, prefix index,
svasan) is a byte copy of the reference's, so admission, translation and
statistics match it step for step. The pools are updated in place (the JAX
engine donates its cache to each jitted step instead).

Continuous batching (``scheduler="continuous"``, zero_copy only): a dense
SequenceBuffer and a token-budget Scheduler (byte copies of the
reference's) compose each step from chunked prefills, which run the prefix
path (earlier chunks' KV read back from the pool), and a masked decode at
full slot width whose non-decoding rows see all-NULL tables. Preemption
under pool pressure folds a sequence's tokens back into the waiting queue;
the resume re-prefills from warm prefix pages.

Sliding-window layers (gemma2's ``attn_mlp_local``) keep per-slot rings of
``ceil(window / page)`` pages beside the global pool when ``max_len`` passes
the window: a batched prefill writes them into fresh zero rows that are
scattered back to their slots, and decode appends modulo the ring. Such an
arch serves without prefix sharing and without the continuous scheduler,
and in copy mode only while ``max_len`` fits its window, as the reference.

Recurrent layers (rwkv6's ``rwkv``, jamba's ``mamba`` and ``mamba_moe``)
keep one per-slot state row a slot beside the pool. They scan every
position of a row, so right-padding would corrupt their final state: such
an arch prefills at exact lengths, a wave grouped by suffix length, one
call a group, with no bucket (the reference's ``_exact_prefill``). Its
fresh zero state rows are scattered back to their slots as a ring's are.
It serves in zero_copy and in copy mode, without prefix sharing and
without the continuous scheduler, as the reference.

Cross-attention archs (llama-vision's ``xattn_mlp``, seamless's encoder and
``cross_mlp``) keep per-slot cross K/V of ``src_len`` rows (and seamless
its encoder output) beside the pool, scattered back to their slots as a
ring's rows are. Every prefill feeds zero image embeddings or zero encoder
input, ``src_len`` frames of them, as the reference's engine does. They
serve in zero_copy and in copy mode, without prefix sharing and without
the continuous scheduler, as the reference. The image K/V a prefill
writes has ``n_image_tokens`` rows, which the reference's cross cache
(``src_len`` rows) takes only when the two are equal: the port refuses
any other ``src_len`` at construction.

A mesh (``mi``, the reference's ``MeshInfo``) is passed to every forward.
Every rank runs this same engine, with the same host-side manager, IOMMU
and scheduler, on the same requests, so their tokens, statistics and
traces are equal. One slot at ``max_len`` >= 262144 takes the
sequence-parallel layout (pages sharded over ``data``, decode merged
across ranks): it serves in copy mode only, as the reference (zero-copy
raises ``NotImplementedError``), and only on a mesh, which the reference's
decode also needs (it fails at its first decode without one; the port
refuses at construction).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.serving.scheduler import Scheduler, SchedulerOutput
from repro_torch.core.serving.sequence_buffer import SequenceBuffer
from repro_torch.core.sva.iommu import (AutoTuneConfig, PrefetchConfig,
                                        TLBConfig, default_autotune_candidates)
from repro_torch.core.sva.kv_manager import PagedKVManager
from repro_torch.models.blocks import _sp_mode
from repro_torch.models.dist import NO_MESH, MeshInfo
from repro_torch.models.model import (Cache, forward_decode,
                                      forward_prefill, fresh_rows,
                                      init_cache, install, install_tables,
                                      is_state, layer_capacity, per_slot,
                                      scatter_rows)
from repro_torch.models.params import (RECURRENT_KINDS, SERVED_KINDS,
                                       resolve_device, torch_dtype)

# Layer kinds whose KV lives wholly in the shared global pool: prefix
# sharing and chunked prefill (the continuous scheduler) read a sequence's
# earlier KV back from it, which a per-slot ring cannot give.
SHARE_KINDS = {"attn_mlp", "attn_moe", "attn"}


@dataclass
class Request:
    req_id: int
    prompt: List[int]
    max_tokens: int
    tenant: Optional[str] = None   # owning TenantDomain (None = untenanted)
    out_tokens: List[int] = field(default_factory=list)
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None
    # step-counter stamps (steps-to-first-token: the wall-clock-free latency)
    submitted_step: Optional[int] = None
    first_token_step: Optional[int] = None
    # first token produced by a DECODE step (a disaggregated engine's gap to
    # first_token_step also covers the prefill->decode KV transfer: TTFDT)
    first_decode_step: Optional[int] = None


def _write_slot(batch_cache: Cache, single_cache: Cache, slot: int) -> None:
    """Copy one sequence's prefilled per-slot cache (batch 1) into batch slot
    ``slot`` of every entry, in place: every leaf of a PagedKV, a recurrent
    state, a cross K/V or the encoder output. The staging baseline's
    O(cache-size) admission walk."""
    for bkv, skv in zip(batch_cache, single_cache):
        for dst, src in zip(bkv, skv):
            dst[slot].copy_(src[0])


def _build_prefill_view(cache: Cache, tables: torch.Tensor,
                        lengths: torch.Tensor) -> Cache:
    """The batch cache as a batched prefill of ``nb = tables.shape[0]`` rows
    sees it: global-pool layers keep the same pools with the rows' tables
    (KV lands in place: zero-copy); a per-slot ring gets fresh zero rows,
    and a recurrent state, a cross K/V and the encoder output fresh zero
    rows, which :func:`_merge_prefill_view` scatters back to their
    slots."""
    nb = tables.shape[0]
    return [fresh_rows(kv, nb) if per_slot(kv)
            else install(kv, tables, lengths) for kv in cache]


def _merge_prefill_view(cache: Cache, view: Cache,
                        slots: torch.Tensor) -> None:
    """Scatter each per-slot entry's first ``len(slots)`` prefilled rows
    (a ring's, a recurrent state's, a cross K/V's, the encoder output's) to
    ``slots`` in place (the padding rows after them are dropped); the
    global pools were written in place. ``view`` is the cache the prefill
    returned: a recurrent state or a cross K/V is a new tensor."""
    for kv, w in zip(cache, view):
        if per_slot(kv):
            scatter_rows(kv, w, slots)


def _install_tables(cache: Cache, tables: torch.Tensor,
                    lengths: torch.Tensor) -> Cache:
    """The zero-copy decode's install into a serving cache: every attention
    layer takes ``lengths``; each global-pool layer takes ``tables`` (B, P),
    a sliding-window ring keeps its identity table, and every other
    per-slot entry passes through."""
    return [install(kv, None if per_slot(kv) else tables, lengths)
            for kv in cache]


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, n_slots: int, max_len: int,
                 page_size: int = 8, mi: MeshInfo = NO_MESH,
                 offload_mode: str = "zero_copy",
                 src_len: int = 16, eos_token: Optional[int] = None,
                 prefix_sharing: bool = True,
                 record_translation_trace: bool = False,
                 translation_stats: bool = False,
                 scheduler: str = "fixed",
                 pool_pages: Optional[int] = None,
                 tenants: Optional[Dict[str, dict]] = None,
                 device="cuda"):
        if scheduler not in ("fixed", "continuous"):
            raise ValueError(f"scheduler={scheduler!r} "
                             "(expected 'fixed' or 'continuous')")
        if offload_mode not in ("zero_copy", "copy"):
            raise ValueError(f"offload_mode={offload_mode!r} "
                             "(expected 'zero_copy' or 'copy')")
        if scheduler == "continuous" and offload_mode != "zero_copy":
            raise NotImplementedError(
                "continuous scheduling requires offload_mode='zero_copy'")
        if _sp_mode(cfg, n_slots, max_len):
            if offload_mode == "zero_copy":
                raise NotImplementedError(
                    "zero_copy serving does not support the SP cache layout")
            if not mi.active:
                raise ValueError(
                    f"n_slots={n_slots} at max_len={max_len} takes the "
                    "sequence-parallel cache layout, which shards the pages "
                    "over a mesh's 'data' axis: pass mi=MeshInfo(mesh)")
        kinds = cfg.layer_kinds()
        if any(k not in SERVED_KINDS for k in kinds):
            raise NotImplementedError(
                f"{cfg.name}: a layer kind of {sorted(set(kinds))} is not "
                f"ported; the port serves {SERVED_KINDS}")
        all_shared = all(k in SHARE_KINDS for k in kinds)
        if scheduler == "continuous" and not all_shared:
            raise NotImplementedError(
                "continuous scheduling needs all KV state in the shared "
                "global pool (full-attention archs only): chunked "
                "prefill cannot reconstruct per-slot ring buffers, "
                "recurrent states, or cross-KV")
        if cfg.n_image_tokens and src_len != cfg.n_image_tokens:
            # The reference sizes the cross cache by src_len and writes the
            # prefill's image K/V (n_image_tokens rows) into it: its
            # prefill fails on any other src_len.
            raise ValueError(
                f"{cfg.name}: src_len={src_len} != n_image_tokens="
                f"{cfg.n_image_tokens}; the image cross-KV a prefill writes "
                f"has {cfg.n_image_tokens} rows a slot, so src_len must "
                "equal it")
        if offload_mode == "copy" and any(
                -(-layer_capacity(cfg, k, max_len) // page_size)
                < -(-max_len // page_size) for k in kinds):
            # Per-slot window rings have fewer pages than a manager table
            # row, so no row could be mapped onto them.
            raise NotImplementedError(
                "copy-mode serving cannot map block-table rows onto "
                "sliding-window leaves (fewer pages than the slot table); "
                "serve this config with offload_mode='zero_copy'")
        self.device = resolve_device(device)
        self.cfg, self.params, self.mi = cfg, params, mi
        # every forward takes the mesh; without one, the forwards' default
        self._on_mesh = {"mi": mi} if mi.active else {}
        self.n_slots, self.max_len, self.page_size = n_slots, max_len, page_size
        self.offload_mode = offload_mode
        self.src_len = src_len
        self.eos = eos_token
        self.max_pages = -(-max_len // page_size)
        kv_bytes = (2 * cfg.n_kv_heads * cfg.d_head
                    * sum(1 for k in kinds if "attn" in k or k == "cross_mlp")
                    * torch_dtype(cfg.activation_dtype).itemsize)
        self._can_share = (offload_mode == "zero_copy" and prefix_sharing
                           and all_shared)
        # Adaptive translation front-end (both default-off): IOTLB
        # prefetching and online geometry auto-tuning.
        prefetch = PrefetchConfig(cfg.serve_tlb_prefetch_policy,
                                  degree=cfg.serve_tlb_prefetch_degree,
                                  distance=cfg.serve_tlb_prefetch_distance)
        autotune = None
        if cfg.serve_tlb_autotune:
            base_tlb = TLBConfig(cfg.serve_tlb_entries, cfg.serve_tlb_policy,
                                 ways=cfg.serve_tlb_ways,
                                 ranges=cfg.serve_tlb_ranges)
            cands = tuple(TLBConfig(e, p, ways=w,
                                    ranges=cfg.serve_tlb_ranges)
                          for e, w, p
                          in cfg.serve_tlb_autotune_candidates) \
                or default_autotune_candidates(base_tlb)
            autotune = AutoTuneConfig(interval_steps=cfg.serve_tlb_autotune,
                                      candidates=cands)
        self.mgr = PagedKVManager(n_slots, self.max_pages, page_size,
                                  kv_bytes_per_token=kv_bytes,
                                  offload_mode=offload_mode,
                                  prefix_sharing=self._can_share,
                                  prefix_policy=cfg.prefix_cache_policy,
                                  prefix_cap_pages=cfg.prefix_cache_pages,
                                  tlb_entries=cfg.serve_tlb_entries,
                                  tlb_policy=cfg.serve_tlb_policy,
                                  tlb_ways=cfg.serve_tlb_ways,
                                  tlb_ranges=cfg.serve_tlb_ranges,
                                  sanitize=True if cfg.svasan else None,
                                  tlb_prefetch=prefetch,
                                  autotune=autotune,
                                  prefix_autotune=cfg.prefix_cache_autotune,
                                  pool_pages=pool_pages,
                                  tenants=tenants)
        # Translation trace: ("map", fresh_pages, slot, row) at admission,
        # ("step", accesses, tokens_read) per decode step, ("unmap", slot,
        # n_pages) at release — replayable through any IOMMU walk model.
        self.translation_trace: Optional[List[tuple]] = \
            [] if record_translation_trace else None
        self._translation_stats = (translation_stats
                                   or record_translation_trace
                                   or autotune is not None
                                   or prefetch.enabled)
        self.queue: deque = deque()
        self.active: Dict[int, Request] = {}
        # Continuous mode: requests submitted or preempted but not holding a
        # slot (their tokens live in the scheduler's waiting queue).
        self._waiting_reqs: Dict[int, Request] = {}
        self._next_id = 0
        self._step_count = 0
        # Recurrent layers scan left to right: right-padding would corrupt
        # their final states, so those archs prefill at exact lengths
        # (batching only same-length prompts).
        self._exact_prefill = any(k in RECURRENT_KINDS for k in kinds)
        self.metrics = {"prefills": 0, "prefill_reqs": 0, "decode_steps": 0,
                        "tokens": 0, "staging_copies": 0, "prefill_s": 0.0,
                        "decode_s": 0.0, "admit_s": 0.0,
                        "table_uploads_full": 0, "table_uploads_delta": 0,
                        "table_rows_uploaded": 0, "table_upload_bytes": 0,
                        "admit_table_bytes": 0,
                        "prefill_tokens_saved": 0, "shared_admissions": 0,
                        "cow_page_copies": 0}
        if offload_mode == "zero_copy":
            self.null_page = n_slots * self.max_pages
            self.cache = init_cache(cfg, n_slots, max_len, page_size,
                                    global_pages=self.null_page,
                                    device=self.device, src_len=src_len,
                                    mi=mi)
            self._tables_dev = torch.full((n_slots, self.max_pages),
                                          self.null_page, dtype=torch.int32,
                                          device=self.device)
            self._epoch_seen = -1
        else:
            self.cache = init_cache(cfg, n_slots, max_len, page_size,
                                    device=self.device, src_len=src_len,
                                    mi=mi)
        # Continuous batching: dense SequenceBuffer state and a token-budget
        # scheduler composing mixed decode / chunked-prefill steps, with
        # preemption under pool pressure.
        self.buffer: Optional[SequenceBuffer] = None
        self.sched: Optional[Scheduler] = None
        if scheduler == "continuous":
            self.buffer = SequenceBuffer(n_slots, self.max_pages * page_size)
            self.sched = Scheduler(self.mgr, self.buffer,
                                   cfg.sched_token_budget,
                                   cfg.sched_prefill_chunk,
                                   share_tokens=self._can_share,
                                   on_event=self._trace_event)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _cross_inputs(self, nb: int) -> Dict[str, torch.Tensor]:
        """A prefill's zero encoder input (``src_len`` frames) or zero image
        embeddings (``n_image_tokens``) for ``nb`` rows, as the reference's
        engine feeds them; nothing for a decoder alone."""
        cfg = self.cfg
        dt = torch_dtype(cfg.activation_dtype)
        if cfg.is_encdec:
            return {"enc_x": torch.zeros((nb, self.src_len, cfg.d_model),
                                         dtype=dt, device=self.device)}
        if cfg.n_image_tokens:
            return {"img_x": torch.zeros((nb, cfg.n_image_tokens,
                                          cfg.d_model), dtype=dt,
                                         device=self.device)}
        return {}

    # --------------------------------------------------------------- API
    def submit(self, prompt: List[int], max_tokens: int = 16,
               tenant: Optional[str] = None) -> int:
        self.mgr._check_tenant_name(tenant)
        self.mgr.ensure_fits(len(prompt), max_tokens, tenant=tenant)
        if self.sched is not None and not prompt:
            raise ValueError("continuous scheduling needs a non-empty prompt")
        rid = self._next_id
        self._next_id += 1
        self.queue.append(Request(rid, list(prompt), max_tokens,
                                  tenant=tenant,
                                  submitted_at=time.perf_counter(),
                                  submitted_step=self._step_count))
        return rid

    @property
    def has_work(self) -> bool:
        return bool(self.queue or self.active
                    or (self.sched is not None and self.sched.has_work))

    def step(self, finished: Dict[int, Request]) -> None:
        """Run ONE engine step (admission + compute + completion harvest)
        under the configured scheduler."""
        if self.sched is not None:
            self._continuous_step()
        else:
            self._admit()
            self._decode_step()
        self._step_count += 1
        self._release_done(finished)

    def run(self, max_steps: int = 10_000) -> Dict[int, Request]:
        finished: Dict[int, Request] = {}
        steps = 0
        while self.has_work and steps < max_steps:
            self.step(finished)
            steps += 1
        return finished

    def _release_done(self, finished: Dict[int, Request]) -> None:
        for rid in [r for r in self.active if self.mgr.seqs[r].done]:
            req = self.active.pop(rid)
            req.done_at = time.perf_counter()
            st = self.mgr.seqs[rid]
            if self.sched is not None:
                # Generations preempted along the way were folded into
                # out_tokens at preemption time; append the rest.
                req.out_tokens.extend(st.tokens)
                self.sched.finish(rid)
            else:
                req.out_tokens = st.tokens
            if self.translation_trace is not None:
                self.translation_trace.append(
                    ("unmap", st.slot, len(st.pages)))
            self.mgr.release(rid)
            finished[rid] = req

    def _trace_event(self, ev: tuple) -> None:
        """Scheduler lifecycle events (map/unmap/preempt/resume) join the
        translation trace in order, keeping it replayable."""
        if self.translation_trace is not None:
            self.translation_trace.append(ev)

    def invalidate_epoch(self) -> None:
        """Flush every device translation; the next decode step performs a
        full-table upload."""
        self.mgr.invalidate_epoch()

    # --------------------------------------------------------------- admission
    def _admit(self):
        if self.offload_mode == "zero_copy":
            self._apply_cow()   # queued page copies must land before any
                                # new prefill can recycle their source pages
        admitted: List = []
        while self.queue:
            req = self.queue[0]
            t0 = time.perf_counter()
            st = self.mgr.admit(req.req_id, len(req.prompt), req.max_tokens,
                                tokens=req.prompt if self._can_share else None,
                                tenant=req.tenant)
            self.metrics["admit_s"] += time.perf_counter() - t0
            if st is None:
                break                      # no slot/pages: wait
            self.queue.popleft()
            if self.offload_mode == "copy":
                self._prefill_into_slot(req, st.slot)
                self.active[req.req_id] = req
                continue
            if self.translation_trace is not None:
                self.translation_trace.append(
                    ("map", list(st.pages[st.shared_pages:]),
                     st.slot, list(st.pages)))
            admitted.append((req, st))
        if not admitted:
            return
        # Prefill in dependency WAVES: a request whose shared prefix pages
        # were freshly allocated by another request admitted this round
        # prefills after its provider.
        page_wave: Dict[int, int] = {}
        waves: Dict[int, list] = {}
        for req, st in admitted:
            w = 0
            for pg in st.pages[:st.shared_pages]:
                if pg in page_wave:
                    w = max(w, page_wave[pg] + 1)
            for pg in st.pages[st.shared_pages:]:
                page_wave[pg] = w
            waves.setdefault(w, []).append((req, st))
        for w in sorted(waves):
            if not self._exact_prefill:
                self._batched_prefill(waves[w])
                continue
            groups: Dict[int, list] = {}
            for item in waves[w]:
                suf = len(item[0].prompt) - item[1].prefill_start
                groups.setdefault(suf, []).append(item)
            for group in groups.values():
                self._batched_prefill(group)
        for req, st in admitted:
            self.active[req.req_id] = req

    def _bucket_len(self, longest: int) -> int:
        """Power-of-two token bucket, capped at slot capacity (the same
        padding as the reference, so padding rows match it)."""
        lb = self.page_size
        while lb < longest:
            lb *= 2
        return min(lb, self.max_pages * self.page_size)

    def _batched_prefill(self, group):
        """ONE padded prefill call for a wave of admitted requests (a group
        of one suffix length where the arch prefills at exact lengths, with
        no bucket): KV is scattered straight into the shared pool through
        their tables. Prefix-shared admissions feed only their suffix."""
        t0 = time.perf_counter()
        sufs = [len(req.prompt) - st.prefill_start for req, st in group]
        sharing = any(st.shared_pages for _, st in group)
        lb = max(sufs) if self._exact_prefill else \
            self._bucket_len(max(sufs))
        nb = 1
        while nb < len(group):
            nb *= 2
        nb = max(min(nb, self.n_slots), len(group))
        tokens = np.zeros((nb, lb), np.int32)
        lengths = np.zeros((nb,), np.int32)
        prefix = np.zeros((nb,), np.int32)
        tables = np.full((nb, self.max_pages), self.mgr.null_page, np.int32)
        wtables = np.full((nb, self.max_pages), self.mgr.null_page, np.int32)
        for i, (req, st) in enumerate(group):
            tokens[i, :sufs[i]] = req.prompt[st.prefill_start:]
            lengths[i] = sufs[i]
            prefix[i] = st.prefill_start
            tables[i] = self.mgr.tables[st.slot]
            wtables[i] = tables[i]
            wtables[i, :st.shared_pages] = self.mgr.null_page
        self.metrics["admit_table_bytes"] += len(group) * self.max_pages * 4
        batch = {"tokens": self._dev(tokens).long(),
                 "lengths": self._dev(lengths), **self._cross_inputs(nb)}
        if sharing:
            batch["prefix_lens"] = self._dev(prefix)
            batch["write_tables"] = self._dev(wtables)
        view = _build_prefill_view(self.cache, self._dev(tables),
                                   batch["lengths"])
        with torch.no_grad():
            logits, view = forward_prefill(self.cfg, self.params, batch, view,
                                           **self._on_mesh)
        _merge_prefill_view(self.cache, view, self._dev(np.asarray(
            [st.slot for _, st in group], np.int64)))
        logits = logits[:, -1].float().cpu().numpy()
        now = time.perf_counter()
        for i, (req, st) in enumerate(group):
            first = int(np.argmax(logits[i]))
            self.mgr.append_token(req.req_id, first)
            req.first_token_at = now
            req.first_token_step = self._step_count
        self.metrics["prefills"] += 1
        self.metrics["prefill_reqs"] += len(group)
        self.metrics["prefill_s"] += time.perf_counter() - t0

    def _prefill_into_slot(self, req: Request, slot: int):
        """Copy-mode baseline: materialize a fresh single-sequence cache,
        prefill it at the prompt's exact length, duplicate it on the device
        (the staging copy), then copy it into batch slot ``slot``."""
        t0 = time.perf_counter()
        single = init_cache(self.cfg, 1, self.max_len, self.page_size,
                            device=self.device, src_len=self.src_len,
                            mi=self.mi)
        single = self._map_tables(single, self.mgr.tables[slot:slot + 1],
                                  np.zeros(1, np.int32))
        batch = {"tokens": self._dev(np.asarray(req.prompt, np.int64)[None]),
                 **self._cross_inputs(1)}
        with torch.no_grad():
            logits, single = forward_prefill(self.cfg, self.params, batch,
                                             single, **self._on_mesh)
        # The staging copy: a real device duplicate of every leaf.
        single = [type(kv)(*(t.clone() for t in kv)) for kv in single]
        self.metrics["staging_copies"] += 1
        _write_slot(self.cache, single, slot)
        first = int(np.argmax(logits[0, -1].float().cpu().numpy()))
        self.mgr.append_token(req.req_id, first)
        req.first_token_at = time.perf_counter()
        req.first_token_step = self._step_count
        self.metrics["prefills"] += 1
        self.metrics["prefill_reqs"] += 1
        self.metrics["prefill_s"] += time.perf_counter() - t0

    def _map_tables(self, cache: Cache, tables: np.ndarray,
                    lengths: np.ndarray) -> Cache:
        """Install per-slot block tables and lengths into a PER-SLOT cache
        (the copy-baseline path). Rejects, instead of wrapping, table entries
        past a layer's pool: wrapping page indices would alias distinct
        logical pages onto one physical page and corrupt KV. Every other
        per-slot entry passes through (an arch of recurrent states alone has
        no table)."""
        kvs = [kv for kv in cache if not is_state(kv)]
        if not kvs:
            return cache
        n_pages = kvs[0].block_table.shape[-1]      # every layer alike
        sub = tables[..., :n_pages]
        if sub.size and int(sub.max()) >= n_pages:
            raise ValueError(
                f"block-table entry {int(sub.max())} out of range for a "
                f"{n_pages}-page pool; refusing to wrap page indices")
        return install_tables(cache, self._dev(sub.astype(np.int32)),
                              self._dev(lengths.astype(np.int32)))

    # --------------------------------------------------------------- CoW
    def _cow_copy_pages(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """One batched physical page duplication in every global-pool
        layer's pools: ``pool[dst] = pool[src]``. Padding pairs carry dst ==
        NULL and are dropped; every source page is read before any
        destination is written."""
        rows = torch.nonzero(dst < self.null_page, as_tuple=True)[0]
        src, dst = src[rows].long(), dst[rows].long()
        for kv in self.cache:
            if per_slot(kv):
                continue
            for pool in (kv.k_pool, kv.v_pool):
                pages = pool[src]                # gathered copy, then write
                pool[dst] = pages

    def _apply_cow(self):
        """Execute queued copy-on-write page duplications (src -> dst)
        before the next device op reads a duplicated page or a new
        admission recycles a released source page."""
        pairs = self.mgr.drain_cow_copies()
        if not pairs:
            return
        if self.translation_trace is not None:
            self.translation_trace.append(("map", [d for _, d in pairs]))
        n = 1
        while n < len(pairs):
            n *= 2
        src = np.zeros((n,), np.int32)
        dst = np.full((n,), self.mgr.null_page, np.int32)  # pad: dropped
        for i, (s, d) in enumerate(pairs):
            src[i], dst[i] = s, d
        with torch.no_grad():
            self._cow_copy_pages(self._dev(src), self._dev(dst))
        self.metrics["cow_page_copies"] += len(pairs)

    # --------------------------------------------------------------- decode
    def _upload_tables(self):
        """Delta table upload: send only rows that changed since last step;
        a full-table upload happens only after an epoch invalidation."""
        if self.mgr.epoch != self._epoch_seen:
            self.mgr.delta_rows()                # superseded by the full upload
            self._tables_dev = self._dev(self.mgr.tables)
            self._epoch_seen = self.mgr.epoch
            self.metrics["table_uploads_full"] += 1
            self.metrics["table_rows_uploaded"] += self.n_slots
            self.metrics["table_upload_bytes"] += int(self.mgr.tables.nbytes)
            return
        rows = self.mgr.delta_rows()
        if rows:
            idx = np.asarray(rows)
            sub = self.mgr.tables[idx]
            self._tables_dev[self._dev(idx).long()] = self._dev(sub)
            self.metrics["table_uploads_delta"] += 1
            self.metrics["table_rows_uploaded"] += len(rows)
            self.metrics["table_upload_bytes"] += int(sub.nbytes)

    def _decode_step(self):
        if not self.active:
            return
        t0 = time.perf_counter()
        lengths = self.mgr.device_lengths()
        # KV length = tokens whose KV is in cache; exactly one token is
        # pending per active sequence (the one this step feeds in).
        kv_len = np.maximum(lengths - 1, 0).astype(np.int32)
        last = np.zeros((self.n_slots, 1), np.int64)
        for rid, req in self.active.items():
            st = self.mgr.seqs[rid]
            last[st.slot, 0] = st.tokens[-1] if st.tokens else \
                (req.prompt[-1] if req.prompt else 0)
        pos = self._dev(kv_len)
        if self.offload_mode == "zero_copy":
            self._apply_cow()   # duplicated pages must exist before the
                                # decode writes/reads through new tables
            self._upload_tables()
            if self._translation_stats:
                accesses = self.mgr.translate_step()
                if self.translation_trace is not None:
                    self.translation_trace.append(
                        ("step", accesses, int(kv_len.sum())))
            cache = _install_tables(self.cache, self._tables_dev, pos)
        else:
            # copy baseline: full table re-upload + re-map every step
            tables = self.mgr.device_tables()
            cache = self._map_tables(self.cache, tables, kv_len)
            self.metrics["table_uploads_full"] += 1
            self.metrics["table_rows_uploaded"] += self.n_slots
            self.metrics["table_upload_bytes"] += int(tables.nbytes)
        with torch.no_grad():
            logits, self.cache = forward_decode(self.cfg, self.params,
                                                self._dev(last), pos, cache,
                                                **self._on_mesh)
        nxt = np.argmax(logits[:, 0].float().cpu().numpy(), axis=-1)
        for rid in list(self.active):
            st = self.mgr.seqs[rid]
            tok = int(nxt[st.slot])
            self.mgr.append_token(rid, tok)
            self.metrics["tokens"] += 1
            if self.eos is not None and tok == self.eos:
                st.done = True
        self.metrics["decode_steps"] += 1
        self.mgr.observe_step()
        self.metrics["decode_s"] += time.perf_counter() - t0

    # ------------------------------------------------- continuous batching
    def _continuous_step(self):
        # Queued CoW copies must land BEFORE the scheduler can preempt: a
        # preemption frees its sequence's pages, and a same-step resume or
        # chunk prefill could recycle a pending copy's source page.
        self._apply_cow()
        while self.queue:
            req = self.queue.popleft()
            self.sched.submit(req.req_id, req.prompt, req.max_tokens,
                              tenant=req.tenant)
            self._waiting_reqs[req.req_id] = req
        t0 = time.perf_counter()
        out = self.sched.schedule()
        self.metrics["admit_s"] += time.perf_counter() - t0
        for sid, folded in out.preempted:
            req = self.active.pop(sid)
            req.out_tokens.extend(folded)
            self._waiting_reqs[sid] = req
        for sid in out.admitted + out.resumed:
            self.active[sid] = self._waiting_reqs.pop(sid)
        if out.chunks:
            self._chunk_prefill(out.chunks)
        self._decode_continuous(out)

    def _chunk_prefill(self, chunks):
        """One padded prefill call for this step's chunk spans, through the
        prefix path: ``prefix_lens`` positions earlier chunks' (and shared
        prefixes') KV as context, and ``write_tables`` NULLs every page
        before the chunk's own span (the scatter zero-scrubs every non-NULL
        entry, so an earlier chunk's page left mapped would lose its KV).
        The final chunk's logits give the first token, or a preempted
        sequence's pending token is re-injected."""
        t0 = time.perf_counter()
        sufs = [c.end - c.start for c in chunks]
        lb = self._bucket_len(max(sufs))
        nb = 1
        while nb < len(chunks):
            nb *= 2
        nb = max(min(nb, self.n_slots), len(chunks))
        tokens = np.zeros((nb, lb), np.int64)
        lengths = np.zeros((nb,), np.int32)
        prefix = np.zeros((nb,), np.int32)
        tables = np.full((nb, self.max_pages), self.mgr.null_page, np.int32)
        wtables = np.full((nb, self.max_pages), self.mgr.null_page, np.int32)
        for i, c in enumerate(chunks):
            st = self.mgr.seqs[c.seq_id]
            tokens[i, :sufs[i]] = self.buffer.chunk_tokens(c.slot, c.start,
                                                           c.end)
            lengths[i] = sufs[i]
            prefix[i] = c.start
            tables[i] = self.mgr.tables[c.slot]
            wtables[i] = tables[i]
            keep_from = max(st.shared_pages, c.start // self.page_size)
            wtables[i, :keep_from] = self.mgr.null_page
        self.metrics["admit_table_bytes"] += len(chunks) * self.max_pages * 4
        batch = {"tokens": self._dev(tokens),
                 "lengths": self._dev(lengths),
                 "prefix_lens": self._dev(prefix),
                 "write_tables": self._dev(wtables)}
        view = install_tables(self.cache, self._dev(tables), batch["lengths"])
        with torch.no_grad():
            logits, _ = forward_prefill(self.cfg, self.params, batch, view,
                                        **self._on_mesh)
        finals = [(i, c) for i, c in enumerate(chunks) if c.is_final]
        if finals:      # argmax on the device: (nb,) tokens to the host
            first_tok = logits[:, -1].argmax(dim=-1).cpu().numpy()
        now = time.perf_counter()
        for c in chunks:
            self.buffer.advance(c.slot, c.end)
            # Progressive prefix registration: the chunk's KV is resident
            # now, so its pages may join the index.
            self.mgr.register_progress(c.seq_id,
                                       self.buffer.token_ids[c.slot], c.end)
        for i, c in finals:
            first = c.pending if c.pending is not None else int(first_tok[i])
            self.mgr.append_token(c.seq_id, first)
            self.buffer.append(c.slot, first)
            req = self.active[c.seq_id]
            if req.first_token_at is None:
                req.first_token_at = now
                req.first_token_step = self._step_count
        self.metrics["prefills"] += 1
        self.metrics["prefill_reqs"] += len(finals)
        self.metrics["prefill_s"] += time.perf_counter() - t0

    def _decode_masked(self, tokens, kv_len, mask):
        """Decode with non-decoding slots masked out: their table rows
        become all-NULL (KV writes dropped, gathers read zero) and their
        kv_len arrives pre-masked to 0, so a mid-prefill slot's pages are
        never touched. Masked rows compute logits that nothing consumes;
        every step runs at full slot width."""
        tables = torch.where(mask[:, None], self._tables_dev, self.null_page)
        cache = install_tables(self.cache, tables, kv_len)
        with torch.no_grad():
            logits, self.cache = forward_decode(self.cfg, self.params,
                                                tokens, kv_len, cache,
                                                **self._on_mesh)
        return logits

    def _resident_tokens(self) -> Dict[int, int]:
        """Per-sequence resident-token counts for this step's translation
        accounting: a decoding sequence gathers everything it has, a
        mid-prefill one only its computed chunks (a disaggregated engine
        adds its decode worker's sequences)."""
        resident = {}
        for sid in self.sched.running:
            slot = self.buffer.slot_of(sid)
            resident[sid] = (self.mgr.seqs[sid].length
                             if self.buffer.is_decoding(slot)
                             else int(self.buffer.n_computed[slot]))
        return resident

    def _decode_continuous(self, out: SchedulerOutput):
        t0 = time.perf_counter()
        self._apply_cow()       # final-chunk first tokens may queue CoW
        self._upload_tables()
        if self._translation_stats:
            resident = self._resident_tokens()
            if resident:
                accesses = self.mgr.translate_step(resident=resident)
                if self.translation_trace is not None:
                    self.translation_trace.append(
                        ("step", accesses, int(sum(resident.values()))))
        if not out.decode_slots:
            return
        lengths = self.mgr.device_lengths()
        mask = np.zeros((self.n_slots,), bool)
        mask[out.decode_slots] = True
        kv_len = np.where(mask, np.maximum(lengths - 1, 0), 0) \
            .astype(np.int32)
        last = np.where(mask, self.buffer.last_tokens(), 0) \
            .astype(np.int64)[:, None]
        logits = self._decode_masked(self._dev(last), self._dev(kv_len),
                                     self._dev(mask))
        nxt = logits[:, 0].argmax(dim=-1).cpu().numpy()   # (B,) tokens only
        for slot in out.decode_slots:
            sid = int(self.buffer.seq_ids[slot])
            tok = int(nxt[slot])
            self.mgr.append_token(sid, tok)
            self.buffer.append(slot, tok)
            self.metrics["tokens"] += 1
            req = self.active.get(sid)
            if req is not None and req.first_decode_step is None:
                req.first_decode_step = self._step_count
            if self.eos is not None and tok == self.eos:
                self.mgr.seqs[sid].done = True
        self.metrics["decode_steps"] += 1
        self.mgr.observe_step()
        self.metrics["decode_s"] += time.perf_counter() - t0

    def stats(self) -> dict:
        s = self.mgr.stats()
        m = dict(self.metrics)
        pf = s.get("prefix")
        if pf is not None:
            m["prefill_tokens_saved"] = pf["tokens_saved"]
            m["shared_admissions"] = pf["hits"]
        if self.sched is not None:
            m["sched"] = self.sched.stats()
        return {**m, **s}
