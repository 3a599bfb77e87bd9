"""Serving engine over the paged SVA layer (port of
``repro/core/serving/engine.py``: ``zero_copy`` offload, fixed scheduler).

Zero-copy offload at serving granularity (the paper's map-don't-copy result
applied to KV admission): ONE global physical page pool per KV layer is
shared by every batch slot. Admission writes block-table rows (ints), and a
single batched, bucketed prefill scatters KV directly into the shared pool
through those tables. Decode consumes delta table uploads: only rows whose
tables changed since the last step are re-sent, with a full upload only on
epoch invalidation.

Copy-on-write prefix sharing: admission maps a prompt's already-resident
prefix pages via refcount++ in the manager's PrefixIndex; the batched
prefill feeds only each prompt's suffix, reading the prefix's KV back out of
the shared pool and scattering through ``write_tables`` whose shared
entries are NULLed. A decode append into a page another sequence still maps
queues a CoW page copy, executed here as one batched pool-to-pool copy.

The host-side layer (``core/sva``: page pool, IOMMU, IOTLB, prefix index,
svasan) is a byte copy of the reference's, so admission, translation and
statistics match it step for step. The pools are updated in place (the JAX
engine donates its cache to each jitted step instead).

Not ported here: ``offload_mode="copy"``, ``scheduler="continuous"`` and
archs with per-slot state (sliding-window rings, recurrent state,
cross-KV); each raises NotImplementedError.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sva.iommu import (AutoTuneConfig, PrefetchConfig,
                                        TLBConfig, default_autotune_candidates)
from repro_torch.core.sva.kv_manager import PagedKVManager
from repro_torch.models.model import (forward_decode, forward_prefill,
                                      init_cache, install_tables)
from repro_torch.models.params import resolve_device, torch_dtype


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


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, n_slots: int, max_len: int,
                 page_size: int = 8, offload_mode: str = "zero_copy",
                 eos_token: Optional[int] = None,
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
        if scheduler == "continuous":
            raise NotImplementedError("scheduler='continuous' is not ported "
                                      "yet (fixed only)")
        if offload_mode not in ("zero_copy", "copy"):
            raise ValueError(f"offload_mode={offload_mode!r} "
                             "(expected 'zero_copy' or 'copy')")
        if offload_mode == "copy":
            raise NotImplementedError("offload_mode='copy' is not ported yet "
                                      "(zero_copy only)")
        if (cfg.is_encdec or cfg.n_image_tokens
                or any(k != "attn_mlp" for k in cfg.layer_kinds())):
            raise NotImplementedError(
                f"{cfg.name}: layers with per-slot state (sliding-window "
                "rings, recurrent state, cross-KV) or non-attn_mlp kinds are "
                "not ported; the port serves dense attn_mlp decoders")
        self.device = resolve_device(device)
        self.cfg, self.params = cfg, params
        self.n_slots, self.page_size = n_slots, page_size
        self.eos = eos_token
        self.max_pages = -(-max_len // page_size)
        kv_bytes = (2 * cfg.n_kv_heads * cfg.d_head * len(cfg.layer_kinds())
                    * torch_dtype(cfg.activation_dtype).itemsize)
        self._can_share = prefix_sharing
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
        self._next_id = 0
        self._step_count = 0
        self.metrics = {"prefills": 0, "prefill_reqs": 0, "decode_steps": 0,
                        "tokens": 0, "staging_copies": 0, "prefill_s": 0.0,
                        "decode_s": 0.0, "admit_s": 0.0,
                        "table_uploads_full": 0, "table_uploads_delta": 0,
                        "table_rows_uploaded": 0, "table_upload_bytes": 0,
                        "admit_table_bytes": 0,
                        "prefill_tokens_saved": 0, "shared_admissions": 0,
                        "cow_page_copies": 0}
        self.null_page = n_slots * self.max_pages
        self.cache = init_cache(cfg, n_slots, max_len, page_size,
                                global_pages=self.null_page,
                                device=self.device)
        self._tables_dev = torch.full((n_slots, self.max_pages),
                                      self.null_page, dtype=torch.int32,
                                      device=self.device)
        self._epoch_seen = -1

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # --------------------------------------------------------------- API
    def submit(self, prompt: List[int], max_tokens: int = 16,
               tenant: Optional[str] = None) -> int:
        self.mgr._check_tenant_name(tenant)
        self.mgr.ensure_fits(len(prompt), max_tokens, tenant=tenant)
        rid = self._next_id
        self._next_id += 1
        self.queue.append(Request(rid, list(prompt), max_tokens,
                                  tenant=tenant,
                                  submitted_at=time.perf_counter(),
                                  submitted_step=self._step_count))
        return rid

    @property
    def has_work(self) -> bool:
        return bool(self.queue or self.active)

    def step(self, finished: Dict[int, Request]) -> None:
        """Run ONE engine step (admission + decode + completion harvest)."""
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
            req.out_tokens = st.tokens
            if self.translation_trace is not None:
                self.translation_trace.append(
                    ("unmap", st.slot, len(st.pages)))
            self.mgr.release(rid)
            finished[rid] = req

    def invalidate_epoch(self) -> None:
        """Flush every device translation; the next decode step performs a
        full-table upload."""
        self.mgr.invalidate_epoch()

    # --------------------------------------------------------------- admission
    def _admit(self):
        self._apply_cow()   # queued page copies must land before any new
                            # prefill can recycle their source pages
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
            self._batched_prefill(waves[w])
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
        """ONE padded prefill call for a wave of admitted requests: KV is
        scattered straight into the shared pool through their tables.
        Prefix-shared admissions feed only their suffix."""
        t0 = time.perf_counter()
        sufs = [len(req.prompt) - st.prefill_start for req, st in group]
        sharing = any(st.shared_pages for _, st in group)
        lb = self._bucket_len(max(sufs))
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
                 "lengths": self._dev(lengths)}
        if sharing:
            batch["prefix_lens"] = self._dev(prefix)
            batch["write_tables"] = self._dev(wtables)
        view = install_tables(self.cache, self._dev(tables), batch["lengths"])
        with torch.no_grad():
            logits, _ = forward_prefill(self.cfg, self.params, batch, view)
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

    # --------------------------------------------------------------- CoW
    def _cow_copy_pages(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """One batched physical page duplication in every layer's pools:
        ``pool[dst] = pool[src]``. Padding pairs carry dst == NULL and are
        dropped; every source page is read before any destination is
        written."""
        rows = torch.nonzero(dst < self.null_page, as_tuple=True)[0]
        src, dst = src[rows].long(), dst[rows].long()
        for kv in self.cache:
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
        self._apply_cow()       # duplicated pages must exist before the
                                # decode writes/reads through new tables
        self._upload_tables()
        if self._translation_stats:
            accesses = self.mgr.translate_step()
            if self.translation_trace is not None:
                self.translation_trace.append(
                    ("step", accesses, int(kv_len.sum())))
        pos = self._dev(kv_len)
        cache = install_tables(self.cache, self._tables_dev, pos)
        with torch.no_grad():
            logits, self.cache = forward_decode(self.cfg, self.params,
                                                self._dev(last), pos, cache)
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

    def stats(self) -> dict:
        s = self.mgr.stats()
        m = dict(self.metrics)
        pf = s.get("prefix")
        if pf is not None:
            m["prefill_tokens_saved"] = pf["tokens_saved"]
            m["shared_admissions"] = pf["hits"]
        return {**m, **s}
