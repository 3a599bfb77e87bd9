"""Paged KV-cache manager: binds the SVA layer to the compiled model's
cache view.

Two layouts:

  global   (zero-copy serving) ONE PagePool shared by every slot. The
           compiled step sees a single physical page pool per KV layer
           (``n_slots * max_pages`` pages) and per-slot int32 block tables
           indexing into it. Unallocated table entries hold the NULL page id
           (== total page count): device writes through them are dropped and
           gathers read as zero. Admission writes table rows only — KV data
           is produced in place by the batched prefill scatter.

  per_slot (copy baseline) one PagePool per slot; each table row is a
           permutation of [0, max_pages) over that slot's private pool. This
           is the layout the staging-copy admission path (the paper's
           baseline) uses.

Copy-on-write prefix sharing (global layout): a :class:`PrefixIndex` keyed
by token-content hash chains over FULL pages lets ``admit`` map a prompt's
already-resident prefix pages via refcount++ instead of fresh allocation —
the paper's map-don't-copy result applied across *requests* (multiple agents
translating to the same physical pages, RadixAttention-style). The index
also caches one partially-filled tail page per prompt, so an identical
prompt maps end-to-end with zero fresh prefill. Shared pages are immutable:
``append_token`` detects a write landing in a page whose refcount > 1 and
either *steals* it back from the index (sole other owner) or performs a CoW
duplication — a fresh page plus a queued device-side page copy (drained by
the engine via ``drain_cow_copies`` before the next decode step). ``release``
only drops the sequence's own references, so prefix pages survive completion
as a warm prefix cache; the index LRU-evicts leaf entries when the pool runs
dry.

Translation goes through the unified :class:`~repro_torch.core.sva.iommu.IOMMU`
front-end: one PASID-style address space per batch slot, a large
``CountingWalk`` TLB (the delta-upload cache), and ``translate_step()``
running every decode step's page gathers through it — the live-traffic
counterpart of the simulator's 4-entry hardware IOTLB (same class,
different ``TLBConfig``). Delta-upload bookkeeping: rows whose tables
changed since the last device upload accumulate in ``dirty_rows`` and are
drained with ``delta_rows()`` — the serving-level analogue of a warm IOTLB.
``invalidate_epoch()`` models the paper's Listing-1 flush: every
translation dies (the IOMMU epoch bumps exactly once) and the next upload
must be a full-table upload.

Adaptive front-end hooks (both default-off):

  * ``tlb_prefetch=PrefetchConfig(...)`` arms the IOMMU's IOTLB prefetcher
    on the decode gather stream (Kurth-et-al. MMU-aware DMA prefetch);
  * ``autotune=AutoTuneConfig(...)`` attaches a :class:`TLBAutoTuner` that
    ``translate_step`` advances once per decode step — the serving TLB
    geometry then follows the live hit-rate/conflict-miss signal instead
    of a static per-deployment pick from ``benchmarks/tlb_sweep.py``
    (a switch = flush + epoch bump, so the engine's next table upload is
    full).

Disaggregated serving (``migrate``): a finished prefill's pages hand off
between two ASIDs over the SAME pool — modeled remote DMA in which the
source ASID translates every page through a transfer IOMMU (per-page
PTW/IOTLB cost under the fabric's walk model) before the pages either
re-attach zero-copy (``share``: refcount hand-off + table move, the SVA
payoff) or are duplicated device-side (``copy``: the staged baseline).
Accounting accumulates in :class:`TransferStats` (the ``transfer:`` stats
block).

Stats schema (``stats()``; see ARCHITECTURE.md): ``sva:`` host-side mode
counters (disjoint zero-copy vs staging), ``tlb:`` the IOMMU's TLBStats
dict, ``iommu:`` {walk, epoch, asids, tlb_entries, tlb_ways, tlb_policy,
autotune: when tuning}, ``pool_*`` page-pool gauges, ``prefix:`` the
PrefixIndex block (hits/misses/pages_shared/tokens_saved/evictions/
steals/cached_pages/policy/max_pages) when sharing is on, ``tenant:``
per-tenant quota/occupancy/TLB blocks when tenants are configured,
``transfer:`` the TransferStats block once a migration has run.

Multi-tenant serving (``tenants={name: {quota_pages,
quota_prefix_pages, tlb_ways}}``): each tenant gets a
:class:`~repro_torch.core.sva.iommu.TenantDomain` (admission attaches every
slot under its owner, so the decode gather stream is isolation-checked
each step), a page quota admission defers on and the scheduler preempts
over, a prefix-cache scope of its own (identical cross-tenant prompts
NEVER share pages — the index keys are tenant-scoped at the root), an
optional private prefix-page cap, and optionally private IOTLB ways
(``TLBConfig.partitions``). No tenants configured = bit-identical to the
single-tenant manager.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.sva.iommu import (IOMMU, AutoTuneConfig, CountingWalk,
                                  PrefetchConfig, TLBAutoTuner, TLBConfig)
from repro_torch.core.sva.mapping import SVAStats
from repro_torch.core.sva.page_pool import OutOfPages, PagePool
from repro_torch.core.sva.sanitizer import SVASanitizer
from repro_torch.core.sva.sanitizer import resolve as _resolve_sanitize


class CapacityError(ValueError):
    """Request can NEVER be admitted (prompt+max_tokens exceeds slot
    capacity) — distinct from a transient OutOfPages/no-slot condition."""


@dataclass
class SeqState:
    seq_id: int
    slot: int
    length: int                   # tokens in cache
    pages: List[int]              # physical page ids
    max_tokens: int
    tokens: List[int] = field(default_factory=list)   # generated so far
    done: bool = False
    shared_pages: int = 0         # leading pages mapped from the prefix index
    prefill_start: int = 0        # first prompt position that needs compute
    tenant: Optional[str] = None  # owning tenant domain (None = untenanted)


class _PrefixNode:
    """One FULL page of prompt tokens in the content-addressed radix chain.

    Children are keyed by the NEXT page's token tuple; ``partials`` caches
    partially-filled tail pages (content tuple -> [page, lru, uses]). Every
    node and every partial entry owns exactly one pool reference on its
    page."""

    __slots__ = ("page", "parent", "key", "children", "partials",
                 "last_used", "uses", "tenant")

    def __init__(self, page: Optional[int], parent: Optional["_PrefixNode"],
                 key: Optional[Tuple[int, ...]],
                 tenant: Optional[str] = None):
        self.page = page
        self.parent = parent
        self.key = key
        self.children: Dict[Tuple[int, ...], _PrefixNode] = {}
        self.partials: Dict[Tuple[int, ...], List] = {}  # content -> [page, lru, uses]
        self.last_used = 0
        self.uses = 0
        self.tenant = tenant      # owning tenant (root-level scope tag)


@dataclass
class PrefixStats:
    hits: int = 0                 # admissions that mapped >= 1 shared page
    misses: int = 0
    pages_shared: int = 0         # share events at admission
    tokens_saved: int = 0         # prompt tokens whose prefill was skipped
    evictions: int = 0            # LRU entries dropped under page pressure
    steals: int = 0               # index entries reclaimed by their writer

    def as_dict(self):
        return dict(hits=self.hits, misses=self.misses,
                    pages_shared=self.pages_shared,
                    tokens_saved=self.tokens_saved,
                    evictions=self.evictions, steals=self.steals)


PREFIX_POLICIES = ("lru", "lfu", "gdsfs")


class PrefixIndex:
    """Longest-shared-prefix lookup over admitted prompts, token-hash per
    full page (plus one cached partial tail page per prompt).

    Eviction under page pressure is policy-pluggable — ``lru`` recency,
    ``lfu`` frequency (keeps a popular system prompt resident even when a
    burst of one-off prompts churns the pool), or ``gdsfs`` size-aware
    frequency: score = uses × covered-tokens ÷ page-span (the TLB's
    GDSFS score with the prefill compute saved per hit as the cost term),
    so at equal frequency a partial tail page covering 3 tokens is shed
    before a full page covering ``page_size`` — both hold one page, but
    the full page saves more recompute per hit. ``max_pages`` caps the
    warm cache's footprint: after every admission the index sheds entries
    it solely owns until it fits (live sequences' pages never count
    against eviction — freeing them returns nothing)."""

    def __init__(self, page_size: int, policy: str = "lru",
                 max_pages: int = 0):
        if policy not in PREFIX_POLICIES:
            raise ValueError(
                f"policy={policy!r} (expected one of {PREFIX_POLICIES})")
        self.page_size = page_size
        self.policy = policy
        self.max_pages = max_pages          # 0 = uncapped
        self.root = _PrefixNode(None, None, None)
        self._clock = 0
        self._partial_by_page: Dict[int, Tuple[_PrefixNode, Tuple[int, ...]]] = {}
        self._node_by_page: Dict[int, _PrefixNode] = {}
        self.stats = PrefixStats()

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    @property
    def n_cached_pages(self) -> int:
        return len(self._node_by_page) + len(self._partial_by_page)

    # ------------------------------------------------------------- lookup
    @staticmethod
    def _scoped(tenant: Optional[str],
                key: Tuple[int, ...]) -> Tuple:
        """Root-level key scoping: a tenant's chains hang off root children
        keyed ``(tenant, tok...)`` — deeper levels are reachable only
        through them, so one scope tag isolates the whole subtree.
        ``tenant=None`` keys are byte-identical to the untenanted index
        (adversarial cross-tenant prefix collisions CANNOT share pages)."""
        return key if tenant is None else (tenant,) + key

    def match(self, tokens: Sequence[int],
              tenant: Optional[str] = None) -> Tuple[List[int], int]:
        """Longest shared prefix of ``tokens`` already resident in the pool
        (within ``tenant``'s scope — cached KV never crosses the tenant
        boundary even for identical token content).

        Returns (pages, matched_tokens): full pages matched by content chain,
        plus the cached partial tail page iff it covers the ENTIRE remaining
        prompt (so prefill never has to write into the middle of a shared
        page — writes into shared pages only ever come from decode appends,
        which CoW)."""
        p = self.page_size
        now = self._tick()
        node = self.root
        pages: List[int] = []
        i = 0
        while i + p <= len(tokens):
            key = tuple(tokens[i:i + p])
            if node is self.root:
                key = self._scoped(tenant, key)
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = now
            child.uses += 1
            pages.append(child.page)
            node = child
            i += p
        rem = tuple(tokens[i:])
        matched = i
        pkey = self._scoped(tenant, rem) if node is self.root else rem
        if rem and pkey in node.partials:
            entry = node.partials[pkey]
            entry[1] = now
            entry[2] += 1
            pages.append(entry[0])
            matched += len(rem)
        return pages, matched

    # ----------------------------------------------------------- register
    def register(self, tokens: Sequence[int], pages: Sequence[int],
                 pool: PagePool, tenant: Optional[str] = None) -> None:
        """Insert a newly admitted prompt's pages under ``tenant``'s scope.
        Each NEW entry takes one pool reference (the warm-cache ownership
        that outlives the sequence); already-present entries are left
        untouched (the admitted sequence mapped those very pages via
        ``match``)."""
        p = self.page_size
        now = self._tick()
        node = self.root
        i = 0
        li = 0
        while i + p <= len(tokens):
            key = tuple(tokens[i:i + p])
            if node is self.root:
                key = self._scoped(tenant, key)
            child = node.children.get(key)
            if child is None:
                child = _PrefixNode(pages[li], node, key, tenant=tenant)
                child.uses = 1            # the registering admission
                node.children[key] = child
                self._node_by_page[pages[li]] = child
                pool.share([pages[li]])  # svalint: disable=R002
            child.last_used = now
            node = child
            i += p
            li += 1
        rem = tuple(tokens[i:])
        pkey = self._scoped(tenant, rem) if node is self.root else rem
        if rem and pkey not in node.partials and li < len(pages):
            node.partials[pkey] = [pages[li], now, 1]
            self._partial_by_page[pages[li]] = (node, pkey)
            pool.share([pages[li]])  # svalint: disable=R002

    # ----------------------------------------------------------- eviction
    def _score(self, uses: int, recency: int, covered: int):
        """Eviction key (min is evicted): recency under ``lru``,
        (frequency, recency) under ``lfu``, (frequency × covered-tokens ÷
        page-span, recency) under ``gdsfs`` — the size-aware score."""
        if self.policy == "lru":
            return recency
        if self.policy == "lfu":
            return (uses, recency)
        return (uses * covered / self.page_size, recency)     # gdsfs

    @staticmethod
    def _content_len(content: Tuple) -> int:
        """Token count a partial's content key covers (a root-level scoped
        key carries the tenant tag first — not a token)."""
        return len(content) - (1 if content
                               and isinstance(content[0], str) else 0)

    def _tenant_of_entry(self, kind: str, node: "_PrefixNode",
                         key: Tuple) -> Optional[str]:
        """Owning tenant of an evictable entry: the node's root-level scope
        tag, or — for a partial hanging directly off the root — the scope
        prefix of its content key."""
        if kind == "node" or node is not self.root:
            return node.tenant
        return key[0] if key and isinstance(key[0], str) else None

    def _candidates(self):
        """(score, kind, node, key) for every evictable entry — partial
        pages, and leaf full-page nodes (no children, no partials); parents
        become evictable bottom-up once their subtree is gone."""
        out = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            for content, (page, lru, uses) in n.partials.items():
                out.append((self._score(uses, lru,
                                        self._content_len(content)),
                            "partial", n, content))
            if n is not self.root and not n.children and not n.partials:
                out.append((self._score(n.uses, n.last_used, self.page_size),
                            "node", n, n.key))
        return out

    def cached_pages_by_tenant(self) -> Dict[Optional[str], int]:
        """Warm-cache footprint per tenant scope (None = untenanted) — the
        gauge per-tenant prefix quotas are enforced against."""
        out: Dict[Optional[str], int] = {}
        for node in self._node_by_page.values():
            out[node.tenant] = out.get(node.tenant, 0) + 1
        for node, content in self._partial_by_page.values():
            t = self._tenant_of_entry("partial", node, content)
            out[t] = out.get(t, 0) + 1
        return out

    def evict_one(self, pool: PagePool,
                  tenant: object = False) -> bool:
        """Drop the policy-selected evictable entry whose page the index is
        the SOLE owner of (refcount 1 — freeing it actually returns a
        page). Entries still referenced by live sequences are kept: evicting
        them frees nothing and only destroys future sharing value.
        ``tenant`` (pass a name or None) restricts eviction to one tenant
        scope — per-tenant prefix quotas shed only their owner's entries;
        the ``False`` default considers every scope. Returns False when no
        eviction can free a page."""
        page_of = lambda c: c[2].partials[c[3]][0] if c[1] == "partial" \
            else c[2].page
        cands = [c for c in self._candidates() if pool.refcount(page_of(c)) == 1]
        if tenant is not False:
            cands = [c for c in cands
                     if self._tenant_of_entry(c[1], c[2], c[3]) == tenant]
        if not cands:
            return False
        _, kind, node, key = min(cands, key=lambda c: c[0])
        if kind == "partial":
            page = node.partials.pop(key)[0]
            self._partial_by_page.pop(page, None)
        else:
            page = node.page
            node.parent.children.pop(key, None)
            self._node_by_page.pop(page, None)
        pool.free([page])  # svalint: disable=R002
        self.stats.evictions += 1
        return True

    def enforce_cap(self, pool: PagePool) -> None:
        """Shed sole-owned entries until the warm cache fits ``max_pages``
        (no-op when uncapped or when every over-cap entry is still pinned by
        a live sequence)."""
        if not self.max_pages:
            return
        while self.n_cached_pages > self.max_pages:
            if not self.evict_one(pool):
                break

    def enforce_tenant_cap(self, pool: PagePool, tenant: Optional[str],
                           cap: int) -> None:
        """Per-tenant prefix quota: shed ``tenant``'s sole-owned entries
        until its scope fits ``cap`` cached pages (0 = uncapped)."""
        if not cap:
            return
        while self.cached_pages_by_tenant().get(tenant, 0) > cap:
            if not self.evict_one(pool, tenant=tenant):
                break

    def evictable_pages(self, pool: PagePool) -> int:
        """Pages the index could EVENTUALLY return to the pool: cached pages
        whose only reference is the index's own (refcount 1). A live
        sequence pinning a chain page pins every ancestor too (it maps the
        whole chain), so a refcount-1 page's entire subtree is refcount-1
        and bottom-up ``evict_one`` calls can free all of them — this is
        the prefix cache's contribution to the scheduler's page headroom."""
        return (sum(1 for pg in self._node_by_page
                    if pool.refcount(pg) == 1)
                + sum(1 for pg in self._partial_by_page
                      if pool.refcount(pg) == 1))

    def try_release_for_write(self, page: int, pool: PagePool) -> bool:
        """A sequence is about to write into ``page`` and found refcount > 1.
        If the ONLY other owner is this index (refcount == 2) and the entry
        is a leaf, reclaim it — drop the cache entry instead of copying.
        Returns True when the caller may now write in place."""
        if pool.refcount(page) != 2:
            return False
        if page in self._partial_by_page:
            node, content = self._partial_by_page.pop(page)
            node.partials.pop(content, None)
        elif page in self._node_by_page:
            node = self._node_by_page[page]
            if node.children or node.partials:
                return False          # descendants still depend on the chain
            del self._node_by_page[page]
            node.parent.children.pop(node.key, None)
        else:
            return False
        pool.free([page])  # svalint: disable=R002
        self.stats.steals += 1
        return True


class PrefixCapTuner:
    """Online controller for the prefix-cache page cap (``PrefixIndex
    .max_pages``), replacing a static ``prefix_cache_pages`` pick with a
    live-pressure policy. Every ``interval`` observed steps it closes a
    window and compares the window's eviction count (cache churn under
    pool pressure) against its hit count (sharing value):

      shrink  free pages < 25% of the pool AND evictions outpaced hits —
              the warm cache is squatting on pages the allocator keeps
              clawing back one eviction at a time; halve the cap (floor
              ``min_pages``) and enforce it immediately, so admission and
              decode growth see the headroom as ordinary free pages.
      grow    free pages > 50% AND hits kept up with evictions — sharing
              is earning its footprint and the pool has slack; double the
              cap (ceiling: the pool size).

    Between those bands the cap holds (hysteresis — the two thresholds
    keep a borderline pool from oscillating every window)."""

    def __init__(self, index: PrefixIndex, pool: PagePool,
                 interval: int, min_pages: int = 4):
        if interval < 1:
            raise ValueError(f"interval={interval} (need >= 1)")
        self.index = index
        self.pool = pool
        self.interval = interval
        self.min_pages = min_pages
        self._steps = 0
        self._last_ev = index.stats.evictions
        self._last_hits = index.stats.hits
        self.windows = 0
        self.shrinks = 0
        self.grows = 0

    def observe_step(self) -> None:
        self._steps += 1
        if self._steps < self.interval:
            return
        self._steps = 0
        self.windows += 1
        d_ev = self.index.stats.evictions - self._last_ev
        d_hit = self.index.stats.hits - self._last_hits
        self._last_ev = self.index.stats.evictions
        self._last_hits = self.index.stats.hits
        free_frac = self.pool.n_free / max(self.pool.n_pages, 1)
        cached = self.index.n_cached_pages
        # 0 == uncapped: the effective cap is whatever is cached right now.
        cap = self.index.max_pages or max(cached, self.min_pages)
        if free_frac < 0.25 and d_ev > d_hit:
            new = max(self.min_pages, min(cap, max(cached, 1)) // 2)
            if not self.index.max_pages or new < self.index.max_pages:
                self.index.max_pages = new
                self.index.enforce_cap(self.pool)
                self.shrinks += 1
        elif free_frac > 0.5 and d_hit >= d_ev:
            new = min(self.pool.n_pages, cap * 2)
            if self.index.max_pages and new > self.index.max_pages:
                self.index.max_pages = new
                self.grows += 1

    def stats(self) -> dict:
        return {"windows": self.windows, "shrinks": self.shrinks,
                "grows": self.grows}


@dataclass
class TransferStats:
    """Accounting for prefill->decode KV migrations (modeled remote DMA).

    ``payload_bytes`` is what actually moves over the fabric: copy-mode
    duplicates every page's KV, share-mode moves only the translated table
    entries (``table_bytes``) — the SVA payoff measured by
    ``benchmarks/disagg_serving.py``. The tlb/prefetch counters are deltas
    of the transfer IOMMU's TLBStats across each migration's translation
    loop, so the ``transfer:`` block isolates hand-off translation cost
    from the serving hot path's."""
    transfers: int = 0            # completed migrations
    pages_copied: int = 0         # copy-mode: fresh decode-side pages
    pages_shared: int = 0         # share-mode: zero-copy re-attachments
    payload_bytes: int = 0        # KV bytes moved (copy mode only)
    table_bytes: int = 0          # translated table entries handed off
    ptw_cycles: float = 0.0       # walk cost of the per-page translations
    tlb_hits: int = 0
    tlb_misses: int = 0
    prefetch_issued: int = 0
    prefetch_useful: int = 0
    prefetch_late: int = 0

    def as_dict(self):
        return dict(transfers=self.transfers,
                    pages_copied=self.pages_copied,
                    pages_shared=self.pages_shared,
                    payload_bytes=self.payload_bytes,
                    table_bytes=self.table_bytes,
                    ptw_cycles=round(self.ptw_cycles, 3),
                    tlb_hits=self.tlb_hits,
                    tlb_misses=self.tlb_misses,
                    prefetch_issued=self.prefetch_issued,
                    prefetch_useful=self.prefetch_useful,
                    prefetch_late=self.prefetch_late)


class PagedKVManager:
    """Page allocation + block tables for a fixed-B decode step."""

    def __init__(self, n_slots: int, max_pages_per_slot: int, page_size: int,
                 kv_bytes_per_token: int = 0, offload_mode: str = "zero_copy",
                 layout: Optional[str] = None, prefix_sharing: bool = True,
                 prefix_policy: str = "lru", prefix_cap_pages: int = 0,
                 tlb_entries: int = 4096, tlb_policy: str = "lru",
                 tlb_ways: int = 0, tlb_ranges: int = 0,
                 tlb_prefetch: Optional[PrefetchConfig] = None,
                 autotune: Optional[AutoTuneConfig] = None,
                 prefix_autotune: int = 0,
                 pool_pages: Optional[int] = None,
                 sanitize: Optional[bool] = None,
                 tenants: Optional[Dict[str, dict]] = None):
        assert offload_mode in ("zero_copy", "copy")
        if layout is None:
            layout = "global" if offload_mode == "zero_copy" else "per_slot"
        assert layout in ("global", "per_slot")
        # Multi-tenant domains: name -> {quota_pages, quota_prefix_pages,
        # tlb_ways} (every knob optional, 0 = unlimited/shared). Quotas
        # need the one shared pool; nonzero tlb_ways way-partition the
        # serving IOTLB per tenant.
        self.tenant_specs: Dict[str, dict] = \
            {str(t): dict(spec or {}) for t, spec in tenants.items()} \
            if tenants else {}
        tlb_partitions: Dict[str, int] = {}
        if self.tenant_specs:
            if layout != "global":
                raise ValueError("tenants require the global layout "
                                 "(quotas meter the one shared pool)")
            allowed = {"quota_pages", "quota_prefix_pages", "tlb_ways"}
            for t, spec in self.tenant_specs.items():
                unknown = set(spec) - allowed
                if unknown:
                    raise ValueError(
                        f"tenant {t!r}: unknown keys {sorted(unknown)} "
                        f"(expected {sorted(allowed)})")
                for k, v in spec.items():
                    if not isinstance(v, int) or v < 0:
                        raise ValueError(
                            f"tenant {t!r}: {k}={v!r} (need an int >= 0)")
                if spec.get("tlb_ways"):
                    tlb_partitions[t] = spec["tlb_ways"]
            if tlb_partitions and autotune is not None:
                raise ValueError(
                    "TLB way partitions and the geometry auto-tuner are "
                    "mutually exclusive (a retune would drop the "
                    "partitions)")
            if tlb_partitions and not tlb_ways:
                raise ValueError(
                    "per-tenant tlb_ways need a set-associative TLB "
                    "(set tlb_ways on the manager)")
        self.n_slots = n_slots
        self.max_pages = max_pages_per_slot
        self.page_size = page_size
        self.kv_bytes_per_token = kv_bytes_per_token
        self.offload_mode = offload_mode
        self.layout = layout
        self.total_pages = n_slots * max_pages_per_slot
        self.null_page = self.total_pages            # device drop/zero sentinel
        # ``pool_pages`` constrains the PHYSICAL pool below the worst case
        # (n_slots full slots) — the oversubscription regime continuous
        # batching is built for: lazy admissions pack more live sequences
        # than full reservations would, and the scheduler preempts when
        # growth outruns the pool. Device arrays keep worst-case sizing
        # (the null page id is unchanged); the allocator just never hands
        # out pages >= pool_pages.
        if pool_pages is None:
            pool_pages = self.total_pages
        if layout == "global":
            if not max_pages_per_slot <= pool_pages <= self.total_pages:
                raise ValueError(
                    f"pool_pages={pool_pages} (need max_pages_per_slot="
                    f"{max_pages_per_slot} <= pool_pages <= "
                    f"{self.total_pages})")
        elif pool_pages != self.total_pages:
            raise ValueError("pool_pages requires the global layout")
        self.pool_pages = pool_pages
        if layout == "global":
            self.pool = PagePool(pool_pages, page_size)
            self.pools = None
            self.tables = np.full((n_slots, max_pages_per_slot),
                                  self.null_page, np.int32)
        else:
            # One pool per slot (the compiled step's pool rows are per-slot).
            self.pools = [PagePool(max_pages_per_slot, page_size)
                          for _ in range(n_slots)]
            self.pool = None
            self.tables = np.zeros((n_slots, max_pages_per_slot), np.int32)
        # Prefix sharing needs one physical page space addressable from every
        # slot's table row — only the global layout has that.
        self.prefix = (PrefixIndex(page_size, policy=prefix_policy,
                                   max_pages=prefix_cap_pages)
                       if layout == "global" and prefix_sharing else None)
        self.pending_cow: List[Tuple[int, int]] = []   # (src, dst) page copies
        self.sva_stats = SVAStats()      # host-side mode counters
        # Unified translation front-end: one ASID per batch slot, a large
        # delta-upload cache over a pure-stats walker — the same IOMMU class
        # the simulator configures as a 4-entry hardware IOTLB + Sv39 walk.
        self.iommu = IOMMU(walk_model=CountingWalk(),
                           tlb=TLBConfig(tlb_entries, tlb_policy,
                                         ways=tlb_ways, ranges=tlb_ranges,
                                         partitions=tlb_partitions),
                           prefetch=tlb_prefetch or PrefetchConfig())
        # One TenantDomain per configured tenant: admission attaches each
        # slot under its owner, so every translate is isolation-checked.
        self.tenant_domains = {t: self.iommu.register_tenant(t)
                               for t in sorted(self.tenant_specs)}
        # Online geometry auto-tuner (default off): translate_step advances
        # it one window per decode step; a geometry switch is a flush +
        # epoch bump, which the engine observes as a full table upload.
        self.autotuner = (TLBAutoTuner(self.iommu, autotune)
                          if autotune is not None else None)
        # Prefix-cache cap autotuner (default off): the engine advances it
        # once per decode step via ``observe_step``; it shrinks/grows
        # ``PrefixIndex.max_pages`` from live pool pressure.
        if prefix_autotune < 0:
            raise ValueError(
                f"prefix_autotune={prefix_autotune} (need >= 0; 0 = off)")
        self.prefix_tuner = (PrefixCapTuner(self.prefix, self.pool,
                                            prefix_autotune)
                             if prefix_autotune and self.prefix is not None
                             else None)
        # svasan (core/sva/sanitizer.py): opt-in shadow-state checking over
        # the pool(s) + the IOMMU. ``sanitize=None`` defers to REPRO_SVASAN.
        self.sanitizer = (SVASanitizer() if _resolve_sanitize(sanitize)
                          else None)
        if self.sanitizer is not None:
            for p in ([self.pool] if self.pool is not None else self.pools):
                self.sanitizer.attach_pool(p)
            self.iommu.sanitizer = self.sanitizer
        self.free_slots = list(range(n_slots - 1, -1, -1))
        self.seqs: Dict[int, SeqState] = {}
        self.lengths = np.zeros((n_slots,), np.int32)
        self.dirty_rows = set(range(n_slots))
        self.preemptions = 0
        self.resumes = 0
        self.transfer_stats = TransferStats()

    @property
    def tlb(self):
        """The IOMMU's shared translation cache (stats / test hook)."""
        return self.iommu.tlb

    @property
    def epoch(self) -> int:
        """Full-flush count — owned by the IOMMU (paper Listing 1)."""
        return self.iommu.epoch

    # ------------------------------------------------------------- tenants
    @property
    def has_tenants(self) -> bool:
        return bool(self.tenant_specs)

    def _check_tenant_name(self, tenant: Optional[str]) -> None:
        if tenant is not None and tenant not in self.tenant_specs:
            raise ValueError(f"tenant {tenant!r} is not configured "
                             f"(known: {sorted(self.tenant_specs)})")

    def tenant_pages_used(self, tenant: Optional[str]) -> int:
        """Pool pages currently mapped by the tenant's live sequences
        (shared prefix pages count once per sequence holding them — the
        quota meters mappings, like the pool refcounts do)."""
        return sum(len(st.pages) for st in self.seqs.values()
                   if st.tenant == tenant)

    def tenant_quota(self, tenant: Optional[str]) -> int:
        """The tenant's page quota (0 = unlimited)."""
        if tenant is None or tenant not in self.tenant_specs:
            return 0
        return self.tenant_specs[tenant].get("quota_pages", 0)

    def tenant_headroom(self, tenant: Optional[str]) -> int:
        """Pages the tenant may still map under its quota
        (``pool_pages`` stands in for 'unlimited')."""
        quota = self.tenant_quota(tenant)
        if not quota:
            return self.pool_pages
        return max(0, quota - self.tenant_pages_used(tenant))

    def tenants_over_quota(self) -> List[str]:
        """Tenants whose live mappings exceed their page quota right now
        (decode growth runs ahead of admission-time checks) — the
        scheduler's quota-pressure preemption signal."""
        return [t for t in sorted(self.tenant_specs)
                if self.tenant_quota(t)
                and self.tenant_pages_used(t) > self.tenant_quota(t)]

    def _enforce_tenant_prefix_caps(self) -> None:
        if self.prefix is None:
            return
        for t, spec in self.tenant_specs.items():
            cap = spec.get("quota_prefix_pages", 0)
            if cap:
                self.prefix.enforce_tenant_cap(self.pool, t, cap)

    # ------------------------------------------------------------ admission
    def ensure_fits(self, prompt_len: int, max_tokens: int,
                    tenant: Optional[str] = None) -> int:
        """Single source of truth for the slot-capacity check (used by both
        ``admit`` and the engine's ``submit``). Returns the page count
        needed; raises :class:`CapacityError` when the request can never
        fit — silently truncating the reservation would later wrap page
        indices and corrupt other sequences' KV. With ``tenant`` the check
        extends to the tenant's page quota: a request needing more pages
        than the quota allows can never run, even with the tenant idle."""
        need = -(-(prompt_len + max_tokens) // self.page_size)
        if need > self.max_pages:
            raise CapacityError(
                f"prompt_len={prompt_len} + max_tokens={max_tokens} needs "
                f"{need} pages but a slot holds {self.max_pages} "
                f"({self.max_pages * self.page_size} tokens)")
        if self.layout == "global" and need > self.pool_pages:
            raise CapacityError(
                f"prompt_len={prompt_len} + max_tokens={max_tokens} needs "
                f"{need} pages but the physical pool holds "
                f"{self.pool_pages}")
        quota = self.tenant_quota(tenant)
        if quota and need > quota:
            raise CapacityError(
                f"prompt_len={prompt_len} + max_tokens={max_tokens} needs "
                f"{need} pages but tenant {tenant!r}'s quota is {quota}")
        return need

    def _alloc_evicting(self, n: int, run: bool = False) -> List[int]:
        """Global-pool alloc that evicts warm prefix-cache entries (per the
        index's lru/lfu policy) under ``OutOfPages`` pressure before giving
        up. ``run=True`` (admission's contiguity hint) asks for a
        physically contiguous run first — the substrate range-coalesced
        IOTLB entries form over — falling back to discontiguous pages
        when fragmentation leaves no run."""
        while True:
            try:
                return self.pool.alloc_run(n) if run else self.pool.alloc(n)  # svalint: disable=R002
            except OutOfPages:
                if self.prefix is None or not self.prefix.evict_one(self.pool):
                    raise

    def admit(self, seq_id: int, prompt_len: int, max_tokens: int,
              tokens: Optional[Sequence[int]] = None,
              lazy: bool = False,
              tenant: Optional[str] = None) -> Optional[SeqState]:
        """Allocate a slot + pages for a prompt.

        ``tokens`` (the actual prompt ids) enables prefix sharing: full
        pages whose content is already resident are mapped via refcount++
        instead of fresh allocation, and ``SeqState.prefill_start`` tells
        the engine how many leading tokens need NO prefill compute (their KV
        is already in the shared pages). At least the last prompt token is
        always left to compute so admission can produce first-token logits;
        its KV write is dropped by the engine when it lands in a shared page
        (the page already holds exactly that KV).

        ``lazy`` (continuous batching) reserves only the PROMPT's pages —
        decode growth allocates page-by-page in ``append_token``, and the
        scheduler preempts under pool pressure instead of admission
        pre-paying ``max_tokens`` worth of pages. Lazy admission also skips
        ``PrefixIndex.register``: under chunked prefill the prompt's KV
        materializes over several steps, and registering uncomputed pages
        would let another admission share garbage. The engine registers
        progressively via :meth:`register_progress` as chunks complete.

        ``tenant`` admits under a configured tenant domain: the slot's ASID
        is owned by (and isolation-checked against) that tenant, prefix
        matching is scoped to the tenant's own cached KV, and the tenant's
        page quota gates the admission (over quota -> None, wait).

        Returns None when no slot/pages are free right now (continuous
        batching waits); raises :class:`CapacityError` for requests that can
        never fit (see ``ensure_fits``).
        """
        self._check_tenant_name(tenant)
        need = self.ensure_fits(prompt_len, max_tokens, tenant=tenant)
        if lazy:
            if self.layout != "global":
                raise ValueError("lazy admission requires the global layout")
            need = max(-(-prompt_len // self.page_size), 1)
        if not self.free_slots:
            return None
        quota = self.tenant_quota(tenant)
        if quota and self.tenant_pages_used(tenant) + need > quota:
            return None                      # over quota: wait (transient)
        slot = self.free_slots[-1]
        shared: List[int] = []
        prefill_start = 0
        sharing = (self.prefix is not None and tokens is not None
                   and prompt_len > 0)
        if sharing:
            tokens = list(tokens)[:prompt_len]
            shared, matched = self.prefix.match(tokens, tenant=tenant)
            # Always recompute >= 1 token for logits; when the whole prompt
            # is resident the recomputed token's page is shared and the
            # engine drops its (identical) KV write.
            prefill_start = min(matched, prompt_len - 1)
            if shared:
                self.pool.share(shared)     # hold before eviction can run  # svalint: disable=R002
        if self.layout == "global":
            try:
                # contiguity hint: a sequence's fresh pages try to land as
                # one physical run so they warm/coalesce into a range entry
                fresh = self._alloc_evicting(need - len(shared), run=True)
            except OutOfPages:
                if shared:
                    self.pool.free(shared)  # svalint: disable=R002
                return None
        else:
            try:
                fresh = self.pools[slot].alloc(need)  # svalint: disable=R002
            except OutOfPages:
                return None
        pages = shared + fresh
        self.free_slots.pop()
        st = SeqState(seq_id, slot, prompt_len, pages, max_tokens,
                      shared_pages=len(shared), prefill_start=prefill_start,
                      tenant=tenant)
        self.seqs[seq_id] = st
        if sharing:
            if not lazy:
                self.prefix.register(tokens, pages, self.pool,
                                     tenant=tenant)
            if shared:
                self.prefix.stats.hits += 1
                self.prefix.stats.pages_shared += len(shared)
                self.prefix.stats.tokens_saved += prefill_start
            else:
                self.prefix.stats.misses += 1
            self.prefix.enforce_cap(self.pool)
            self._enforce_tenant_prefix_caps()
        if self.layout == "global":
            row = np.full((self.max_pages,), self.null_page, np.int32)
            row[:need] = pages
        else:
            # Row is kept a PERMUTATION of [0, max_pages): allocated pages
            # first, remaining physical pages as filler — the per-slot
            # prefill scatter inverts it.
            used = set(pages)
            filler = [p for p in range(self.max_pages) if p not in used]
            row = np.asarray(pages + filler, np.int32)
        self.tables[slot] = row
        self.lengths[slot] = prompt_len
        self.dirty_rows.add(slot)
        if self.offload_mode == "copy":
            # Staging baseline: dedicated counters (never map_* — see
            # core/sva/mapping.py stage()).
            self.sva_stats.stage_calls += 1
            self.sva_stats.bytes_copied += \
                prompt_len * self.kv_bytes_per_token
        else:
            # Shared pages still cost a table-entry write (the mapping) —
            # what sharing saves is the allocation and the prefill compute.
            self.sva_stats.map_calls += 1
            self.sva_stats.table_entries_written += len(pages)
            self.sva_stats.bytes_mapped += \
                prompt_len * self.kv_bytes_per_token
        # PASID-style per-request address space: ASID == batch slot. map()
        # installs the logical->physical table and warms the shared TLB.
        # Tenant ownership is established here — every later translate of
        # this slot is isolation-checked against it.
        self.iommu.attach(slot, tenant=tenant).map(pages)
        return st

    def append_token(self, seq_id: int, token: int) -> None:
        st = self.seqs[seq_id]
        st.tokens.append(token)
        st.length += 1
        self.lengths[st.slot] = st.length
        needed = -(-st.length // self.page_size)
        if needed > len(st.pages):
            # Admission reserves prompt+max_tokens upfront, so this only
            # fires for callers that under-reserved; grow or fail loudly.
            if len(st.pages) >= self.max_pages:
                raise CapacityError(
                    f"seq {seq_id} grew past its slot capacity "
                    f"({self.max_pages} pages)")
            if self.layout == "global":
                new = self._alloc_evicting(1)
            else:
                new = self.pools[st.slot].alloc(1)  # svalint: disable=R002
            lp = len(st.pages)
            st.pages.extend(new)
            if self.layout == "global":
                self.tables[st.slot, lp] = new[0]
            else:
                # swap to keep the row a permutation
                row = self.tables[st.slot]
                j = int(np.where(row == new[0])[0][0])
                row[lp], row[j] = row[j], row[lp]
            self.dirty_rows.add(st.slot)
            self.sva_stats.table_entries_written += 1
            self.iommu.space(st.slot).map(new, start=lp)
        if len(st.tokens) >= st.max_tokens:
            st.done = True
        if self.layout == "global" and not st.done:
            # A completing sequence's final token is never written to the
            # device cache (the engine releases it before the next decode
            # step), so duplicating/stealing its target page would only
            # waste a copy or destroy a still-useful cache entry.
            self._cow_before_write(st)
            if self.sanitizer is not None:
                # post-CoW: the page about to be written must be ours alone
                self.sanitizer.check_write(
                    self.pool, st.pages[(st.length - 1) // self.page_size])

    def _cow_before_write(self, st: SeqState) -> None:
        """The token just appended will be WRITTEN (by the next decode step)
        at position ``st.length - 1``. If that write lands in a page another
        mapping still references, duplicate first — or steal the page back
        from the prefix index when the index is its only other owner."""
        li = (st.length - 1) // self.page_size
        pg = st.pages[li]
        if not self.pool.is_shared(pg):
            return
        if self.prefix is not None and \
                self.prefix.try_release_for_write(pg, self.pool):
            return                           # reclaimed: write in place
        dst = self._alloc_evicting(1)[0]
        self.pending_cow.append((pg, dst))   # device copies src -> dst
        st.pages[li] = dst
        self.tables[st.slot, li] = dst
        self.pool.free([pg])                 # drop OUR ref; sharers keep it  # svalint: disable=R002
        self.pool.stats.cow_copies += 1
        self.dirty_rows.add(st.slot)
        self.sva_stats.table_entries_written += 1
        self.iommu.space(st.slot).remap(li, dst)

    def drain_cow_copies(self) -> List[Tuple[int, int]]:
        """(src, dst) physical page copies the device must perform before
        the next decode step reads/writes the duplicated pages."""
        out = self.pending_cow
        self.pending_cow = []
        return out

    def release(self, seq_id: int) -> None:
        """Drop the sequence's OWN page references. Pages also registered in
        the prefix index keep the index's reference and live on as the warm
        prefix cache (evicted LRU under page pressure)."""
        st = self.seqs.pop(seq_id)
        free_pool = (self.pool if self.layout == "global"
                     else self.pools[st.slot])
        snap = (self.sanitizer.snapshot_rc(free_pool, st.pages)
                if self.sanitizer is not None else None)
        free_pool.free(st.pages)  # svalint: disable=R002
        self.free_slots.append(st.slot)
        self.lengths[st.slot] = 0
        if self.layout == "global":
            self.tables[st.slot] = self.null_page
        self.sva_stats.unmap_calls += 1
        # self-invalidation: ONLY this slot's translations die (the Listing-1
        # full flush is invalidate_epoch)
        self.iommu.detach(st.slot)
        self.dirty_rows.add(st.slot)
        if self.sanitizer is not None:
            # every reference the sequence held must actually be gone
            self.sanitizer.check_release(free_pool, seq_id, st.pages, snap)

    # ------------------------------------------------- preemption (continuous)
    def register_progress(self, seq_id: int, tokens: Sequence[int],
                          computed: int) -> None:
        """Register a lazily-admitted prompt's COMPUTED pages in the prefix
        index (the chunked-prefill counterpart of the registration eager
        ``admit`` does up front). Called by the engine after each chunk's
        KV lands, so the index only ever references resident KV. Idempotent
        per page — each chunk re-walks the already-registered prefix and
        adds only its own new pages (plus the partial tail on the final
        chunk, exactly like eager registration)."""
        if self.prefix is None:
            return
        st = self.seqs[seq_id]
        toks = [int(t) for t in tokens[:computed]]
        n = -(-computed // self.page_size)
        self.prefix.register(toks, st.pages[:n], self.pool,
                             tenant=st.tenant)
        self.prefix.enforce_cap(self.pool)
        self._enforce_tenant_prefix_caps()

    def preempt(self, seq_id: int, resident_tokens:
                Optional[Sequence[int]] = None) -> None:
        """Evict a live sequence under pool pressure: release its slot,
        pages, and ASID exactly like :meth:`release` — but FIRST register
        its computed KV (``resident_tokens``: every token whose KV is
        actually written — the scheduler passes prompt+generated minus the
        one pending token, or the computed chunk prefix mid-prefill) in the
        prefix index. A prompt-sharing resume then re-matches those warm
        pages and skips their recompute entirely; under continued pressure
        they are ordinary evictable cache entries. The sanitizer sees the
        same snapshot/release discipline as a completion."""
        if self.layout != "global":
            raise ValueError("preemption requires the global layout")
        st = self.seqs.pop(seq_id)
        if self.prefix is not None and resident_tokens:
            toks = [int(t) for t in resident_tokens]
            n = -(-len(toks) // self.page_size)
            self.prefix.register(toks, st.pages[:n], self.pool,
                                 tenant=st.tenant)
        snap = (self.sanitizer.snapshot_rc(self.pool, st.pages)
                if self.sanitizer is not None else None)
        self.pool.free(st.pages)  # svalint: disable=R002
        self.free_slots.append(st.slot)
        self.lengths[st.slot] = 0
        self.tables[st.slot] = self.null_page
        self.sva_stats.unmap_calls += 1
        self.preemptions += 1
        self.iommu.detach(st.slot)
        self.dirty_rows.add(st.slot)
        if self.sanitizer is not None:
            self.sanitizer.check_release(self.pool, seq_id, st.pages, snap)

    def resume(self, seq_id: int, prompt_len: int, max_tokens: int,
               tokens: Optional[Sequence[int]] = None,
               tenant: Optional[str] = None) -> Optional[SeqState]:
        """Re-admit a preempted sequence. The caller passes every
        KV-resident token it had as the new prompt (with ``max_tokens``
        rebased to the remaining budget); with ``tokens`` the prefix index
        re-matches the pages :meth:`preempt` registered — a warm resume
        costs one recomputed token — and without a match the KV is
        recomputed from tokens. Either way this is a fresh lazy admission:
        new slot, new ASID, new pages (owned by the same tenant)."""
        st = self.admit(seq_id, prompt_len, max_tokens, tokens=tokens,
                        lazy=True, tenant=tenant)
        if st is not None:
            self.resumes += 1
        return st

    # -------------------------------------------- disaggregated migration
    def reserve_slots(self, slots: Sequence[int]) -> None:
        """Withhold slots from ``admit``/``resume`` so a disaggregated
        front-end can dedicate them to a decode worker: migration targets
        them explicitly via :meth:`migrate`, admission never sees them."""
        for s in slots:
            if any(st.slot == s for st in self.seqs.values()):
                raise ValueError(f"slot {s} is occupied; cannot reserve")
            if s in self.free_slots:
                self.free_slots.remove(s)

    def migrate(self, seq_id: int, dst_slot: int, mode: str = "share",
                xfer_iommu: Optional[IOMMU] = None) -> SeqState:
        """Move a sequence's KV pages from its current ASID to ``dst_slot``
        over the shared pool — the single-process model of a prefill worker
        handing a finished prompt's KV to a decode worker by remote DMA.

        The hand-off is priced through the SVA layer: the SOURCE ASID
        translates every resident page (through ``xfer_iommu`` — the
        transfer fabric's IOMMU, e.g. a 4-entry IOTLB over ``Sv39Walk`` —
        or the manager's own when none is given), accumulating PTW/IOTLB
        cost in :class:`TransferStats`. Then either

        * ``mode="share"``: zero-copy re-attachment — ``PagePool.share``
          bumps every page's refcount before the source reference drops, so
          the physical pages never transit free and the decode side maps
          the SAME pages (only table entries move: ``table_bytes``); or
        * ``mode="copy"``: fresh pages are allocated for the decode side
          and queued on ``pending_cow`` for the engine's device-side
          batched copy (``payload_bytes`` = full KV payload). The copy is
          priced but the source pages are freed immediately — the engine
          MUST drain ``pending_cow`` before anything reallocates them.

        Source teardown and destination attach follow the exact
        release/admit discipline (snapshot + ``check_release``, per-ASID
        invalidation, delta-row dirtying), so migration is svasan-clean by
        construction. Raises ``OutOfPages`` (copy mode, nothing mutated)
        when the pool cannot back the duplicate — callers defer the
        transfer and retry."""
        if self.layout != "global":
            raise ValueError("migration requires the global layout")
        if mode not in ("share", "copy"):
            raise ValueError(f"mode={mode!r} (expected 'share' or 'copy')")
        st = self.seqs[seq_id]
        src_slot = st.slot
        if dst_slot == src_slot:
            raise ValueError(f"seq {seq_id} already occupies slot {dst_slot}")
        if any(s.slot == dst_slot for s in self.seqs.values()):
            raise ValueError(f"destination slot {dst_slot} is occupied")
        n = len(st.pages)
        # Copy mode allocates FIRST so OutOfPages leaves nothing mutated.
        if mode == "copy":
            new_pages = self._alloc_evicting(n, run=True)
        ts = self.transfer_stats
        # --- price the hand-off: source ASID translates every page through
        # the transfer fabric's IOMMU (remote DMA by virtual address).
        iommu = xfer_iommu if xfer_iommu is not None else self.iommu
        external = xfer_iommu is not None and xfer_iommu is not self.iommu
        if external:
            sp = iommu.space(src_slot)
            if sp is None:
                sp = iommu.attach(src_slot)
            # cold install: the fabric walks page tables it has never seen
            for lp, pp in enumerate(st.pages):
                sp.table[lp] = pp
        before = iommu.stats()["tlb"]
        for lp in range(n):
            # the hand-off DMA runs under the sequence's tenant identity
            _, cost, _ = iommu.translate(src_slot, lp, tenant=st.tenant)
            ts.ptw_cycles += cost
        after = iommu.stats()["tlb"]
        for k, attr in (("hits", "tlb_hits"), ("misses", "tlb_misses"),
                        ("prefetch_issued", "prefetch_issued"),
                        ("prefetch_useful", "prefetch_useful"),
                        ("prefetch_late", "prefetch_late")):
            setattr(ts, attr, getattr(ts, attr) + after[k] - before[k])
        if external:
            iommu.detach(src_slot)           # the fabric window closes
        ts.transfers += 1
        ts.table_bytes += n * 4              # int32 table entries handed off
        # --- hand off the physical pages.
        if mode == "share":
            # refcount++ BEFORE the source drop: pages never transit free
            self.pool.share(st.pages)  # svalint: disable=R002
            new_pages = list(st.pages)
            ts.pages_shared += n
        else:
            self.pending_cow.extend(zip(st.pages, new_pages))
            ts.pages_copied += n
            ts.payload_bytes += n * self.page_size * self.kv_bytes_per_token
        # --- source teardown: exactly the release discipline.
        snap = (self.sanitizer.snapshot_rc(self.pool, st.pages)
                if self.sanitizer is not None else None)
        src_pages = list(st.pages)
        self.pool.free(src_pages)  # svalint: disable=R002
        self.free_slots.append(src_slot)
        self.lengths[src_slot] = 0
        self.tables[src_slot] = self.null_page
        self.sva_stats.unmap_calls += 1
        self.iommu.detach(src_slot)
        self.dirty_rows.add(src_slot)
        if self.sanitizer is not None:
            self.sanitizer.check_release(self.pool, seq_id, src_pages, snap)
        # --- destination attach: exactly the admit discipline, targeting
        # the (possibly reserved) decode-side slot explicitly.
        if dst_slot in self.free_slots:
            self.free_slots.remove(dst_slot)
        st.slot = dst_slot
        st.pages = new_pages
        row = np.full((self.max_pages,), self.null_page, np.int32)
        row[:n] = new_pages
        self.tables[dst_slot] = row
        self.lengths[dst_slot] = st.length
        self.dirty_rows.add(dst_slot)
        self.sva_stats.map_calls += 1
        self.sva_stats.table_entries_written += n
        self.sva_stats.bytes_mapped += st.length * self.kv_bytes_per_token
        # the decode-side ASID keeps the sequence's tenant ownership
        self.iommu.attach(dst_slot, tenant=st.tenant).map(new_pages)
        return st

    def free_page_headroom(self) -> int:
        """Pages an allocation could obtain RIGHT NOW: free pages plus warm
        prefix-cache pages the index solely owns (``_alloc_evicting``
        reclaims those one eviction at a time). The scheduler compares this
        against :meth:`next_step_page_demand` to decide preemption and
        admission."""
        free = self.pool.n_free
        if self.prefix is not None:
            free += self.prefix.evictable_pages(self.pool)
        return free

    def next_step_page_demand(self) -> int:
        """Upper bound on pages the NEXT step's appends can allocate: one
        per live sequence whose next token write either crosses into an
        unallocated page (lazy-admission growth) or lands in a shared page
        (CoW duplication — counted even when a steal would avoid the
        allocation, so the bound stays conservative)."""
        demand = 0
        for st in self.seqs.values():
            if st.done:
                continue
            li = st.length // self.page_size
            if li >= len(st.pages):
                if len(st.pages) < self.max_pages:
                    demand += 1
            elif self.pool.is_shared(st.pages[li]):
                demand += 1
        return demand

    def observe_step(self) -> None:
        """Advance per-step online controllers (currently the prefix-cache
        cap tuner). The engine calls this once per decode step."""
        if self.prefix_tuner is not None:
            self.prefix_tuner.observe_step()

    # ------------------------------------------------------------ device view
    def delta_rows(self) -> List[int]:
        """Slot rows whose tables changed since last upload (delta upload —
        the serving-level analogue of a warm IOTLB)."""
        rows = sorted(self.dirty_rows)
        self.dirty_rows.clear()
        return rows

    def invalidate_epoch(self) -> None:
        """Full translation flush (paper Listing 1): the next device upload
        must re-send every table row."""
        self.iommu.invalidate()              # bumps the epoch exactly once
        self.dirty_rows.update(range(self.n_slots))

    def translate_step(self, resident: Optional[Dict[int, int]] = None
                       ) -> List[Tuple[int, int, int]]:
        """Run one decode step's page accesses through the IOMMU (ASID ==
        slot): every live sequence gathers its resident KV pages. Returns
        the (slot, logical_page, physical_page) access list — the serving
        hot path's translation trace, countable live (``CountingWalk``) or
        replayable through ``Sv39Walk`` for modeled PTW cost.

        ``resident`` (continuous batching) overrides the per-sequence
        resident-token count by seq_id: a mid-prefill sequence has KV for
        its computed chunks only, not ``SeqState.length`` (= the full
        prompt), so the step must not translate — or charge PTW cost for —
        pages no access touches yet."""
        out: List[Tuple[int, int, int]] = []
        for st in self.seqs.values():
            if st.done:
                continue
            toks = (st.length if resident is None
                    else resident.get(st.seq_id, st.length))
            n = min(-(-toks // self.page_size), len(st.pages))
            for lp in range(n):
                # the gather runs under the sequence's tenant identity, so
                # the live hot path exercises the isolation gate every step
                phys, _, _ = self.iommu.translate(st.slot, lp,
                                                  tenant=st.tenant)
                out.append((st.slot, lp, phys))
        if self.autotuner is not None:
            self.autotuner.observe_step()
        return out

    def device_tables(self) -> np.ndarray:
        return self.tables.copy()

    def device_lengths(self) -> np.ndarray:
        return self.lengths.copy()

    def active_seqs(self) -> List[SeqState]:
        return [s for s in self.seqs.values() if not s.done]

    def stats(self) -> dict:
        pools = [self.pool] if self.layout == "global" else self.pools
        used = sum(p.n_used for p in pools)
        free = sum(p.n_free for p in pools)
        high = sum(p.stats.high_water for p in pools)
        util = (sum(p.utilization * p.n_pages for p in pools)
                / max(sum(p.n_pages for p in pools), 1))
        io = self.iommu.stats()
        iommu_block = {"walk": io["walk"], "epoch": io["epoch"],
                       "asids": io["asids"],
                       "tlb_entries": self.iommu.tlb_config.n_entries,
                       "tlb_ways": self.iommu.tlb_config.resolved_ways,
                       "tlb_policy": self.iommu.tlb_config.policy}
        if self.autotuner is not None:
            iommu_block["autotune"] = self.autotuner.stats()
        if "range" in io:
            iommu_block["range"] = io["range"]
        out = {"sva": self.sva_stats.as_dict(),
               "tlb": io["tlb"],
               "iommu": iommu_block,
               "pool_used": used,
               "pool_free": free,
               "pool_high_water": high,
               "pool_utilization": round(util, 4),
               "pool_shares": sum(p.stats.shares for p in pools),
               "pool_run_allocs": sum(p.stats.run_allocs for p in pools),
               "pool_run_fallbacks": sum(p.stats.run_fallbacks
                                         for p in pools),
               "cow_copies": sum(p.stats.cow_copies for p in pools),
               "preemptions": self.preemptions,
               "resumes": self.resumes}
        if self.prefix is not None:
            out["prefix"] = {**self.prefix.stats.as_dict(),
                             "cached_pages": self.prefix.n_cached_pages,
                             "policy": self.prefix.policy,
                             "max_pages": self.prefix.max_pages}
            if self.prefix_tuner is not None:
                out["prefix"]["tuner"] = self.prefix_tuner.stats()
        if self.tenant_specs:
            io_tenant = io.get("tenant", {})
            prefix_by_tenant = (self.prefix.cached_pages_by_tenant()
                                if self.prefix is not None else {})
            tenant = {}
            for name, spec in sorted(self.tenant_specs.items()):
                blk = dict(
                    seqs=sum(1 for st in self.seqs.values()
                             if st.tenant == name),
                    pages_used=self.tenant_pages_used(name),
                    quota_pages=spec.get("quota_pages", 0),
                    prefix_pages=prefix_by_tenant.get(name, 0),
                    quota_prefix_pages=spec.get("quota_prefix_pages", 0))
                blk.update(io_tenant.get(name, {}))
                tenant[name] = blk
            out["tenant"] = tenant
        if self.transfer_stats.transfers:
            out["transfer"] = self.transfer_stats.as_dict()
        if self.sanitizer is not None:
            out["svasan"] = self.sanitizer.stats()
        return out
