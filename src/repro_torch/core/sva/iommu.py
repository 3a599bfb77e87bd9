"""Unified IOMMU front-end — ONE translation API for the performance
simulator, the SVA mapping layer, and the serving engine.

The paper's central object is an IOMMU with an IOTLB, a multi-level
page-table walker, and LLC-aware walk costs. This module is its single
implementation; everything else is a client:

  * the simulator's :class:`~repro_torch.core.simulator.platform.MemorySystem`
    delegates translation to ``IOMMU(walk_model=Sv39Walk(...),
    tlb=TLBConfig(4))`` — the paper's 4-entry hardware IOTLB over the
    3-level sequential Sv39 walk with Listing-1 LLC warming;
  * :class:`~repro_torch.core.sva.mapping.SVASpace` attaches one
    :class:`IOAddressSpace` per mapping handle (PASID-style);
  * :class:`~repro_torch.core.sva.kv_manager.PagedKVManager` attaches one
    address space per batch slot and runs the decode hot path's page
    accesses through a ``CountingWalk`` IOMMU with a large TLB — the
    delta-upload cache and the hardware IOTLB are the same class
    configured differently.

Design-space axes (Kim et al., "Address Translation Design Tradeoffs for
Heterogeneous Systems"): TLB size, set associativity, and replacement
policy (``TLBConfig(n_entries, policy, ways=...)`` — lru | fifo | lfu |
random | gdsfs, ways=0 fully associative), walker cost model
(``WalkModel``), and the walker's non-leaf PTE walk cache
(``WalkCacheConfig``) are independently pluggable, so the same traffic can
be priced as pure stats (``CountingWalk``) or as modeled Sv39 cycles
with/without the shared LLC and with/without a hardware walk cache
(``Sv39Walk``). ``benchmarks/tlb_sweep.py`` sweeps these axes over
recorded serving traces.

Range-coalesced IOTLB entries (``TLBConfig(ranges=N)``, SPARTA-style,
PAPERS.md): when the page table shows a physically contiguous run around
a translation, ONE entry ``(asid, base_lpn, n_pages) -> base_ppn`` covers
up to N pages — installed opportunistically at map-time pre-warm and on
demand-miss fills, weighted ``span=n_pages`` under gdsfs, set-indexed on
``base_lpn``. Invalidation is range-granular: a partial unmap or CoW
remap SPLITS a covering range into its surviving segments (a range entry
never outlives a split; the svasan stale-range detector checks exactly
this). Resident ranges are kept disjoint, so a lookup has at most one
covering entry. ``ranges=0`` (default) is bit-identical to the per-page
front-end; coalescing changes translation accounting only, never data
movement. Counters land in the ``range:`` stats block.

Adaptive front-end (this is where the design space stops being static):

  * ``PrefetchConfig(policy="none|next_page|stream", degree, distance)``
    arms an IOTLB prefetcher modeled after Kurth et al.'s MMU-aware DMA
    engine: demand traffic predicts upcoming logical pages and issues
    walk-model fills for them off the demand path. Prefetched fills
    *complete* at the next demand translate — a demand that arrives while
    its prefetch is still in flight is a *late* prefetch and pays the full
    walk cost (conservative: no partial-latency credit). A prefetch NEVER
    fabricates a translation: for an attached address space only pages
    present in its table are prefetched (holes are skipped cleanly);
    unattached ASIDs prefetch identity, exactly like demand translation.
    Counters (``prefetch_issued/useful/late``) live in ``TLBStats``.
  * ``AutoTuneConfig(interval_steps, candidates)`` + :class:`TLBAutoTuner`
    retune the TLB geometry online: every ``interval_steps`` decode steps
    the tuner reads the live hit-rate/conflict-miss window, explores each
    candidate geometry for one window, then exploits the best (re-exploring
    when the exploit hit rate sags). A switch is a real hardware resize:
    :meth:`IOMMU.reconfigure_tlb` flushes every translation and bumps the
    epoch (the next serving table upload must be full); cumulative stats
    carry across so the ``tlb:`` schema stays monotonic.

Multi-tenant domains (the MMU-partitioning / execution-domain axis —
"Address Translation Design Tradeoffs for Heterogeneous Systems" +
bus-firewall execution domains): a :class:`TenantDomain` groups ASIDs
under one named tenant. Ownership is established at :meth:`IOMMU.attach`
(``attach(asid, tenant=...)``) and enforced on EVERY translation — a
translate on behalf of one tenant for an ASID another tenant owns raises
a structured :class:`IsolationError` before any TLB state is touched, so
range entries and prefetch fills can never leak across the boundary
(they are keyed by ASID, and the ASID's owner is checked first).
``TLBConfig(partitions={tenant: ways})`` additionally way-partitions the
IOTLB so one tenant's thrash cannot evict another's entries; per-tenant
``tlb:`` stats (including a tenant-local ``conflict_misses``) land in the
``tenant:`` stats block, which — like ``range:`` — only appears once a
tenant is registered.

Stats schema (``IOMMU.stats()``; see ARCHITECTURE.md): ``tlb:``
(``TLBStats.as_dict``), ``walk:`` (model name, walks, cycles, plus
``walk_cache:`` and ``prefetch:`` blocks when configured), ``epoch``,
``asids``.

No module outside this one constructs a raw
:class:`~repro_torch.core.sva.tlb.TranslationCache`.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import (TYPE_CHECKING, Dict, Iterable, List, Optional, Protocol,
                    Sequence, Tuple, runtime_checkable)

import numpy as np

from repro_torch.core.sva.tlb import POLICIES, TLBStats, TranslationCache

if TYPE_CHECKING:                                  # pragma: no cover
    from repro_torch.core.sva.sanitizer import SVASanitizer


@dataclass(frozen=True)
class TLBConfig:
    """IOTLB geometry + replacement policy (the translation design space).

    ``ways`` is the set associativity: 0 (or ``n_entries``) is fully
    associative — one set, bit-identical to the historical behavior; any
    proper divisor of ``n_entries`` splits the cache into
    ``n_entries // ways`` sets indexed on the logical page, with per-set
    replacement state and conflict-miss accounting.

    ``partitions`` way-partitions the cache between tenants: a mapping
    (or tuple of pairs — normalized, so configs stay hashable for the
    auto-tuner's equality checks) ``tenant -> private ways per set``.
    Leftover ways form the shared pool for un-partitioned traffic; the
    empty default is bit-identical to the unpartitioned cache."""
    n_entries: int = 4096
    policy: str = "lru"           # lru | fifo | lfu | random
    seed: int = 0                 # random-policy determinism (trace parity)
    ways: int = 0                 # 0 = fully associative (== n_entries)
    ranges: int = 0               # max pages one range entry may coalesce
                                  # (0 = per-page entries only; >= 2 arms
                                  # SPARTA-style range coalescing)
    partitions: Tuple[Tuple[str, int], ...] = ()  # tenant -> ways per set

    def __post_init__(self):
        if self.n_entries < 1:
            raise ValueError(f"n_entries={self.n_entries} (need >= 1)")
        if self.policy not in POLICIES:
            raise ValueError(
                f"policy={self.policy!r} (expected one of {POLICIES})")
        ways = self.ways or self.n_entries
        if ways < 1 or ways > self.n_entries or self.n_entries % ways:
            raise ValueError(
                f"ways={self.ways} must divide n_entries={self.n_entries} "
                f"(1 <= ways <= n_entries; 0 = fully associative)")
        if self.ranges < 0 or self.ranges == 1:
            raise ValueError(
                f"ranges={self.ranges} (0 = off, else the max coalesced "
                "run length, >= 2)")
        if isinstance(self.partitions, dict):
            object.__setattr__(self, "partitions",
                               tuple(sorted(self.partitions.items())))
        else:
            object.__setattr__(self, "partitions",
                               tuple(tuple(p) for p in self.partitions))
        names = [t for t, _ in self.partitions]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate tenant in partitions={names}")
        for t, w in self.partitions:
            if not isinstance(t, str) or not t:
                raise ValueError(f"partition tenant {t!r} must be a "
                                 "non-empty string")
            if w < 1:
                raise ValueError(f"partition {t!r}: ways={w} (need >= 1)")
        reserved = sum(w for _, w in self.partitions)
        if reserved > ways:
            raise ValueError(
                f"partitions reserve {reserved} ways but the TLB has "
                f"{ways} per set")

    @property
    def resolved_ways(self) -> int:
        return self.ways or self.n_entries

    @property
    def n_sets(self) -> int:
        return self.n_entries // self.resolved_ways

    @property
    def partition_dict(self) -> Dict[str, int]:
        return dict(self.partitions)


@dataclass(frozen=True)
class WalkCacheConfig:
    """Geometry of the walker's page-table-walk cache: a small on-IOMMU
    cache of NON-LEAF PTE lines (hardware MMU walk caches), so a hit skips
    the upper-level accesses of a walk. ``n_entries == 0`` disables it —
    the default, bit-identical to the historical 3-sequential-access
    walker."""
    n_entries: int = 0            # 0 = walk cache disabled
    ways: int = 0                 # 0 = fully associative
    policy: str = "lru"           # lru | fifo | lfu | random
    seed: int = 0

    def __post_init__(self):
        if self.n_entries < 0:
            raise ValueError(f"n_entries={self.n_entries} (need >= 0)")
        if self.policy not in POLICIES:
            raise ValueError(
                f"policy={self.policy!r} (expected one of {POLICIES})")
        if self.n_entries:
            ways = self.ways or self.n_entries
            if ways < 1 or ways > self.n_entries or self.n_entries % ways:
                raise ValueError(
                    f"ways={self.ways} must divide n_entries="
                    f"{self.n_entries} (0 = fully associative)")


PREFETCH_POLICIES = ("none", "next_page", "stream")

#: accesses in a row with stride +1 before the stream prefetcher engages
STREAM_THRESHOLD = 2


@dataclass(frozen=True)
class PrefetchConfig:
    """IOTLB prefetcher knobs (Kurth et al., MMU-aware DMA prefetching).

    ``none``       disabled — bit-identical to the pre-prefetch front-end.
    ``next_page``  on a demand MISS at logical page p, issue fills for
                   ``p+1 .. p+degree`` (the classic next-line prefetch).
    ``stream``     per-ASID +1-stride detector: once ``STREAM_THRESHOLD``
                   sequential accesses are seen, keep a run-ahead window of
                   ``distance`` pages beyond the demand page, issuing at
                   most ``degree`` fills per access (hits trigger too, so
                   the prefetcher runs ahead of a streaming DMA instead of
                   reacting to its misses).

    ``degree`` bounds fills per trigger; ``distance`` how far past the
    demand page the stream window reaches (only ``stream`` uses it)."""
    policy: str = "none"
    degree: int = 2
    distance: int = 4

    def __post_init__(self):
        if self.policy not in PREFETCH_POLICIES:
            raise ValueError(f"policy={self.policy!r} "
                             f"(expected one of {PREFETCH_POLICIES})")
        if self.degree < 1:
            raise ValueError(f"degree={self.degree} (need >= 1)")
        if self.distance < 1:
            raise ValueError(f"distance={self.distance} (need >= 1)")

    @property
    def enabled(self) -> bool:
        return self.policy != "none"


@dataclass(frozen=True)
class AutoTuneConfig:
    """Online TLB-geometry auto-tuner knobs.

    Every ``interval_steps`` observed decode steps the tuner closes a
    measurement window over the live TLB stats (hit-rate delta, conflict
    misses). It explores each candidate geometry for one window, then
    settles on the best (highest window hit rate; ties prefer fewer
    conflict misses, then fewer entries, then earlier candidates) and
    re-explores when the exploit
    window's hit rate drops more than ``retune_margin`` below the best
    explored value. Windows with fewer than ``min_accesses`` demand
    accesses are ignored (idle engine)."""
    interval_steps: int = 32
    candidates: Tuple[TLBConfig, ...] = ()
    min_accesses: int = 1
    retune_margin: float = 0.05

    def __post_init__(self):
        if self.interval_steps < 1:
            raise ValueError(
                f"interval_steps={self.interval_steps} (need >= 1)")
        if not self.candidates:
            raise ValueError("candidates must name at least one TLBConfig")
        if self.min_accesses < 1:
            raise ValueError(f"min_accesses={self.min_accesses} (need >= 1)")
        if not 0.0 <= self.retune_margin <= 1.0:
            raise ValueError(
                f"retune_margin={self.retune_margin} (need 0..1)")


def default_autotune_candidates(base: TLBConfig) -> Tuple[TLBConfig, ...]:
    """A small entries ladder around ``base`` (same ways/policy): the
    default candidate set when a deployment turns auto-tuning on without
    naming geometries."""
    entries = sorted({max(4, base.n_entries // 16),
                      max(4, base.n_entries // 4), base.n_entries})
    out = []
    for e in entries:
        ways = base.ways if base.ways and e % base.ways == 0 else 0
        out.append(TLBConfig(e, base.policy, seed=base.seed, ways=ways,
                             ranges=base.ranges))
    return tuple(out)


@dataclass
class WalkStats:
    walks: int = 0                # page-table walks performed
    cycles: float = 0.0           # total modeled walk cost (model's units)

    def as_dict(self):
        return dict(walks=self.walks, cycles=round(self.cycles, 3))


@runtime_checkable
class WalkModel(Protocol):
    """Prices one page-table walk; the *value* of a translation always comes
    from the owning :class:`IOAddressSpace`'s table, never from the model."""

    name: str
    stats: WalkStats

    def walk(self, asid: int, page: int,
             vpn: Optional[int] = None) -> float:
        """Cost of a full walk for ``page`` (physical id). ``vpn`` is the
        VIRTUAL (logical) page the walk resolves — walk caches tag on it,
        like hardware; defaults to ``page`` for identity-translating
        callers. Returns cycles."""
        ...

    def host_map_pass(self, pages: Iterable[int]) -> None:
        """Host creates IO mappings right before offload (paper Listing 1);
        cost models may warm PTE state (LLC residency)."""
        ...


class CountingWalk:
    """Pure-stats walker (zero cost) — the serving engine's live-traffic
    hit/miss/walk counter."""

    name = "counting"

    def __init__(self):
        self.stats = WalkStats()

    def walk(self, asid: int, page: int,
             vpn: Optional[int] = None) -> float:
        self.stats.walks += 1
        return 0.0

    def host_map_pass(self, pages: Iterable[int]) -> None:
        return None


class Sv39Walk:
    """The 3-level sequential-access RISC-V Sv39 walk cost model (paper
    Fig. 5), lifted out of the simulator's ``MemorySystem.ptw_cost_accel``.

    The 128 KiB shared LLC caches ONLY host + PTW traffic: the Listing-1
    ``host_map_pass`` fills PTE cache lines (8 PTEs of 8 B per 64 B line),
    so leaf PTEs are LLC-resident at offload time. ``host_interference``
    adds the Fig.-5 concurrent-traffic eviction probability on top of the
    baseline ``pte_evict_prob`` (LLC shared with OS data between map and
    use). Costs are returned in ``dram_access_cycles``'s clock domain
    scaled by ``to_accel`` (the simulator passes host->accelerator H2A).
    """

    name = "sv39"

    def __init__(self, levels: int = 3, dram_access_cycles: float = 235.0,
                 llc: bool = False, llc_hit_cycles: float = 10.0,
                 pte_evict_prob: float = 0.10, host_interference: float = 0.0,
                 to_accel: float = 1.0, seed: int = 0,
                 walk_cache: Optional[WalkCacheConfig] = None):
        self.levels = levels
        self.dram_access_cycles = dram_access_cycles
        self.llc = llc
        self.llc_hit_cycles = llc_hit_cycles
        self.pte_evict_prob = pte_evict_prob
        self.host_interference = host_interference
        self.to_accel = to_accel
        self.llc_resident: set = set()      # PTE line ids resident in LLC
        self._rng = np.random.default_rng(seed)
        self.stats = WalkStats()
        # Optional hardware walk cache over NON-LEAF PTEs: a hit at depth d
        # skips the accesses of levels 0..d (they resolve from on-IOMMU
        # SRAM). Disabled (None) reproduces the plain sequential walker.
        self.walk_cache_config = walk_cache
        self.walk_cache: Optional[TranslationCache] = None
        if walk_cache is not None and walk_cache.n_entries:
            self.walk_cache = TranslationCache(  # svalint: disable=R001
                walk_cache.n_entries, policy=walk_cache.policy,
                seed=walk_cache.seed, ways=walk_cache.ways)

    def host_map_pass(self, pages: Iterable[int]) -> None:
        if self.llc:
            for p in set(pages):
                self.llc_resident.add(p // 8)

    def _wc_key(self, asid: int, vpn: int, level: int) -> Tuple[int, ...]:
        """Walk-cache tag for the non-leaf PTE covering VIRTUAL page
        ``vpn`` at ``level``: the page table is indexed by VA, and Sv39
        resolves 9 page-number bits per level, so the level-d entry covers
        ``vpn >> 9*(levels-1-d)``."""
        return (asid, level, vpn >> (9 * (self.levels - 1 - level)))

    def walk(self, asid: int, page: int,
             vpn: Optional[int] = None,
             wc_sink: Optional[list] = None) -> float:
        """One full page-table walk: up to ``levels`` sequential accesses.
        A walk-cache hit on a non-leaf PTE (tagged on ``vpn``, the virtual
        page being resolved) skips every level above it. Upper levels are
        few enough to stay LLC-cached; the leaf PTE line is LLC-cached iff
        the map pass (or a previous walk's refill) warmed it and no
        eviction hit it since — a rolled eviction drops the line, and the
        walk's DRAM refill re-installs it.

        ``wc_sink`` (prefetch walks) defers walk-cache installs: the
        non-leaf keys this walk read are appended to the sink instead of
        filled, so the caller can install them when the in-flight walk
        actually completes (``IOMMU._install_pending``). The cache is still
        PROBED — an in-flight prefetch rides the same hardware walker."""
        vpn = page if vpn is None else vpn
        total_host = 0.0
        evict_p = self.pte_evict_prob + self.host_interference
        start_level = 0
        if self.walk_cache is not None:
            # Probe deepest non-leaf entry first (hardware walk caches
            # resolve the longest cached prefix).
            for level in range(self.levels - 2, -1, -1):
                _, hit = self.walk_cache.lookup(self._wc_key(asid, vpn,
                                                             level))
                if hit:
                    start_level = level + 1
                    break
        for level in range(start_level, self.levels):
            leaf = level == self.levels - 1
            line = page // 8 if leaf else -level
            cached = self.llc and (not leaf or line in self.llc_resident)
            if cached and leaf and self._rng.random() < evict_p:
                # PTE line evicted between map and walk: it leaves the LLC
                # (the refill below re-warms it after the walk completes)
                self.llc_resident.discard(line)
                cached = False
            total_host += (self.llc_hit_cycles if cached
                           else self.dram_access_cycles)
            if not leaf and self.walk_cache is not None:
                # the walker read this non-leaf PTE: install it (not a
                # device walk of its own — never counts in wc walk stats)
                key = self._wc_key(asid, vpn, level)
                if wc_sink is None:
                    self.walk_cache.fill(key, 1, walked=False)
                else:
                    wc_sink.append(key)
        if self.llc:
            # The walk's leaf access leaves the PTE line LLC-resident: a
            # hit keeps it, a miss's DRAM refill installs it.
            self.llc_resident.add(page // 8)
        cost = total_host * self.to_accel
        self.stats.walks += 1
        self.stats.cycles += cost
        return cost

    def prefetch_walk(self, asid: int, page: int,
                      vpn: Optional[int] = None) -> Tuple[float, tuple]:
        """Walk on behalf of a PREFETCH: identical probing and cost to a
        demand walk, but the non-leaf PTE lines it read are RETURNED
        instead of installed — the walk is in flight until the prefetch
        completes, so the IOMMU installs the lines (and counts them as
        ``walk_cache_prefills``) at completion time. Returns
        ``(cost, non_leaf_keys)``."""
        lines: list = []
        cost = self.walk(asid, page, vpn=vpn, wc_sink=lines)
        return cost, tuple(lines)


class IOAddressSpace:
    """A PASID-style per-process/per-request address space: a logical->
    physical page table plus the translation verbs over it. Obtained via
    :meth:`IOMMU.attach`; all TLB state lives in the owning IOMMU (shared,
    keyed ``(asid, logical_page)``)."""

    def __init__(self, iommu: "IOMMU", asid: int):
        self.iommu = iommu
        self.asid = asid
        self.table: Dict[int, int] = {}
        # True once a TLB entry exists for a page NOT in the table (identity
        # fallback / caller-supplied phys): detach must then fall back to a
        # full-ASID scan instead of the O(mapped pages) table walk.
        self._untracked_fills = False

    # ------------------------------------------------------------- mapping
    def map(self, pages: Sequence[int], start: int = 0,
            warm: bool = True) -> None:
        """Install logical pages ``[start, start+len)`` -> ``pages`` and run
        the Listing-1 host map pass (PTE writes land in the LLC). ``warm``
        additionally pre-fills the device TLB (the driver's map-then-offload
        pattern leaves translations hot) — with range coalescing armed,
        physically contiguous chunks warm as single range entries."""
        for lp, pp in enumerate(pages, start=start):
            self.table[lp] = pp
        if warm:
            if self.iommu.range_max:
                self.iommu._warm_fill_runs(self.asid, start, pages)
            else:
                for lp, pp in enumerate(pages, start=start):
                    # host pre-warm, NOT a device page-table walk
                    self.iommu.tlb.fill((self.asid, lp), pp, walked=False)
        self.iommu.host_map_pass(pages)

    def extend(self, pages: Sequence[int]) -> None:
        """Grow the mapping (decode appends crossing a page boundary).
        Appends past the HIGHEST live logical page — ``len(self.table)``
        would collide with live pages after a partial ``unmap()`` (holes
        shrink the table but not the address range) and silently remap
        them."""
        start = max(self.table) + 1 if self.table else 0
        self.map(pages, start=start)

    def remap(self, lp: int, pp: int) -> None:
        """Point one logical page at a new physical page (CoW divergence):
        the stale translation self-invalidates, the new one is warmed.
        Routed through the IOMMU's page invalidation so an IN-FLIGHT
        prefetch of the old translation dies too — otherwise its delayed
        install would overwrite the fresh post-CoW fill with the stale
        physical page."""
        self.table[lp] = pp
        self.iommu.invalidate(pages=[(self.asid, lp)])
        self.iommu.tlb.fill((self.asid, lp), pp, walked=False)
        self.iommu.host_map_pass([pp])

    def unmap(self, lps: Optional[Iterable[int]] = None) -> None:
        """Tear down translations — ONLY this space's (per-key
        self-invalidation; other ASIDs stay warm). ``lps=None`` unmaps the
        whole space."""
        if lps is None:
            self.table.clear()
            self.iommu.invalidate(asid=self.asid)
            if self.iommu.sanitizer is not None:
                self.iommu.sanitizer.check_unmapped(self.iommu, self.asid)
            return
        lps = list(lps)               # iterated twice — accept generators
        for lp in lps:
            self.table.pop(lp, None)
        self.iommu.invalidate(pages=[(self.asid, lp) for lp in lps])
        if self.iommu.sanitizer is not None:
            self.iommu.sanitizer.check_unmapped(self.iommu, self.asid, lps)

    # --------------------------------------------------------- translation
    def translate(self, lp: int) -> Tuple[int, float, bool]:
        """(physical page, walk cost, hit)."""
        return self.iommu.translate(self.asid, lp)

    def invalidate(self, lps: Optional[Iterable[int]] = None) -> None:
        """Drop this space's TLB entries (table survives — a re-walk will
        re-derive them)."""
        if lps is None:
            self.iommu.invalidate(asid=self.asid)
        else:
            self.iommu.invalidate(pages=[(self.asid, lp) for lp in lps])

    @property
    def n_pages(self) -> int:
        return len(self.table)


class IsolationError(PermissionError):
    """A tenant tried to translate through an ASID another tenant owns —
    the hard multi-tenant boundary. Structured like
    :class:`~repro_torch.core.sva.sanitizer.SvasanReport`: the fields are what
    the isolation tests assert on."""

    def __init__(self, tenant: Optional[str], owner: str, asid: int,
                 page: Optional[int] = None):
        self.tenant = tenant      # who asked (None = untenanted caller)
        self.owner = owner        # who owns the ASID
        self.asid = asid
        self.page = page          # logical page, when a translate faulted
        where = f" page {page}" if page is not None else ""
        super().__init__(
            f"tenant {tenant!r} denied: asid {asid}{where} is owned by "
            f"tenant {owner!r}")


class TenantDomain:
    """One tenant's view of the IOMMU: the set of ASIDs it owns and the
    translation verbs scoped to them (the execution-domain / bus-firewall
    analogue). Obtained via :meth:`IOMMU.register_tenant`; every translate
    issued through a domain carries the tenant identity, and the IOMMU
    refuses (structured :class:`IsolationError`) before touching any TLB
    state when the ASID belongs to someone else."""

    def __init__(self, iommu: "IOMMU", name: str):
        self.iommu = iommu
        self.name = name
        self.asids: set = set()
        self.denials = 0          # isolation faults charged to this tenant

    def attach(self, asid: int) -> IOAddressSpace:
        """Attach a fresh address space owned by this tenant."""
        return self.iommu.attach(asid, tenant=self.name)

    def adopt(self, asid: int) -> None:
        """Take ownership of an ASID without (re)attaching a space — trace
        replay assigns recorded slots to tenants this way."""
        owner = self.iommu._asid_tenant.get(asid)
        if owner is not None and owner != self.name:
            self.denials += 1
            raise IsolationError(self.name, owner, asid)
        self.iommu._asid_tenant[asid] = self.name
        self.asids.add(asid)

    def translate(self, asid: int, page: int,
                  phys: Optional[int] = None) -> Tuple[int, float, bool]:
        """Translate on behalf of this tenant (isolation-checked)."""
        return self.iommu.translate(asid, page, phys, tenant=self.name)

    def stats(self) -> dict:
        return dict(asids=len(self.asids), denials=self.denials)


class IOMMU:
    """The translation front-end: one shared IOTLB + one walk cost model,
    many attached address spaces (ASIDs), and an optional IOTLB prefetcher
    (``PrefetchConfig`` — see the module docstring for the timing model)."""

    def __init__(self, walk_model: Optional[WalkModel] = None,
                 tlb: TLBConfig = TLBConfig(),
                 prefetch: PrefetchConfig = PrefetchConfig()):
        self.walk_model: WalkModel = walk_model or CountingWalk()
        self.tlb_config = tlb
        # Tenant registry: name -> TenantDomain, asid -> owning tenant.
        # Empty (the default) keeps every path bit-identical to the
        # untenanted front-end — translate()'s check is one truthiness
        # test, and the cache gets no tenant resolver.
        self._tenants: Dict[str, TenantDomain] = {}
        self._asid_tenant: Dict[int, str] = {}
        self.tlb = self._build_cache(tlb)
        self.prefetch_config = prefetch
        # Range-coalescing counters (the ``range:`` stats block; only
        # reported when ``tlb.ranges`` arms coalescing).
        self.range_fills = 0          # range entries installed
        self.range_hits = 0           # demand hits served by a range entry
        self.coalesced_pages = 0      # pages covered by installed ranges
        self.range_splits = 0         # ranges split by partial invalidation
        # Prefetcher state: fills issued but not yet completed (they install
        # at the START of the next demand translate — arriving demand for a
        # pending key is a LATE prefetch), installed-but-never-demanded keys
        # (for useful-once accounting), and the per-ASID stream detector
        # [last_lp, run_length, next_unprefetched_lp].
        self._pending: "OrderedDict" = OrderedDict()
        self._prefetched: set = set()
        self._streams: Dict[int, List[int]] = {}
        # Non-leaf PTE lines installed into the walk model's walk cache by
        # COMPLETING prefetches (a useful prefetch warms the walk cache for
        # the neighbourhood, not just its own leaf translation).
        self.walk_cache_prefills = 0
        self.epoch = 0
        self._spaces: Dict[int, IOAddressSpace] = {}
        # svasan shadow-state hook (core/sva/sanitizer.py); None keeps
        # translate()/unmap paths bit-identical to the unsanitized stack.
        self.sanitizer: Optional["SVASanitizer"] = None

    # ------------------------------------------------------------- tenants
    def _build_cache(self, tlb: TLBConfig) -> TranslationCache:
        """The ONE TranslationCache constructor for the IOTLB: geometry
        from ``tlb``, tenant resolver wired iff tenancy is in play."""
        parts = tlb.partition_dict
        tenant_of = self._tenant_of_key if (parts or self._tenants) else None
        return TranslationCache(tlb.n_entries, policy=tlb.policy,  # svalint: disable=R001
                                seed=tlb.seed, ways=tlb.ways,
                                range_aware=bool(tlb.ranges),
                                partitions=parts or None,
                                tenant_of=tenant_of)

    def _tenant_of_key(self, key) -> Optional[str]:
        """Tenant owning a TLB key — both exact ``(asid, lp)`` and range
        ``(asid, base, n)`` keys carry the ASID first."""
        if isinstance(key, tuple) and key:
            return self._asid_tenant.get(key[0])
        return None

    def register_tenant(self, name: str) -> TenantDomain:
        """Create (or return) the named tenant domain. The first
        registration arms per-tenant TLB accounting."""
        if not name:
            raise ValueError("tenant name must be non-empty")
        dom = self._tenants.get(name)
        if dom is None:
            dom = self._tenants[name] = TenantDomain(self, name)
            if self.tlb._tenant_of is None:
                self.tlb._tenant_of = self._tenant_of_key
        return dom

    def tenant_of(self, asid: int) -> Optional[str]:
        """The tenant owning ``asid`` (None = unowned)."""
        return self._asid_tenant.get(asid)

    def _check_tenant(self, tenant: Optional[str], asid: int,
                      page: Optional[int] = None) -> None:
        """The isolation gate: an owned ASID may only be used by its
        owner. Untenanted callers (tenant=None) are refused too — once an
        ASID belongs to a domain, anonymous access is a leak."""
        owner = self._asid_tenant.get(asid)
        if owner is not None and owner != tenant:
            dom = self._tenants.get(tenant) if tenant else None
            if dom is not None:
                dom.denials += 1
            raise IsolationError(tenant, owner, asid, page)

    # ----------------------------------------------------------- lifecycle
    def attach(self, asid: int,
               tenant: Optional[str] = None) -> IOAddressSpace:
        """Create the per-process/per-request address space for ``asid``.
        ``tenant`` assigns ownership to a registered domain (the slot's
        translations are then isolation-checked against it)."""
        if asid in self._spaces:
            raise ValueError(f"asid {asid} already attached")
        if tenant is not None and tenant not in self._tenants:
            raise ValueError(f"tenant {tenant!r} is not registered")
        if self._asid_tenant:
            # re-attaching an ASID a live tenant still owns needs the
            # owner's identity (or a prior detach dropped it)
            self._check_tenant(tenant, asid)
        sp = IOAddressSpace(self, asid)
        self._spaces[asid] = sp
        if tenant is not None:
            self._asid_tenant[asid] = tenant
            self._tenants[tenant].asids.add(asid)
        return sp

    def detach(self, asid: int) -> None:
        """Destroy an address space, self-invalidating ONLY its own
        translations (a whole-TLB flush per teardown would force a full
        re-walk for every OTHER live space — the Listing-1 full flush is
        ``invalidate()``). Costs O(mapped pages), not O(TLB entries): the
        space's table already enumerates its logical pages."""
        sp = self._spaces.pop(asid, None)
        if sp is None:
            return
        if sp._untracked_fills:
            self.invalidate(asid=asid)           # full scan, rare
        else:
            self.invalidate(pages=[(asid, lp) for lp in sp.table])
            # predictor state and any in-flight prefetch die with the space
            for key in [k for k in self._pending if k[0] == asid]:
                del self._pending[key]
            self._streams.pop(asid, None)
        if self.sanitizer is not None:
            # nothing of the dead space may survive detach: no TLB entry,
            # no in-flight prefetch fill
            self.sanitizer.check_unmapped(self, asid)
        owner = self._asid_tenant.pop(asid, None)
        if owner is not None:
            dom = self._tenants.get(owner)
            if dom is not None:
                dom.asids.discard(asid)
        sp.table.clear()

    def space(self, asid: int) -> Optional[IOAddressSpace]:
        return self._spaces.get(asid)

    @property
    def n_spaces(self) -> int:
        return len(self._spaces)

    @property
    def range_max(self) -> int:
        """Max pages one range entry may cover (0 = coalescing off)."""
        return self.tlb_config.ranges

    # ------------------------------------------------------- range entries
    def _warm_fill_runs(self, asid: int, start: int,
                        pages: Sequence[int],
                        singles: bool = True) -> None:
        """Map-time pre-warm with coalescing: physically contiguous chunks
        of the mapped pages (capped at ``range_max``) warm as one range
        entry each; singletons warm per-page (``singles=False`` skips them
        — the trace replay uses this so its per-page baseline, which never
        warms, stays an apples-to-apples comparison). Falls back to
        per-page fills for a chunk that would overlap a resident range
        (ranges stay disjoint — the invariant every lookup leans on)."""
        i, n = 0, len(pages)
        while i < n:
            j = i + 1
            while (j < n and pages[j] == pages[j - 1] + 1
                   and j - i < self.range_max):
                j += 1
            lp, run = start + i, j - i
            if run >= 2 and not self.tlb.ranges_overlapping(
                    asid, lp, lp + run - 1):
                for k in range(lp, lp + run):    # drop subsumed exact keys
                    if (asid, k) in self.tlb:
                        self.tlb.invalidate_key((asid, k))
                self.tlb.fill((asid, lp, run), pages[i], walked=False,
                              span=float(run))
                self.range_fills += 1
                self.coalesced_pages += run
            elif singles:
                for k in range(run):
                    self.tlb.fill((asid, lp + k), pages[i + k], walked=False)
            i = j

    def _try_coalesce(self, sp: IOAddressSpace, asid: int, page: int,
                      phys: int, cost: float) -> bool:
        """Opportunistic range fill on a demand miss: when the space's table
        shows a physically contiguous run around ``page``, install ONE range
        entry covering it (capped at ``range_max``, anchored at the demand
        page — extend down, then up). Resident exact keys inside the run are
        subsumed; resident ranges fully inside it are replaced; any partial
        overlap bails to a per-page fill (ranges stay disjoint). Returns
        True when a range entry was installed."""
        table = sp.table
        max_run = self.range_max
        lo, hi = page, page
        while (page - lo) + 1 < max_run and table.get(lo - 1) == \
                phys - (page - lo) - 1:
            lo -= 1
        while (hi - lo) + 1 < max_run and table.get(hi + 1) == \
                phys + (hi - page) + 1:
            hi += 1
        n = hi - lo + 1
        if n < 2:
            return False
        base_ppn = phys - (page - lo)
        for b, bn in self.tlb.ranges_overlapping(asid, lo, hi):
            if b < lo or b + bn - 1 > hi:
                return False                     # partial overlap: bail
        for b, bn in self.tlb.ranges_overlapping(asid, lo, hi):
            self.tlb.invalidate_key((asid, b, bn))
        for lp in range(lo, hi + 1):
            k = (asid, lp)
            if k in self.tlb:
                self.tlb.invalidate_key(k)
                self._prefetched.discard(k)
        self.tlb.fill((asid, lo, n), base_ppn, cost=cost, span=float(n))
        self.range_fills += 1
        self.coalesced_pages += n
        return True

    def _split_ranges_for(self,
                          keys: List[Tuple[int, int]]) -> None:
        """Range-granular invalidation: a range entry covering any of the
        dead ``(asid, lp)`` keys is removed and its SURVIVING maximal
        segments re-installed (length 1 -> exact key, length >= 2 -> a
        narrower range). A range entry never outlives a split — the
        correctness surface CoW remaps and partial unmaps ride on."""
        dead: Dict[int, set] = {}
        for asid, lp in keys:
            dead.setdefault(asid, set()).add(lp)
        for asid, lps in dead.items():
            lo, hi = min(lps), max(lps)
            for base, n in self.tlb.ranges_overlapping(asid, lo, hi):
                covered = set(range(base, base + n))
                if not (covered & lps):
                    continue
                base_ppn = self.tlb.peek((asid, base, n))
                self.tlb.invalidate_key((asid, base, n))
                survivors = sorted(covered - lps)
                if survivors:
                    self.range_splits += 1
                seg_lo = None
                prev = None
                for lp in survivors + [None]:    # sentinel flushes last seg
                    if seg_lo is not None and (lp is None or lp != prev + 1):
                        seg_n = prev - seg_lo + 1
                        seg_pp = base_ppn + (seg_lo - base)
                        if seg_n == 1:
                            self.tlb.fill((asid, seg_lo), seg_pp,
                                          walked=False)
                        else:
                            self.tlb.fill((asid, seg_lo, seg_n), seg_pp,
                                          walked=False, span=float(seg_n))
                        seg_lo = None
                    if lp is not None and seg_lo is None:
                        seg_lo = lp
                    prev = lp

    # --------------------------------------------------------- translation
    def translate(self, asid: int, page: int,
                  phys: Optional[int] = None,
                  tenant: Optional[str] = None) -> Tuple[int, float, bool]:
        """IOTLB lookup; walks the page table on miss.

        ``tenant`` is the identity the translation is issued under
        (:meth:`TenantDomain.translate` supplies it): when any tenant owns
        ASIDs, a translate for an ASID the caller does not own raises
        :class:`IsolationError` BEFORE any TLB state is read or filled —
        range entries and prefetch fills are keyed by ASID, so nothing can
        leak across the boundary. With no tenants registered the check is
        a single truthiness test (bit-identical fast path).

        Returns (physical page, walk cost, hit). ``phys`` overrides the
        table-derived value (trace replay: the recorded access already knows
        its physical page); a hit whose cached value contradicts it is by
        definition stale (a remap the replay never saw invalidate) and is
        re-walked, like the hardware would after the remap's invalidation.
        Unattached ASIDs translate identity — the simulator drives raw page
        ids without building tables; for an ATTACHED space a missing table
        entry is a caller error (a walk of a hole would cache a bogus
        translation in the shared TLB) and raises.

        With prefetching on, a demand hit can carry a nonzero cost: a LATE
        prefetch (the fill was issued by the immediately preceding demand
        access and its walk is still in flight) charges the full stored
        walk cost — conservative, no partial-latency credit — while a
        timely prefetched hit costs 0 like any other hit.
        """
        if self._asid_tenant:
            self._check_tenant(tenant, asid, page)
            if self.sanitizer is not None:
                # independent shadow check: catches a monkeypatched /
                # buggy _check_tenant red-handed (cross-tenant-translate)
                self.sanitizer.check_tenant_translate(self, tenant, asid,
                                                      page)
        pf = self.prefetch_config.enabled
        ranges = self.range_max
        key = (asid, page)
        late_cost = 0.0
        if pf and self._pending:
            late_cost = self._install_pending(key)
        rng = None
        if ranges and key not in self.tlb:
            # No exact entry — a resident range may still cover the page.
            # ONE counting lookup either way (range key on coverage, exact
            # key otherwise so the miss lands in the right set).
            rng = self.tlb.range_covering(asid, page)
        if rng is not None:
            base, n = rng
            base_ppn, hit = self.tlb.lookup((asid, base, n))
            val = base_ppn + (page - base) if hit else None
            if hit:
                self.range_hits += 1
        else:
            val, hit = self.tlb.lookup(key)
        if hit and phys is not None and val != phys:
            self.tlb.stats.hits -= 1             # stale: account as a miss
            self.tlb.stats.misses += 1
            if rng is not None:
                # stale range hit: the covering range must not survive the
                # page it mis-translates — split it, like hardware after
                # the remap's range-granular invalidation
                self.range_hits -= 1
                self._split_ranges_for([key])
            else:
                self.tlb.invalidate_key(key)
            self._prefetched.discard(key)
            hit = False
            late_cost = 0.0
        if hit:
            if self.sanitizer is not None and phys is None:
                # hit-path cross-check against the live table (translate-
                # after-unmap / missed-remap-invalidation detector). Replay
                # callers pass ``phys`` ground truth and re-walk stale hits
                # above — their tables are deliberately looser.
                self.sanitizer.check_hit(self, asid, page, val)
            if key in self._prefetched:
                self._prefetched.discard(key)
                self.tlb.stats.prefetch_useful += 1
                if late_cost:
                    self.tlb.stats.prefetch_late += 1
            else:
                late_cost = 0.0                  # entry predates the flush
            if pf:
                self._note_access(asid, page, miss=False)
            return val, late_cost, True
        sp = self._spaces.get(asid)
        if phys is None:
            if sp is not None:
                if page not in sp.table:
                    raise KeyError(
                        f"asid {asid}: logical page {page} is not mapped")
                phys = sp.table[page]
            else:
                phys = page
        cost = self.walk_model.walk(asid, phys, vpn=page)
        # coalesce only when the live table agrees with the filled value
        # (replay ground truth can disagree after an unseen remap)
        coalesced = (bool(ranges) and sp is not None
                     and sp.table.get(page) == phys
                     and self._try_coalesce(sp, asid, page, phys, cost))
        if not coalesced:
            self.tlb.fill(key, phys, cost=cost)
        self._prefetched.discard(key)   # prefetched once, evicted before use
        if sp is not None and page not in sp.table:
            sp._untracked_fills = True
        if pf:
            self._note_access(asid, page, miss=True)
        return phys, cost, False

    # ---------------------------------------------------------- prefetcher
    def _install_pending(self, demand_key: Tuple[int, int]) -> float:
        """Complete every in-flight prefetch (they finish at the start of
        the next demand translate). Returns the stored walk cost when the
        demanded key itself was still in flight (a LATE prefetch — the
        demand exposes that walk's latency), else 0."""
        late = 0.0
        wc = getattr(self.walk_model, "walk_cache", None)
        for key, (pp, cost, lines) in self._pending.items():
            if key == demand_key:
                late = cost
            if self.sanitizer is not None:
                self.sanitizer.check_fill(self, key, pp)
            self.tlb.fill(key, pp, walked=False, cost=cost)
            self._prefetched.add(key)
            if lines and wc is not None:
                # the prefetch walk's non-leaf reads land now that the walk
                # has completed (deferred from Sv39Walk.prefetch_walk)
                for line in lines:
                    wc.fill(line, 1, walked=False)
                    self.walk_cache_prefills += 1
        self._pending.clear()
        if len(self._prefetched) > 4 * self.tlb.n_entries:
            # evicted-before-use keys accumulate; prune lazily
            self._prefetched = {k for k in self._prefetched if k in self.tlb}
        return late

    def _note_access(self, asid: int, page: int, miss: bool) -> None:
        """Feed the prefetch predictor one demand access and issue fills."""
        cfg = self.prefetch_config
        if cfg.policy == "next_page":
            if miss:
                self._issue(asid, range(page + 1, page + 1 + cfg.degree))
            return
        st = self._streams.get(asid)               # stream
        if st is None or page != st[0] + 1:
            self._streams[asid] = [page, 1, page + 1]
            return
        st[0] = page
        st[1] += 1
        if st[1] < STREAM_THRESHOLD:
            return
        start = max(st[2], page + 1)
        end = min(page + cfg.distance, start + cfg.degree - 1)
        if start <= end:
            self._issue(asid, range(start, end + 1))
            st[2] = end + 1

    def _issue(self, asid: int, pages: Iterable[int]) -> None:
        """Issue walk-model fills for predicted logical pages. NEVER
        fabricates a translation: attached spaces only prefetch pages
        present in their table (holes are skipped cleanly); unattached
        ASIDs prefetch identity, matching their demand behavior."""
        sp = self._spaces.get(asid)
        for lp in pages:
            if lp < 0:
                continue
            key = (asid, lp)
            if key in self.tlb or key in self._pending:
                continue
            if self.range_max and \
                    self.tlb.range_covering(asid, lp) is not None:
                continue                 # a range entry already covers it
            if sp is not None:
                pp = sp.table.get(lp)
                if pp is None:
                    continue                     # unmapped: skip, don't walk
            else:
                pp = lp
            # Walk models that distinguish in-flight prefetch walks (the
            # Sv39 walker defers its walk-cache installs) expose
            # prefetch_walk; others price it like any demand walk.
            pw = getattr(self.walk_model, "prefetch_walk", None)
            if pw is not None:
                cost, lines = pw(asid, pp, vpn=lp)
            else:
                cost = self.walk_model.walk(asid, pp, vpn=lp)
                lines = ()
            self._pending[key] = (pp, cost, lines)
            self.tlb.stats.prefetch_issued += 1

    def host_map_pass(self, pages: Iterable[int]) -> None:
        """Paper Listing 1: the host maps right before offload; the walk
        model may warm PTE state."""
        self.walk_model.host_map_pass(pages)

    # -------------------------------------------------------- invalidation
    def invalidate(self, asid: Optional[int] = None,
                   pages: Optional[Iterable[Tuple[int, int]]] = None) -> None:
        """Three granularities (the paper's invalidation interface):

          invalidate()                 full flush; bumps the epoch EXACTLY
                                       once (Listing-1 self-invalidation —
                                       the next table upload must be full)
          invalidate(asid=a)           drop every translation of one space
          invalidate(pages=[(a, lp)])  drop specific translations
        """
        if pages is not None:
            keys = list(pages)
            for key in keys:
                self.tlb.invalidate_key(key)
                self._pending.pop(key, None)
                self._prefetched.discard(key)
            if self.range_max:
                # range-granular: a range covering a dead page splits into
                # its surviving segments (never outlives the invalidation)
                self._split_ranges_for(keys)
            return
        if asid is not None:
            for key in self.tlb.keys():
                if key[0] == asid:
                    self.tlb.invalidate_key(key)
            for key in [k for k in self._pending if k[0] == asid]:
                del self._pending[key]
            self._prefetched = {k for k in self._prefetched
                                if k[0] != asid}
            self._streams.pop(asid, None)
            return
        self.tlb.invalidate()
        self._pending.clear()
        self._prefetched.clear()
        self._streams.clear()
        self.epoch += 1

    def reconfigure_tlb(self, tlb: TLBConfig) -> None:
        """Online geometry switch (the auto-tuner's resize): swap in a
        fresh TranslationCache with the new geometry. A resize is a real
        hardware flush — every translation dies, in-flight prefetches are
        dropped, and the epoch bumps exactly once (the next serving table
        upload must be full). Cumulative stats carry over so the ``tlb:``
        schema stays monotonic across switches; the flush is counted as an
        invalidation like any other full flush."""
        if tlb == self.tlb_config:
            return
        stats = self.tlb.stats
        tenant_stats = self.tlb.tenant_stats
        self.tlb_config = tlb
        self.tlb = self._build_cache(tlb)
        self.tlb.stats = stats
        self.tlb.tenant_stats = tenant_stats
        self.tlb.stats.invalidations += 1
        self._pending.clear()
        self._prefetched.clear()
        self._streams.clear()
        self.epoch += 1

    # --------------------------------------------------------------- stats
    def stats(self) -> dict:
        """The unified translation stats schema every layer reports:

          tlb    hits / misses / evictions / invalidations / walks /
                 conflict_misses / hit_rate
          walk   model name + walks / cycles (modeled cost); walkers with a
                 walk cache add a ``walk_cache:`` block (hits / misses /
                 geometry)
          epoch  full-flush count
          asids  live address spaces
        """
        walk = {"model": self.walk_model.name,
                **self.walk_model.stats.as_dict()}
        wc = getattr(self.walk_model, "walk_cache", None)
        if wc is not None:
            wcs = wc.stats
            walk["walk_cache"] = dict(
                hits=wcs.hits, misses=wcs.misses, evictions=wcs.evictions,
                n_entries=wc.n_entries, ways=wc.ways)
        if self.prefetch_config.enabled:
            ts = self.tlb.stats
            walk["prefetch"] = dict(
                policy=self.prefetch_config.policy,
                degree=self.prefetch_config.degree,
                distance=self.prefetch_config.distance,
                issued=ts.prefetch_issued, useful=ts.prefetch_useful,
                late=ts.prefetch_late,
                walk_cache_prefills=self.walk_cache_prefills)
        out = {"tlb": self.tlb.stats.as_dict(),
               "walk": walk,
               "epoch": self.epoch,
               "asids": self.n_spaces}
        if self.range_max:
            out["range"] = dict(
                max_run=self.range_max, n_ranges=self.tlb.n_ranges,
                fills=self.range_fills, hits=self.range_hits,
                coalesced_pages=self.coalesced_pages,
                splits=self.range_splits)
        if self._tenants:
            parts = self.tlb_config.partition_dict
            tenant = {}
            for name, dom in sorted(self._tenants.items()):
                block = dom.stats()
                block["ways"] = parts.get(name, 0)
                ts = self.tlb.tenant_stats.get(name)
                if ts is not None:
                    block["tlb"] = ts.as_dict()
                tenant[name] = block
            out["tenant"] = tenant
        return out


class TLBAutoTuner:
    """Online geometry auto-tuner over an :class:`IOMMU`'s TLB.

    Drive it with :meth:`observe_step` once per decode step (the
    ``PagedKVManager`` does this from ``translate_step``; trace replay does
    it per ``step`` event). Deterministic: the same access stream through
    the same config reproduces the same switch sequence.

    Phases: ``explore`` measures each candidate geometry for one window
    (the current geometry is measured first when it is a candidate),
    ``exploit`` stays on the best explored geometry and re-enters explore
    when its live hit rate drops ``retune_margin`` below the best explored
    value (workload shift). Every switch goes through
    :meth:`IOMMU.reconfigure_tlb` — flush + epoch bump."""

    def __init__(self, iommu: IOMMU, config: AutoTuneConfig):
        self.iommu = iommu
        self.config = config
        self.candidates: Tuple[TLBConfig, ...] = config.candidates
        # Measure the installed geometry first when it's a candidate (no
        # gratuitous flush at engine start).
        try:
            self._idx = self.candidates.index(iommu.tlb_config)
        except ValueError:
            self._idx = 0
            iommu.reconfigure_tlb(self.candidates[0])
        self._explored: Dict[int, float] = {}
        self._phase = "explore"
        self._steps = 0
        self._warmup = True        # discard the first window after a switch
        self.windows = 0
        self.switches = 0
        self.best_idx: Optional[int] = None
        self._snap = self._snapshot()

    def _snapshot(self) -> Tuple[int, int, int]:
        s = self.iommu.tlb.stats
        return s.hits, s.misses, s.conflict_misses

    def _window_stats(self) -> Tuple[float, int, int]:
        """(hit rate, conflict misses, demand accesses) over the window
        since the last snapshot — the live signal the tuner watches."""
        h0, m0, c0 = self._snap
        s = self.iommu.tlb.stats
        dh, dm = s.hits - h0, s.misses - m0
        total = dh + dm
        return ((dh / total if total else 0.0),
                s.conflict_misses - c0, total)

    def _switch_to(self, idx: int) -> None:
        if self.candidates[idx] != self.iommu.tlb_config:
            self.iommu.reconfigure_tlb(self.candidates[idx])
            self.switches += 1
            self._warmup = True     # post-flush window is cold: don't score
        self._idx = idx

    def observe_step(self) -> None:
        """Count one decode step; close a measurement window every
        ``interval_steps`` and explore/exploit accordingly."""
        self._steps += 1
        if self._steps % self.config.interval_steps:
            return
        rate, conflicts, accesses = self._window_stats()
        self._snap = self._snapshot()
        if accesses < self.config.min_accesses:
            return                              # idle window: no signal
        if self._warmup:
            # The window right after a geometry switch (or engine start)
            # measures compulsory refills, not the geometry — skip it so a
            # candidate is never condemned for the flush it began with.
            self._warmup = False
            return
        self.windows += 1
        if self._phase == "explore":
            self._explored[self._idx] = (rate, conflicts)
            nxt = next((i for i in range(len(self.candidates))
                        if i not in self._explored), None)
            if nxt is not None:
                self._switch_to(nxt)
                return
            # every candidate measured: exploit the best window hit rate;
            # ties break on fewer conflict misses (a set-constrained
            # geometry losing to associativity at equal rate), then fewer
            # entries, then candidate order
            self.best_idx = min(
                self._explored,
                key=lambda i: (-self._explored[i][0], self._explored[i][1],
                               self.candidates[i].n_entries, i))
            self._phase = "exploit"
            self._switch_to(self.best_idx)
            return
        best_rate = self._explored.get(self.best_idx, (0.0, 0))[0]
        if rate < best_rate - self.config.retune_margin:
            # workload shifted under us: measurements are stale, re-explore
            # (starting from the currently installed geometry — no flush)
            self._explored = {}
            self._phase = "explore"

    @property
    def converged(self) -> bool:
        return self._phase == "exploit"

    def stats(self) -> dict:
        """The ``autotune:`` stats block (see ARCHITECTURE.md)."""
        cur = self.iommu.tlb_config
        return dict(
            phase=self._phase, windows=self.windows, switches=self.switches,
            interval_steps=self.config.interval_steps,
            n_candidates=len(self.candidates),
            current=dict(n_entries=cur.n_entries, ways=cur.resolved_ways,
                         policy=cur.policy),
            explored={self._label(self.candidates[i]):
                      dict(hit_rate=round(r, 4), conflict_misses=c)
                      for i, (r, c) in sorted(self._explored.items())})

    @staticmethod
    def _label(c: TLBConfig) -> str:
        w = "full" if c.resolved_ways == c.n_entries else str(c.ways)
        return f"e{c.n_entries}.w{w}.{c.policy}"


__all__ = ["AutoTuneConfig", "CountingWalk", "IOAddressSpace", "IOMMU",
           "IsolationError", "PrefetchConfig", "Sv39Walk", "TLBAutoTuner",
           "TLBConfig", "TenantDomain", "WalkCacheConfig", "WalkModel",
           "WalkStats", "default_autotune_candidates"]
