"""Translation cache — the IOTLB analogue, with pluggable replacement and
hardware geometry.

This class is a *component* of the unified IOMMU front-end
(:mod:`repro_torch.core.sva.iommu`): the paper's 4-entry hardware IOTLB and the
serving engine's large delta-upload cache are the same class configured
differently (``TLBConfig(n_entries, policy, ways=...)``).  No module outside
``iommu.py`` constructs it directly — attach an address space to an
:class:`~repro_torch.core.sva.iommu.IOMMU` instead.

Replacement policies (the Kim-et-al. translation design space):

  lru     hit refreshes recency; evict the least recently used entry
  fifo    insertion order only; hits never reorder
  lfu     evict the least frequently used entry (ties: oldest insertion)
  random  evict a uniformly random entry (seeded — traces stay reproducible)
  gdsfs   Greedy-Dual-Size-Frequency: every entry carries a priority
          ``clock + frequency * cost / span`` (``cost`` = the walk cost paid
          to fill it, ``span`` = how much the entry covers — 1 for a single
          page translation); evict the minimum priority and age the set's
          clock up to it. Size-aware: at equal frequency, an entry that was
          expensive to walk (LLC-cold, no walk-cache hit) outlives a cheap
          one, and a wide entry outlives a narrow one per byte of reach.
          Deterministic (no RNG), so traces stay reproducible.

Stats schema (``TLBStats.as_dict()``, the ``tlb:`` section every layer
reports — see ARCHITECTURE.md): hits / misses / evictions / invalidations /
walks / conflict_misses / prefetch_issued / prefetch_useful /
prefetch_late / hit_rate. The prefetch counters are driven by the owning
:class:`~repro_torch.core.sva.iommu.IOMMU`'s prefetcher (always present, 0 when
prefetching is off).

Associativity (the second Kim-et-al. axis): ``ways`` splits the cache into
``n_entries // ways`` sets indexed by the logical page (the last integer
component of a tuple key); replacement state is kept per set. ``ways == 0``
or ``ways == n_entries`` is fully associative — one set, bit-identical to
the historical behavior. A lookup miss whose target set is full while the
cache as a whole still has free entries is counted as a *conflict miss*
(a fully-associative cache of the same capacity could have absorbed it);
with one set that situation cannot arise, so ``conflict_misses`` is always
0 for fully-associative configs.

Range entries (``range_aware=True``, SPARTA-style coalescing): a 3-tuple
key ``(asid, base_lpn, n_pages)`` is a *range entry* whose value is the
base physical page — one entry translates ``n_pages`` contiguous logical
pages to ``n_pages`` contiguous physical pages (``ppn = value + (lp -
base_lpn)``). Range keys set-index on ``base_lpn`` (NOT the last tuple
component — under an Sv39 walk cache 3-tuples are ``(asid, level,
top-bits)`` keys, which is why range decoding is an explicit constructor
opt-in rather than inferred from arity), weigh ``span=n_pages`` under
gdsfs, and are tracked in a per-ASID side index so ``range_covering``
resolves a logical page without scanning sets. The owning IOMMU is the
only producer of range keys (coalescing on fill, splitting on partial
invalidation — see iommu.py).

Way partitioning (``partitions={tenant: ways}``, the MMU-partitioning
axis of multi-tenant serving): each named tenant is granted a private
way budget *within every set*; the remaining ways form a shared pool for
un-partitioned traffic. A new fill whose tenant's partition is full
evicts only among that tenant's own entries, so one tenant's thrash can
never evict another tenant's (or the shared pool's) working set; a fill
into the shared pool reclaims shared entries first and never steals a
protected way. ``tenant_of`` (installed by the owning IOMMU) maps a key
to its tenant; per-tenant :class:`TLBStats` accumulate alongside the
global counters — a partitioned tenant's ``conflict_misses`` counts
misses its own partition was too small for while the cache as a whole
still had room. With no partitions configured every code path reduces to
the historical behavior bit-for-bit.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Hashable, Iterable, List, Optional, Tuple

import numpy as np

POLICIES = ("lru", "fifo", "lfu", "random", "gdsfs")


@dataclass
class TLBStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    invalidations: int = 0
    walks: int = 0           # page-table walks performed (one per genuine miss)
    conflict_misses: int = 0  # misses a same-size fully-assoc cache had room for
    prefetch_issued: int = 0  # prefetch fills issued (walks done off the demand path)
    prefetch_useful: int = 0  # prefetched entries that saw a demand hit
    prefetch_late: int = 0    # useful, but demanded while the walk was in flight

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self):
        return dict(hits=self.hits, misses=self.misses,
                    evictions=self.evictions, invalidations=self.invalidations,
                    walks=self.walks, conflict_misses=self.conflict_misses,
                    prefetch_issued=self.prefetch_issued,
                    prefetch_useful=self.prefetch_useful,
                    prefetch_late=self.prefetch_late,
                    hit_rate=round(self.hit_rate, 4))


class TranslationCache:
    """(key -> value) set-associative cache with epoch invalidation and
    pluggable policy. One set (``ways in (0, n_entries)``) is fully
    associative."""

    def __init__(self, n_entries: int, policy: str = "lru", seed: int = 0,
                 ways: int = 0, range_aware: bool = False,
                 partitions: Optional[Dict[str, int]] = None,
                 tenant_of=None):
        assert n_entries >= 1
        if policy not in POLICIES:
            raise ValueError(f"policy={policy!r} (expected one of {POLICIES})")
        ways = ways or n_entries
        if ways < 1 or ways > n_entries or n_entries % ways:
            raise ValueError(
                f"ways={ways} must divide n_entries={n_entries} "
                f"(1 <= ways <= n_entries)")
        self.n_entries = n_entries
        self.ways = ways
        self.n_sets = n_entries // ways
        self.policy = policy
        self.range_aware = range_aware
        # Way partitioning: tenant -> private ways per set; leftover ways
        # are the shared pool. tenant_of (key -> tenant | None) is
        # installed by the owning IOMMU — None means untenanted traffic.
        self._partitions: Dict[str, int] = dict(partitions) if partitions \
            else {}
        self._tenant_of = tenant_of
        if self._partitions:
            bad = {t: w for t, w in self._partitions.items() if w < 1}
            if bad:
                raise ValueError(f"partition ways must be >= 1 (got {bad})")
            reserved = sum(self._partitions.values())
            if reserved > self.ways:
                raise ValueError(
                    f"partitions reserve {reserved} ways but the cache has "
                    f"{self.ways} per set")
            self._shared_ways = self.ways - reserved
        else:
            self._shared_ways = self.ways
        #: per-tenant counters (lazily created on first tenant-owned access)
        self.tenant_stats: Dict[str, TLBStats] = {}
        # per-ASID side index of resident range entries: asid -> {base: n}.
        # Disjoint by construction (the IOMMU never fills overlapping
        # ranges), so range_covering has at most one answer.
        self._range_index: Dict[int, Dict[int, int]] = {}  # svalint: disable=R001
        self._sets: List[OrderedDict] = [OrderedDict()  # svalint: disable=R001
                                         for _ in range(self.n_sets)]
        self._set0 = self._sets[0]      # fully-assoc fast path (hot loop)  # svalint: disable=R001
        self._freq: dict = {}  # svalint: disable=R001
        # gdsfs bookkeeping: per-key [cost, span, priority] (frequency lives
        # in _freq) and a per-set aging clock (GDSF's L, raised to each
        # evicted priority so long-resident entries cannot starve new ones).
        self._meta: dict = {}  # svalint: disable=R001
        self._clock: List[float] = [0.0] * self.n_sets
        self._n = 0                               # total resident entries
        self._rng = np.random.default_rng(seed)   # shared across sets
        self.stats = TLBStats()

    # ------------------------------------------------------------- indexing
    def _is_range_key(self, key: Hashable) -> bool:
        return self.range_aware and isinstance(key, tuple) and len(key) == 3

    def _set_index(self, key: Hashable) -> int:
        """Set selection on the logical page: the last integer component of
        a tuple key (the IOMMU keys ``(asid, logical_page)``), a bare int
        key, or ``hash(key)`` for anything else. Range keys
        ``(asid, base_lpn, n_pages)`` index on ``base_lpn``."""
        if self.n_sets == 1:
            return 0
        page = key
        if self._is_range_key(page):
            page = page[1]
        elif isinstance(page, tuple) and page:
            page = page[-1]
        if not isinstance(page, (int, np.integer)):
            page = hash(page)
        return int(page) % self.n_sets

    # -------------------------------------------------------- partitioning
    def _tstats(self, key: Hashable) -> Optional[TLBStats]:
        """The per-tenant stats block for ``key``'s owner (None when no
        tenant resolver is installed or the key is untenanted)."""
        if self._tenant_of is None:
            return None
        tenant = self._tenant_of(key)
        if tenant is None:
            return None
        ts = self.tenant_stats.get(tenant)
        if ts is None:
            ts = self.tenant_stats[tenant] = TLBStats()
        return ts

    def _group_of(self, key: Hashable) -> Optional[str]:
        """The replacement group ``key`` competes in: its tenant when that
        tenant holds a partition, else None (the shared pool)."""
        if not self._partitions or self._tenant_of is None:
            return None
        t = self._tenant_of(key)
        return t if t in self._partitions else None

    def _group_members(self, s: OrderedDict,
                       group: Optional[str]) -> List[Hashable]:
        return [k for k in s if self._group_of(k) == group]

    def partition_occupancy(self) -> Dict[Optional[str], List[int]]:
        """Resident entries per set, per partition group (None = shared
        pool). Diagnostics/tests: a partitioned tenant's count never
        exceeds its way budget in any set."""
        out: Dict[Optional[str], List[int]] = {
            t: [0] * self.n_sets for t in self._partitions}
        out[None] = [0] * self.n_sets
        for si, s in enumerate(self._sets):  # svalint: disable=R001
            for k in s:
                out[self._group_of(k)][si] += 1
        return out

    def lookup(self, key: Hashable) -> Tuple[Optional[int], bool]:
        """Returns (value, hit)."""
        s = (self._set0 if self.n_sets == 1  # svalint: disable=R001
             else self._sets[self._set_index(key)])  # svalint: disable=R001
        ts = None if self._tenant_of is None else self._tstats(key)
        if key in s:
            if self.policy == "lru":
                s.move_to_end(key)
            elif self.policy == "lfu":
                self._freq[key] += 1  # svalint: disable=R001
            elif self.policy == "gdsfs":
                self._bump_gdsfs(key)  # svalint: disable=R001
            self.stats.hits += 1
            if ts is not None:
                ts.hits += 1
            return s[key], True
        self.stats.misses += 1
        if len(s) >= self.ways and self._n < self.n_entries:
            self.stats.conflict_misses += 1
        if ts is not None:
            ts.misses += 1
            if self._partitions and self._n < self.n_entries:
                # The tenant-local analogue: the miss happened while the
                # tenant's own way budget in this set was exhausted.
                group = self._group_of(key)
                budget = self._partitions.get(group, self._shared_ways) \
                    if group is not None else self._shared_ways
                if len(self._group_members(s, group)) >= budget > 0:
                    ts.conflict_misses += 1
        return None, False

    def _bump_gdsfs(self, key: Hashable, cost: Optional[float] = None,
                    span: Optional[float] = None) -> None:
        """A use under gdsfs: frequency++ and re-price the priority at the
        current set clock (optionally refreshing cost/span)."""
        self._freq[key] += 1  # svalint: disable=R001
        m = self._meta[key]  # svalint: disable=R001
        if cost is not None and cost > 0:
            m[0] = cost
        if span is not None and span > 0:
            m[1] = span
        si = 0 if self.n_sets == 1 else self._set_index(key)  # svalint: disable=R001
        m[2] = self._clock[si] + self._freq[key] * m[0] / m[1]  # svalint: disable=R001

    def _evict_one(self, set_index: int,
                   among: Optional[set] = None) -> None:
        """Evict one entry from ``set_index`` by policy. ``among`` (way
        partitioning) restricts the candidate pool to those keys — the
        policy then picks its victim among them in the same order it would
        have considered them unrestricted. ``among=None`` is the
        historical full-set eviction, bit-for-bit."""
        s = self._sets[set_index]  # svalint: disable=R001
        if self.policy in ("lru", "fifo"):
            victim = next(iter(s)) if among is None \
                else next(k for k in s if k in among)
        elif self.policy == "lfu":
            # min frequency; ties broken by insertion order (OrderedDict scan)
            pool = s if among is None else [k for k in s if k in among]
            victim = min(pool, key=lambda k: self._freq[k])  # svalint: disable=R001
        elif self.policy == "gdsfs":
            # min priority; ties broken by insertion order. Aging: the set
            # clock rises to the evicted priority (GDSF's L), so a stale
            # high-cost entry eventually loses to fresh traffic.
            pool = s if among is None else [k for k in s if k in among]
            victim = min(pool, key=lambda k: self._meta[k][2])  # svalint: disable=R001
            self._clock[set_index] = self._meta[victim][2]  # svalint: disable=R001
        else:                                     # random (seeded)
            keys = list(s) if among is None else [k for k in s if k in among]
            victim = keys[int(self._rng.integers(len(keys)))]
        if self._tenant_of is not None:
            vt = self._tenant_of(victim)
            if vt is not None:
                vs = self.tenant_stats.get(vt)
                if vs is None:
                    vs = self.tenant_stats[vt] = TLBStats()
                vs.evictions += 1
        del s[victim]
        self._freq.pop(victim, None)  # svalint: disable=R001
        self._meta.pop(victim, None)  # svalint: disable=R001
        if self._is_range_key(victim):
            self._drop_range(victim)
        self._n -= 1
        self.stats.evictions += 1

    def _drop_range(self, key: Tuple[int, int, int]) -> None:
        asid_ranges = self._range_index.get(key[0])  # svalint: disable=R001
        if asid_ranges is not None:
            asid_ranges.pop(key[1], None)
            if not asid_ranges:
                del self._range_index[key[0]]  # svalint: disable=R001

    def fill(self, key: Hashable, value, walked: bool = True,
             cost: Optional[float] = None, span: float = 1.0) -> None:
        """Insert a translation. A walk is counted ONLY for a genuine
        walk-and-fill (``walked=True`` AND the key not already resident):
        refreshing a live entry (e.g. re-warming on ``extend``) or a host
        pre-warm at map time (``walked=False`` — the driver wrote the PTE,
        no device walk happened) must not inflate Fig.5-style walk
        counts. A refresh still counts as a *use* (it re-ups recency under
        ``lru``, frequency under ``lfu``, and priority under ``gdsfs`` — a
        page kept hot by map/extend re-warms must not look cold to the
        replacement policy).

        ``cost``/``span`` feed the gdsfs score (frequency × cost ÷ span):
        ``cost`` is the walk cost paid to produce this translation (None or
        0 prices as 1 — e.g. CountingWalk fills, where gdsfs degrades to a
        frequency policy), ``span`` what the entry covers. Ignored by every
        other policy."""
        si = 0 if self.n_sets == 1 else self._set_index(key)  # svalint: disable=R001
        s = self._sets[si]  # svalint: disable=R001
        if key in s:
            if self.policy == "lru":
                s.move_to_end(key)
            elif self.policy == "lfu":
                self._freq[key] += 1  # svalint: disable=R001
            elif self.policy == "gdsfs":
                self._bump_gdsfs(key, cost, span)  # svalint: disable=R001
            s[key] = value
            return
        if walked:
            self.stats.walks += 1
            ts = None if self._tenant_of is None else self._tstats(key)
            if ts is not None:
                ts.walks += 1
        if self._partitions:
            group = self._group_of(key)
            budget = self._partitions[group] if group is not None \
                else self._shared_ways
            members = self._group_members(s, group)
            if budget > 0 and len(members) >= budget:
                # the group's own budget is full: thrash stays inside it
                self._evict_one(si, among=set(members))
            elif len(s) >= self.ways:
                # set full while this group is under budget (shared pool
                # squeezed to zero, or partitions reconfigured): reclaim
                # shared entries first so protected ways stay protected.
                shared = self._group_members(s, None)
                self._evict_one(si, among=set(shared) if shared else None)
        elif len(s) >= self.ways:
            self._evict_one(si)
        s[key] = value
        self._freq[key] = 1  # svalint: disable=R001
        if self.policy == "gdsfs":
            c = cost if cost is not None and cost > 0 else 1.0
            sp = span if span > 0 else 1.0
            self._meta[key] = [c, sp, self._clock[si] + c / sp]  # svalint: disable=R001
        if self._is_range_key(key):
            self._range_index.setdefault(key[0], {})[key[1]] = key[2]  # svalint: disable=R001
        self._n += 1

    def invalidate(self) -> None:
        """Full invalidation: drop everything (paper's self-invalidation).
        The epoch counter lives on the owning IOMMU — the single owner of
        full-flush state."""
        for s in self._sets:  # svalint: disable=R001
            s.clear()
        self._freq.clear()  # svalint: disable=R001
        self._meta.clear()  # svalint: disable=R001
        self._clock = [0.0] * self.n_sets
        self._range_index.clear()  # svalint: disable=R001
        self._n = 0
        self.stats.invalidations += 1

    def invalidate_key(self, key: Hashable) -> None:
        s = self._sets[self._set_index(key)]  # svalint: disable=R001
        if s.pop(key, None) is not None:
            self._n -= 1
            if self._is_range_key(key):
                self._drop_range(key)
        self._freq.pop(key, None)  # svalint: disable=R001
        self._meta.pop(key, None)  # svalint: disable=R001

    # ---------------------------------------------------------- range entries
    def range_covering(self, asid: int,
                       lp: int) -> Optional[Tuple[int, int]]:
        """The resident range entry covering ``(asid, lp)`` as
        ``(base_lpn, n_pages)``, or None. Resident ranges are disjoint, so
        the lowest covering base (deterministic) is the only one."""
        asid_ranges = self._range_index.get(asid)  # svalint: disable=R001
        if not asid_ranges:
            return None
        best: Optional[Tuple[int, int]] = None
        for base, n in asid_ranges.items():
            if base <= lp < base + n and (best is None or base < best[0]):
                best = (base, n)
        return best

    def ranges_overlapping(self, asid: int, lo: int,
                           hi: int) -> List[Tuple[int, int]]:
        """Resident range entries of ``asid`` intersecting ``[lo, hi]``
        (inclusive), ascending by base."""
        asid_ranges = self._range_index.get(asid)  # svalint: disable=R001
        if not asid_ranges:
            return []
        return sorted((base, n) for base, n in asid_ranges.items()
                      if base <= hi and base + n - 1 >= lo)

    def peek(self, key: Hashable):
        """Value for ``key`` with NO stats and NO replacement-state bump —
        the IOMMU's split path reads a range's base this way."""
        s = (self._set0 if self.n_sets == 1  # svalint: disable=R001
             else self._sets[self._set_index(key)])  # svalint: disable=R001
        return s.get(key)

    @property
    def n_ranges(self) -> int:
        return sum(len(r) for r in self._range_index.values())  # svalint: disable=R001

    def keys(self) -> Iterable[Hashable]:
        out: List[Hashable] = []
        for s in self._sets:  # svalint: disable=R001
            out.extend(s.keys())
        return out

    def __contains__(self, key: Hashable) -> bool:
        s = (self._set0 if self.n_sets == 1  # svalint: disable=R001
             else self._sets[self._set_index(key)])  # svalint: disable=R001
        return key in s

    def __len__(self) -> int:
        return self._n
