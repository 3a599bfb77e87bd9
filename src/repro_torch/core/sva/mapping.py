"""Host mapping API — the driver/ioctl analogue of the paper's §III-B.

``SVASpace`` owns a PagePool and hands out *mappings*; translation is
delegated to the unified :class:`~repro_torch.core.sva.iommu.IOMMU` front-end —
every mapping handle is a PASID-style ASID with its own
:class:`~repro_torch.core.sva.iommu.IOAddressSpace`. Two offload modes,
benchmarked against each other exactly like the paper's Fig. 2:

  zero_copy  map(): allocate pages, install IOMMU translations, write table
             entries (24 B per 4 KiB in the paper; here one int32 per page)
             — no data movement.
  copy       stage(): model/perform the physical copy into a contiguous
             staging region before the device can access it (physically
             addressed: no IOMMU mapping at all).

Costs are tracked in abstract units (bytes moved, table entries written,
map calls) so both the simulator and the TPU-level benchmarks can consume
them. The two modes use DISJOINT counters: ``map_calls`` /
``table_entries_written`` / ``bytes_mapped`` count only zero-copy mapping
work, ``stage_calls`` / ``bytes_copied`` only staging work — so a Fig.2-style
zero-copy-vs-copy A/B never sees one mode's admissions leak into the other
mode's columns.

TLB semantics mirror the paper's two invalidation granularities:
``map``/``extend`` warm per-page translations, ``unmap`` self-invalidates
only the unmapped ASID's entries (device translations for OTHER mappings
stay warm), and ``invalidate_epoch`` performs the Listing-1 full flush.

Stats schema (``stats_dict()``; see ARCHITECTURE.md): the ``sva:`` block
is ``SVAStats.as_dict()`` — map_calls / unmap_calls /
table_entries_written / bytes_mapped (zero-copy counters) + stage_calls /
bytes_copied (staging counters) + host_seconds — merged with the owning
IOMMU's ``tlb:`` / ``walk:`` / ``epoch`` / ``asids`` sections.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.sva.iommu import IOMMU, CountingWalk, TLBConfig
from repro_torch.core.sva.page_pool import PagePool
from repro_torch.core.sva.sanitizer import SVASanitizer
from repro_torch.core.sva.sanitizer import resolve as _resolve_sanitize


@dataclass
class Mapping:
    handle: int
    pages: List[int]              # physical page ids, logical order
    n_bytes: int
    shared_prefix_pages: int = 0  # pages shared from another mapping

    @property
    def table(self) -> np.ndarray:
        return np.asarray(self.pages, dtype=np.int32)


@dataclass
class SVAStats:
    map_calls: int = 0
    unmap_calls: int = 0
    table_entries_written: int = 0
    bytes_copied: int = 0         # copy-mode staging traffic
    bytes_mapped: int = 0
    stage_calls: int = 0          # copy-mode admissions (dedicated counter)
    host_seconds: float = 0.0

    def as_dict(self):
        return dict(map_calls=self.map_calls, unmap_calls=self.unmap_calls,
                    table_entries_written=self.table_entries_written,
                    bytes_copied=self.bytes_copied,
                    bytes_mapped=self.bytes_mapped,
                    stage_calls=self.stage_calls,
                    host_seconds=round(self.host_seconds, 6))


class SVASpace:
    """A shared virtual address space over a page pool — a thin client of
    the unified IOMMU front-end (one ASID per mapping handle)."""

    def __init__(self, pool: PagePool, tlb_entries: int = 1024,
                 tlb_policy: str = "lru",
                 sanitize: Optional[bool] = None):
        self.pool = pool
        self.iommu = IOMMU(walk_model=CountingWalk(),
                           tlb=TLBConfig(tlb_entries, tlb_policy))
        self.stats = SVAStats()
        self._next = 1
        self._maps: Dict[int, Mapping] = {}
        # svasan (core/sva/sanitizer.py): ``sanitize=None`` defers to the
        # REPRO_SVASAN environment knob; off is the historical behavior.
        self.sanitizer = (SVASanitizer() if _resolve_sanitize(sanitize)
                          else None)
        if self.sanitizer is not None:
            self.sanitizer.attach_pool(pool)
            self.iommu.sanitizer = self.sanitizer

    @property
    def tlb(self):
        """The IOMMU's shared translation cache (stats / test hook)."""
        return self.iommu.tlb

    # ------------------------------------------------------------- internal
    def _allocate(self, n_bytes: int,
                  share_prefix_from: Optional[Mapping] = None,
                  prefix_pages: int = 0) -> Mapping:
        """Allocate pages + register a Mapping WITHOUT touching any mode
        counter (shared by ``map`` and ``stage`` so the two admission modes
        keep disjoint stats)."""
        page_bytes = self.pool.page_size
        n_pages = -(-n_bytes // page_bytes)
        shared: List[int] = []
        if share_prefix_from is not None and prefix_pages > 0:
            shared = share_prefix_from.pages[:prefix_pages]
            self.pool.share(shared)  # svalint: disable=R002
        fresh = self.pool.alloc(n_pages - len(shared))  # svalint: disable=R002
        m = Mapping(self._next, shared + fresh, n_bytes, len(shared))
        self._next += 1
        self._maps[m.handle] = m
        return m

    # ----------------------------------------------------------- zero-copy
    def map(self, n_bytes: int,
            share_prefix_from: Optional[Mapping] = None,
            prefix_pages: int = 0) -> Mapping:
        """Zero-copy: allocate pages and write block-table entries only."""
        t0 = time.perf_counter()
        m = self._allocate(n_bytes, share_prefix_from, prefix_pages)
        self.stats.map_calls += 1
        self.stats.table_entries_written += len(m.pages)
        self.stats.bytes_mapped += n_bytes
        self.iommu.attach(m.handle).map(m.pages)
        self.stats.host_seconds += time.perf_counter() - t0
        return m

    def extend(self, m: Mapping, n_new_pages: int = 1) -> List[int]:
        """Grow a mapping (decode appends crossing a page boundary).

        Keeps ``Mapping.n_bytes`` and ``stats.bytes_mapped`` in sync so
        decode-driven growth shows up in the memory-pressure stats (it used
        to grow ``m.pages`` silently, leaving both stale)."""
        t0 = time.perf_counter()
        fresh = self.pool.alloc(n_new_pages)  # svalint: disable=R002
        grown_bytes = n_new_pages * self.pool.page_size
        sp = self.iommu.space(m.handle)
        if sp is not None:
            sp.extend(fresh)
        m.pages.extend(fresh)
        m.n_bytes += grown_bytes
        self.stats.bytes_mapped += grown_bytes
        self.stats.table_entries_written += n_new_pages
        self.stats.host_seconds += time.perf_counter() - t0
        return fresh

    def unmap(self, m: Mapping) -> None:
        """Release a mapping, invalidating ONLY its own translations.

        A whole-TLB (epoch) flush per unmap would force a full re-walk /
        full-table re-upload for every OTHER live mapping each time one
        request completes; per-ASID invalidation keeps their translations
        warm. The Listing-1 full flush is ``invalidate_epoch()``."""
        t0 = time.perf_counter()
        self.pool.free(m.pages)  # svalint: disable=R002
        self._maps.pop(m.handle, None)
        self.stats.unmap_calls += 1
        self.iommu.detach(m.handle)
        self.stats.host_seconds += time.perf_counter() - t0

    def translate(self, m: Mapping, logical_page: int):
        """Device-side translation through the shared IOTLB: returns
        (physical page, walk cost, hit)."""
        sp = self.iommu.space(m.handle)
        if sp is None:
            raise KeyError(f"mapping {m.handle} has no IOMMU address space "
                           "(staged mappings are physically addressed)")
        return sp.translate(logical_page)

    def invalidate_epoch(self) -> None:
        """Full translation flush (paper Listing 1)."""
        self.iommu.invalidate()

    # ----------------------------------------------------------- copy mode
    def stage(self, n_bytes: int, do_copy=None) -> Mapping:
        """Copy-based baseline: contiguous staging (models the reserved
        physically-addressed DRAM region — no IOMMU mapping is created).
        ``do_copy(n_bytes)`` performs the actual data movement when the
        caller has real buffers.

        Tracked in DEDICATED counters (``stage_calls`` / ``bytes_copied``):
        it no longer routes through ``map()``, so copy-mode admissions never
        inflate ``map_calls`` / ``table_entries_written`` / ``bytes_mapped``
        and corrupt a zero-copy-vs-copy A/B."""
        t0 = time.perf_counter()
        m = self._allocate(n_bytes)
        m.shared_prefix_pages = 0
        if do_copy is not None:
            do_copy(n_bytes)
        self.stats.stage_calls += 1
        self.stats.bytes_copied += n_bytes    # pays the copy, not the map
        self.stats.host_seconds += time.perf_counter() - t0
        return m

    # --------------------------------------------------------------- stats
    def stats_dict(self) -> dict:
        """Unified stats schema: host-side counters + the IOMMU's
        translation sections (see ARCHITECTURE.md)."""
        return {"sva": self.stats.as_dict(), **self.iommu.stats()}
