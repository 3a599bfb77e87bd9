"""Physical page pool — the host side of the shared-virtual-address layer.

Mirrors the paper's reserved-DRAM-vs-mapped-pages split: in ``zero_copy``
mode sequences get *mapped* pages (an IOVA range backed by whatever physical
pages are free); in ``copy`` mode admission additionally models the staging
copy into a physically-contiguous region (the paper's baseline).

One instance now typically backs the GLOBAL pool shared by every serving
slot (see core/sva/kv_manager.py), so utilization/high-water stats here are
the fleet-level memory signal, not a per-slot one.

Pure host-side bookkeeping (numpy/ints); the device arrays live in the
compiled step's paged pools. Reference counting enables prefix sharing
(multiple sequences mapping the same physical page, RadixAttention-style).

Free-list policy (deterministic, documented — the contiguity substrate):
the free list is kept **sorted by physical page number** at all times.
``alloc`` hands out the lowest-numbered free pages; ``free`` re-inserts
in address order (``bisect.insort``), so a freed run re-forms in place
and an alloc/free/alloc round-trip preserves run availability. The
historical LIFO recycle order maximized fragmentation for run allocation;
``tests/test_range_tlb.py`` pins the round-trip property. ``alloc_run``
adds first-fit physically-contiguous allocation on top, the producer side
of the IOMMU's range-coalesced IOTLB entries (see iommu.py).

Stats schema (``PoolStats.as_dict()``; surfaced as the ``pool_*`` gauges
of ``PagedKVManager.stats()`` — see ARCHITECTURE.md): allocs / frees /
shares (refcount++ events) / high_water (peak pages in use) /
failed_allocs (OutOfPages raises) / cow_copies (writes that had to
duplicate a shared page) / run_allocs (alloc_run requests satisfied
contiguously) / run_fallbacks (alloc_run requests that fell back to
discontiguous pages).
"""
from __future__ import annotations

from bisect import insort
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np

if TYPE_CHECKING:                                  # pragma: no cover
    from repro_torch.core.sva.sanitizer import SVASanitizer


class OutOfPages(RuntimeError):
    pass


@dataclass
class PoolStats:
    allocs: int = 0
    frees: int = 0
    shares: int = 0
    high_water: int = 0
    failed_allocs: int = 0
    cow_copies: int = 0           # writes that had to duplicate a shared page
    run_allocs: int = 0           # alloc_run satisfied with a contiguous run
    run_fallbacks: int = 0        # alloc_run fell back to discontiguous pages

    def as_dict(self):
        return dict(allocs=self.allocs, frees=self.frees, shares=self.shares,
                    high_water=self.high_water,
                    failed_allocs=self.failed_allocs,
                    cow_copies=self.cow_copies,
                    run_allocs=self.run_allocs,
                    run_fallbacks=self.run_fallbacks)


class PagePool:
    """Fixed-size pool of physical pages with refcounts and an
    address-ordered free list (lowest page first; see module docstring)."""

    def __init__(self, n_pages: int, page_size: int,
                 sanitizer: Optional["SVASanitizer"] = None):
        self.n_pages = n_pages
        self.page_size = page_size
        # Sorted ascending at all times: alloc takes from the front,
        # free re-inserts in address order, so freed runs re-form.
        self._free: List[int] = list(range(n_pages))
        self._ref = np.zeros(n_pages, dtype=np.int32)
        self.stats = PoolStats()
        # svasan shadow-state hook (core/sva/sanitizer.py). None (default)
        # keeps every hot path one attribute test away from the historical
        # behavior; attach via SVASanitizer.attach_pool().
        self.sanitizer: Optional["SVASanitizer"] = None
        if sanitizer is not None:
            sanitizer.attach_pool(self)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_pages - self.n_free

    def alloc(self, n: int) -> List[int]:
        """Allocate the ``n`` lowest-numbered free pages (ascending)."""
        if n > len(self._free):
            self.stats.failed_allocs += 1
            raise OutOfPages(f"need {n} pages, {len(self._free)} free")
        pages = self._free[:n]
        del self._free[:n]
        return self._claim(pages)

    def alloc_run(self, n: int) -> List[int]:
        """Allocate ``n`` pages, physically contiguous if any free run of
        length >= n exists (first-fit over the sorted free list); otherwise
        fall back to the lowest-numbered discontiguous pages. Never fails
        when ``alloc(n)`` would succeed — contiguity is a hint, capacity is
        the contract."""
        if n > len(self._free):
            self.stats.failed_allocs += 1
            raise OutOfPages(f"need {n} pages, {len(self._free)} free")
        if n <= 1:
            self.stats.run_allocs += 1
            pages = self._free[:n]
            del self._free[:n]
            return self._claim(pages)
        free = self._free
        run_start = 0                     # index into free where the run began
        for i in range(1, len(free)):
            if free[i] != free[i - 1] + 1:
                run_start = i
            if i - run_start + 1 == n:    # first fit
                lo = run_start
                pages = free[lo:lo + n]
                del free[lo:lo + n]
                self.stats.run_allocs += 1
                return self._claim(pages)
        self.stats.run_fallbacks += 1
        pages = free[:n]
        del free[:n]
        return self._claim(pages)

    def _claim(self, pages: List[int]) -> List[int]:
        if self.sanitizer is not None:
            self.sanitizer.on_alloc(self, pages)
        for p in pages:
            assert self._ref[p] == 0
            self._ref[p] = 1
        self.stats.allocs += len(pages)
        self.stats.high_water = max(self.stats.high_water, self.n_used)
        return pages

    def share(self, pages: List[int]) -> None:
        """Refcount++ (prefix sharing: a second sequence maps the same pages)."""
        if self.sanitizer is not None:
            self.sanitizer.on_share(self, pages)
        for p in pages:
            assert self._ref[p] > 0, f"share of unmapped page {p}"
            self._ref[p] += 1
        self.stats.shares += len(pages)

    def free(self, pages: List[int]) -> None:
        # sanitizer first: a double-free raises a precise SanitizerError
        # before the bare assert below would trip
        if self.sanitizer is not None:
            self.sanitizer.on_free(self, pages)
        for p in pages:
            assert self._ref[p] > 0, f"double free of page {p}"
            self._ref[p] -= 1
            if self._ref[p] == 0:
                # order-preserving free: re-insert in address order so a
                # freed run re-forms in place (see module docstring)
                insort(self._free, p)
        self.stats.frees += len(pages)

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def total_refs(self) -> int:
        """Total live mappings (sum of refcounts). This is the gauge
        tenant page quotas meter against: a prefix page shared by two
        sequences counts twice, exactly like ``len(SeqState.pages)`` does
        in ``PagedKVManager.tenant_pages_used`` — so the sum of every
        tenant's mapped pages plus the prefix cache's own holds must
        reconcile with this number (pinned by tests/test_multitenant.py)."""
        return int(self._ref.sum())

    def is_shared(self, page: int) -> bool:
        """True when more than one mapping references ``page`` — a write
        through any single mapping must copy-on-write first."""
        return int(self._ref[page]) > 1

    @property
    def utilization(self) -> float:
        """Fraction of pages currently mapped (global-pool pressure gauge)."""
        return self.n_used / self.n_pages if self.n_pages else 0.0

    def free_runs(self) -> List[Tuple[int, int]]:
        """Maximal contiguous free runs as ``(start_page, length)`` pairs,
        ascending — the fragmentation picture ``alloc_run`` allocates from."""
        runs: List[Tuple[int, int]] = []
        for p in self._free:
            if runs and p == runs[-1][0] + runs[-1][1]:
                runs[-1] = (runs[-1][0], runs[-1][1] + 1)
            else:
                runs.append((p, 1))
        return runs

    def check_invariants(self) -> None:
        free_set = set(self._free)
        assert len(free_set) == len(self._free), "free list has duplicates"
        assert self._free == sorted(self._free), "free list out of order"
        for p in range(self.n_pages):
            if p in free_set:
                assert self._ref[p] == 0, f"free page {p} has refs"
            else:
                assert self._ref[p] > 0, f"used page {p} has no refs"
