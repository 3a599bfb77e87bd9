"""Shared-virtual-address layer: page pool, the unified IOMMU translation
front-end, host mapping API, and the paged KV manager binding them to the
serving engine.

One translation implementation serves every client
(:class:`~repro_torch.core.sva.iommu.IOMMU`): the performance simulator attaches
a 4-entry ``lru`` IOTLB over the ``Sv39Walk`` cost model, the serving
engine a large delta-upload cache over ``CountingWalk`` — same class,
different :class:`~repro_torch.core.sva.iommu.TLBConfig`. Prefix sharing +
copy-on-write: :class:`PrefixIndex` (kv_manager) gives the pool
RadixAttention-style content addressing — admissions map an already-
resident prompt prefix via refcount++ (zero-copy across *requests*, the
paper's map-don't-copy result one level up), writes into shared pages CoW,
and released prompts persist as a warm prefix cache with policy-pluggable
(lru/lfu, optionally capped) eviction.

Runtime checking: :mod:`~repro_torch.core.sva.sanitizer` ("svasan") is an opt-in
ASan-style shadow-state checker over the whole layer — per-page
FREE/OWNED/SHARED state machine, translate-after-unmap and stale-prefetch
cross-checks, CoW-bypass and leak detection. Enable with ``REPRO_SVASAN=1``
or the per-constructor ``sanitize=True`` knobs; zero overhead when off.
"""
from repro_torch.core.sva.iommu import (IOMMU, CountingWalk, IOAddressSpace,
                                  Sv39Walk, TLBConfig, WalkModel, WalkStats)
from repro_torch.core.sva.kv_manager import (CapacityError, PagedKVManager,
                                       PrefixIndex, PrefixStats, SeqState)
from repro_torch.core.sva.mapping import Mapping, SVASpace, SVAStats
from repro_torch.core.sva.page_pool import OutOfPages, PagePool, PoolStats
from repro_torch.core.sva.sanitizer import (SanitizerError, SVASanitizer,
                                      SvasanReport)
from repro_torch.core.sva.tlb import TLBStats, TranslationCache

__all__ = ["CapacityError", "CountingWalk", "IOAddressSpace", "IOMMU",
           "Mapping", "OutOfPages", "PagePool", "PagedKVManager",
           "PoolStats", "PrefixIndex", "PrefixStats", "SVASanitizer",
           "SVASpace", "SVAStats", "SanitizerError", "SeqState",
           "Sv39Walk", "SvasanReport", "TLBConfig", "TLBStats",
           "TranslationCache", "WalkModel", "WalkStats"]
