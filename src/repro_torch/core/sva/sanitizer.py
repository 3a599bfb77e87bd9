"""svasan — an ASan-style shadow-state sanitizer for the paged SVA stack.

The paper's zero-copy argument only holds if translation state and page
ownership never diverge: an IOTLB entry that outlives its unmap, a write
into a still-shared page, or a double-freed pool page silently corrupts the
very KV data the PTW numbers are measured over. The tier-1 tests pin these
invariants down at the API level; svasan checks them *during every
operation* with an independent shadow copy of the state, so a future
refactor (the continuous-batching scheduler is next) that breaks the
discipline fails loudly at the faulting operation, not three layers later.

Shadow model — one record per physical page, per attached pool:

    FREE   --alloc-->  OWNED  --share-->  SHARED
    FREE  <--free(rc->0)--  OWNED  <--free(rc->1)--  SHARED

with a shadow refcount mirroring (never reading) ``PagePool._ref``.

Detectors (each has an injected-bug test in tests/test_svasan.py):

  double-free               ``free()`` of a page whose shadow state is FREE
  translate-after-unmap     a TLB *hit* for an attached ASID whose live
                            table no longer maps the page (the entry
                            outlived its invalidation), or whose table
                            disagrees with the cached physical page (a
                            remap's invalidation was skipped)
  cow-bypass-write          a decode append about to write a page whose
                            shadow state is SHARED (CoW/steal didn't run)
  stale-prefetch            a prefetch fill installed for, or surviving
                            past, a dead mapping (in-flight fills must die
                            with their unmap/detach)
  stale-range               a range-coalesced IOTLB entry ``(asid, base,
                            n)`` still *covers* a logical page after its
                            unmap — the range outlived the split that the
                            partial invalidation should have forced
  leak-at-release           ``PagedKVManager.release`` returned without
                            dropping the sequence's reference on one of its
                            pages
  cross-tenant-translate    a translation reached the TLB under a tenant
                            identity that does not own the ASID — the
                            multi-tenant isolation gate in
                            ``IOMMU.translate`` was bypassed (svasan
                            re-derives ownership from the tenant registry
                            independently, so a patched-out gate is still
                            caught)

Enabling: set ``REPRO_SVASAN=1`` in the environment (the CI tier-1 job
does), or pass the explicit knobs — ``PagedKVManager(sanitize=True)`` /
``SVASpace(sanitize=True)`` / ``ModelConfig(svasan=True)`` /
``SimConfig(svasan=True)``. Off (the default) the hook sites reduce to one
``is not None`` test each and the stack is bit-identical to the
pre-sanitizer tree; on, svasan only *observes* — it never mutates pool,
TLB, or table state, so clean runs produce identical outputs too.

A violation raises :class:`SanitizerError` carrying a structured
:class:`SvasanReport` (detector, page/key, shadow state, hint); construct
``SVASanitizer(raise_on_report=False)`` to collect reports instead (the
``reports`` list), e.g. to scan for multiple violations in one run.

Stats schema (``SVASanitizer.stats()``; see ARCHITECTURE.md):
pages_tracked / checks / reports.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, Iterable, List, Optional, Tuple

if TYPE_CHECKING:                                  # pragma: no cover
    from repro_torch.core.sva.iommu import IOMMU
    from repro_torch.core.sva.page_pool import PagePool

#: shadow page states
FREE, OWNED, SHARED = "FREE", "OWNED", "SHARED"


def enabled_by_env() -> bool:
    """True when ``REPRO_SVASAN`` is set to anything but ''/'0'."""
    return os.environ.get("REPRO_SVASAN", "") not in ("", "0")


def resolve(sanitize: Optional[bool]) -> bool:
    """Resolve a three-state knob: explicit True/False wins, ``None``
    defers to the ``REPRO_SVASAN`` environment variable."""
    return enabled_by_env() if sanitize is None else bool(sanitize)


@dataclass(frozen=True)
class SvasanReport:
    """One detected violation — the precise, machine-readable record the
    injected-bug tests assert on."""
    detector: str                 # double-free | translate-after-unmap | ...
    page: Optional[int]           # physical page (pool detectors)
    # (asid, logical page) for exact-entry detectors, (asid, base, n) for
    # the stale-range detector.
    key: Optional[Tuple[int, ...]]
    state: str                    # shadow state at detection time
    message: str

    def __str__(self) -> str:
        where = f"page {self.page}" if self.page is not None else \
            f"key {self.key}"
        return (f"svasan[{self.detector}] {where} "
                f"(shadow={self.state}): {self.message}")


class SanitizerError(RuntimeError):
    """Raised at the faulting operation when ``raise_on_report`` (default).
    ``.report`` carries the structured :class:`SvasanReport`."""

    def __init__(self, report: SvasanReport):
        super().__init__(str(report))
        self.report = report


class SVASanitizer:
    """The shadow-state checker. One instance may watch several pools (the
    per-slot layout has one pool per slot) and one IOMMU; attach with
    :meth:`attach_pool` / by assigning ``iommu.sanitizer``."""

    def __init__(self, raise_on_report: bool = True):
        self.raise_on_report = raise_on_report
        self.reports: List[SvasanReport] = []
        self.checks = 0
        # (pool token, page) -> shadow refcount; absent == FREE
        self._rc: Dict[Tuple[int, int], int] = {}
        self._pool_tokens: Dict[int, int] = {}     # id(pool) -> token
        self._next_token = 0

    # ------------------------------------------------------------ plumbing
    def attach_pool(self, pool: "PagePool") -> None:
        """Start shadowing ``pool`` (its pages must all be free — attach at
        construction). Also installs the pool-side hook."""
        if id(pool) not in self._pool_tokens:
            self._pool_tokens[id(pool)] = self._next_token
            self._next_token += 1
        pool.sanitizer = self

    def _token(self, pool: "PagePool") -> int:
        tok = self._pool_tokens.get(id(pool))
        if tok is None:                            # late attach: adopt state
            self.attach_pool(pool)
            tok = self._pool_tokens[id(pool)]
        return tok

    def state(self, pool: "PagePool", page: int) -> str:
        rc = self._rc.get((self._token(pool), page), 0)
        return FREE if rc == 0 else OWNED if rc == 1 else SHARED

    def _report(self, detector: str, message: str,
                page: Optional[int] = None,
                key: Optional[Tuple[int, ...]] = None,
                state: str = FREE) -> None:
        rep = SvasanReport(detector, page, key, state, message)
        self.reports.append(rep)
        if self.raise_on_report:
            raise SanitizerError(rep)

    def stats(self) -> dict:
        return dict(pages_tracked=len(self._rc), checks=self.checks,
                    reports=len(self.reports))

    # ---------------------------------------------------- PagePool hooks
    def on_alloc(self, pool: "PagePool", pages: Iterable[int]) -> None:
        tok = self._token(pool)
        for p in pages:
            self.checks += 1
            if self._rc.get((tok, p), 0):
                self._report(
                    "double-free", "allocator handed out a page that is "
                    "still live in the shadow state (free-list corruption "
                    "or a missed free)", page=p, state=self.state(pool, p))
            self._rc[(tok, p)] = 1

    def on_share(self, pool: "PagePool", pages: Iterable[int]) -> None:
        tok = self._token(pool)
        for p in pages:
            self.checks += 1
            rc = self._rc.get((tok, p), 0)
            if rc == 0:
                self._report(
                    "double-free", "share (refcount++) of a FREE page — "
                    "the mapping being shared no longer owns it",
                    page=p, state=FREE)
            self._rc[(tok, p)] = rc + 1

    def on_free(self, pool: "PagePool", pages: Iterable[int]) -> None:
        tok = self._token(pool)
        for p in pages:
            self.checks += 1
            rc = self._rc.get((tok, p), 0)
            if rc == 0:
                self._report(
                    "double-free", "free of a page whose shadow state is "
                    "already FREE", page=p, state=FREE)
                continue                           # collect mode: keep going
            if rc == 1:
                del self._rc[(tok, p)]
            else:
                self._rc[(tok, p)] = rc - 1

    # ------------------------------------------------------- IOMMU hooks
    def check_hit(self, iommu: "IOMMU", asid: int, page: int,
                  cached_phys: int) -> None:
        """Cross-check a TLB hit against the live table state (called by
        ``IOMMU.translate`` on the hit path). Unattached ASIDs translate
        identity by design — nothing to check."""
        self.checks += 1
        sp = iommu.space(asid)
        if sp is None:
            return
        key = (asid, page)
        if page not in sp.table:
            self._report(
                "translate-after-unmap", "TLB hit for a logical page the "
                "live table no longer maps — the entry outlived its "
                "unmap/invalidation (use-after-free translation)",
                key=key, state=OWNED)
        elif sp.table[page] != cached_phys:
            self._report(
                "translate-after-unmap", f"TLB hit returned physical page "
                f"{cached_phys} but the live table maps logical page "
                f"{page} -> {sp.table[page]} — a remap's invalidation was "
                "skipped (stale translation)", key=key, state=SHARED)

    def check_fill(self, iommu: "IOMMU", key: Tuple[int, int],
                   phys: int) -> None:
        """A prefetch fill is about to install (``_install_pending``). The
        mapping it was issued for must still be live."""
        self.checks += 1
        sp = iommu.space(key[0])
        if sp is not None and key[1] not in sp.table:
            self._report(
                "stale-prefetch", "prefetch fill installing a translation "
                "for a logical page that was unmapped after the fill was "
                "issued — the fill outlived its mapping", key=key,
                state=FREE)

    def check_tenant_translate(self, iommu: "IOMMU",
                               tenant: Optional[str], asid: int,
                               page: int) -> None:
        """A translation is entering the TLB under ``tenant``'s identity:
        the ASID's registered owner must be that tenant. Runs AFTER the
        IOMMU's own isolation gate and re-derives ownership from the
        registry, so a bypassed/patched gate is caught here."""
        self.checks += 1
        owner = iommu._asid_tenant.get(asid)
        if owner is not None and owner != tenant:
            self._report(
                "cross-tenant-translate",
                f"translation issued under tenant {tenant!r} for asid "
                f"{asid} owned by tenant {owner!r} — the isolation gate "
                "was bypassed (a foreign page would have been translated)",
                key=(asid, page), state=OWNED)

    def check_unmapped(self, iommu: "IOMMU", asid: int,
                       lps: Optional[Iterable[int]] = None) -> None:
        """After an unmap/detach of ``asid`` (all pages when ``lps`` is
        None): no TLB entry and no in-flight prefetch may survive for the
        dead keys."""
        self.checks += 1
        dead_ranges: List[Tuple[int, ...]] = []
        if lps is None:
            dead_pending = [k for k in iommu._pending if k[0] == asid]
            dead_tlb = [k for k in iommu.tlb.keys()
                        if k[0] == asid and len(k) == 2]
            dead_ranges = [k for k in iommu.tlb.keys()
                           if k[0] == asid and len(k) == 3]
        else:
            dead = set(lps)
            keys = {(asid, lp) for lp in dead}
            dead_pending = [k for k in iommu._pending if k in keys]
            dead_tlb = [k for k in keys if k in iommu.tlb]
            # Range entries don't key on a single logical page: a
            # (asid, base, n) entry is stale as soon as it still *covers*
            # any dead page — it would keep translating the unmapped page.
            dead_ranges = [
                k for k in iommu.tlb.keys()
                if len(k) == 3 and k[0] == asid
                and any(k[1] <= lp < k[1] + k[2] for lp in dead)]
        if dead_ranges:
            self._report(
                "stale-range", f"{len(dead_ranges)} range entrie(s) still "
                "cover unmapped logical pages — the range outlived a split "
                "or invalidation and would translate a dead mapping",
                key=dead_ranges[0], state=FREE)
        if dead_pending:
            self._report(
                "stale-prefetch", f"{len(dead_pending)} in-flight prefetch "
                "fill(s) survived the unmap of their address space — a "
                "delayed install would resurrect a dead translation",
                key=dead_pending[0], state=FREE)
        elif dead_tlb:
            self._report(
                "translate-after-unmap", f"{len(dead_tlb)} TLB entrie(s) "
                "survived their unmap — the next translate of these keys "
                "hits a dead mapping", key=dead_tlb[0], state=FREE)

    # ----------------------------------------------- PagedKVManager hooks
    def check_write(self, pool: "PagePool", page: int) -> None:
        """A decode append is about to write ``page`` (after the manager's
        CoW-before-write pass): it must be exclusively owned."""
        self.checks += 1
        st = self.state(pool, page)
        if st == SHARED:
            self._report(
                "cow-bypass-write", "decode write targets a page other "
                "mappings still reference and no copy-on-write or "
                "steal-back happened — the write would corrupt the shared "
                "prefix", page=page, state=st)
        elif st == FREE:
            self._report(
                "cow-bypass-write", "decode write targets a FREE page — "
                "the sequence lost ownership before its write landed",
                page=page, state=st)

    def snapshot_rc(self, pool: "PagePool",
                    pages: Iterable[int]) -> Dict[int, int]:
        tok = self._token(pool)
        return {p: self._rc.get((tok, p), 0) for p in set(pages)}

    def check_release(self, pool: "PagePool", seq_id: int,
                      pages: List[int], before: Dict[int, int]) -> None:
        """After ``release(seq_id)`` freed ``pages``: every page's shadow
        refcount must have dropped by exactly the sequence's reference
        count on it (pages can repeat when a partial tail page aliases)."""
        tok = self._token(pool)
        drops: Dict[int, int] = {}
        for p in pages:
            drops[p] = drops.get(p, 0) + 1
        for p, n in drops.items():
            self.checks += 1
            now = self._rc.get((tok, p), 0)
            if now != before.get(p, 0) - n:
                self._report(
                    "leak-at-release", f"release of seq {seq_id} should "
                    f"have dropped {n} reference(s) on the page but its "
                    f"shadow refcount went {before.get(p, 0)} -> {now} — "
                    "the page leaked (it can never be reallocated)",
                    page=p, state=self.state(pool, p))


__all__ = ["FREE", "OWNED", "SHARED", "SVASanitizer", "SanitizerError",
           "SvasanReport", "enabled_by_env", "resolve"]
