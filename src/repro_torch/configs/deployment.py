"""Declarative multi-tenant deployment descriptions.

A deployment is tenants x pool shares x IOTLB geometry x translation
knobs, written as data and validated at construction, then compiled onto
a base :class:`~repro_torch.configs.base.ModelConfig`:

    dep = DeploymentConfig(
        tenants=(TenantSpec("acme", pool_share=0.5, tlb_ways=2),
                 TenantSpec("bravo", pool_share=0.25, tlb_ways=1)),
        tlb_entries=1024, tlb_ways=4)
    cfg = dep.compile(get_config("llama3.2-1b"))      # TLB geometry applied
    eng = ServingEngine(cfg, params, n_slots, max_len,
                        tenants=dep.tenant_dict(pool_pages))

Shares are fractions of the ENGINE's page pool (whose size is only known
at engine construction), so they compile to page quotas via
:meth:`DeploymentConfig.tenant_dict`. ``tlb_ways`` on a
:class:`TenantSpec` reserves private IOTLB ways for that tenant
(``TLBConfig.partitions`` — see core/sva/tlb.py); ways left over stay a
shared pool every tenant may use.

Everything is validated twice: structural errors (duplicate tenants,
over-committed shares, partitions exceeding the declared ways) raise at
construction; errors that need the base config (partitioning a
fully-associative TLB, partitions + the geometry auto-tuner) raise in
:meth:`DeploymentConfig.compile`. The error strings are pinned by
``tests/test_multitenant.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig

__all__ = ["TenantSpec", "DeploymentConfig", "two_tenant_demo"]


@dataclass(frozen=True)
class TenantSpec:
    """One tenant: a share of the page pool, an optional private
    prefix-cache share, and optional private IOTLB ways. All knobs
    default to "unlimited/shared" — a ``TenantSpec("x")`` tenant gets
    isolation (own ASIDs, own prefix scope) and nothing else."""
    name: str
    pool_share: float = 0.0       # fraction of pool pages -> quota_pages
    prefix_share: float = 0.0     # fraction -> quota_prefix_pages
    tlb_ways: int = 0             # private IOTLB ways (0 = shared only)

    def __post_init__(self):
        if not isinstance(self.name, str) or not self.name:
            raise ValueError(f"tenant name {self.name!r} "
                             "(need a non-empty string)")
        for knob in ("pool_share", "prefix_share"):
            v = getattr(self, knob)
            if not 0.0 <= float(v) <= 1.0:
                raise ValueError(
                    f"tenant {self.name!r}: {knob}={v} (need 0.0..1.0)")
        if not isinstance(self.tlb_ways, int) or self.tlb_ways < 0:
            raise ValueError(
                f"tenant {self.name!r}: tlb_ways={self.tlb_ways!r} "
                "(need an int >= 0)")


@dataclass(frozen=True)
class DeploymentConfig:
    """Tenants + serving-IOTLB geometry overrides (0/"" = inherit the
    base config's ``serve_tlb_*`` value)."""
    tenants: Tuple[TenantSpec, ...]
    tlb_entries: int = 0
    tlb_ways: int = 0
    tlb_policy: str = ""
    tlb_ranges: int = 0
    prefetch_policy: str = ""     # "" = inherit; none | next_page | stream
    autotune_interval: int = 0    # geometry auto-tune (exclusive w/ ways)

    def __post_init__(self):
        if not self.tenants:
            raise ValueError("a deployment needs at least one tenant")
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in {names}")
        pool = sum(t.pool_share for t in self.tenants)
        if pool > 1.0 + 1e-9:
            raise ValueError(
                f"tenant pool_shares sum to {pool:.3f} (over-committed; "
                "need <= 1.0)")
        if sum(t.prefix_share for t in self.tenants) > 1.0 + 1e-9:
            raise ValueError("tenant prefix_shares sum over 1.0")
        part = sum(t.tlb_ways for t in self.tenants)
        if self.tlb_ways and part > self.tlb_ways:
            raise ValueError(
                f"tenant tlb_ways reserve {part} ways but the deployment "
                f"TLB has {self.tlb_ways}")
        if self.autotune_interval and part:
            raise ValueError(
                "TLB way partitions and the geometry auto-tuner are "
                "mutually exclusive (a retune would drop the partitions)")

    # ------------------------------------------------------------ compile
    def compile(self, base: ModelConfig) -> ModelConfig:
        """Apply the deployment's TLB geometry onto ``base`` and validate
        the parts that need the resolved geometry."""
        kw: Dict[str, object] = {}
        if self.tlb_entries:
            kw["serve_tlb_entries"] = self.tlb_entries
        if self.tlb_ways:
            kw["serve_tlb_ways"] = self.tlb_ways
        if self.tlb_policy:
            kw["serve_tlb_policy"] = self.tlb_policy
        if self.tlb_ranges:
            kw["serve_tlb_ranges"] = self.tlb_ranges
        if self.prefetch_policy:
            kw["serve_tlb_prefetch_policy"] = self.prefetch_policy
        if self.autotune_interval:
            kw["serve_tlb_autotune"] = self.autotune_interval
        cfg = dataclasses.replace(base, **kw) if kw else base
        part = sum(t.tlb_ways for t in self.tenants)
        if part:
            if not cfg.serve_tlb_ways:
                raise ValueError(
                    "tenant tlb_ways need a set-associative serving TLB "
                    "(set tlb_ways on the deployment or serve_tlb_ways "
                    "on the config)")
            if part > cfg.serve_tlb_ways:
                raise ValueError(
                    f"tenant tlb_ways reserve {part} ways but the "
                    f"serving TLB has {cfg.serve_tlb_ways}")
            if cfg.serve_tlb_autotune:
                raise ValueError(
                    "TLB way partitions and the geometry auto-tuner are "
                    "mutually exclusive (a retune would drop the "
                    "partitions)")
        return cfg

    def tenant_dict(self, pool_pages: int) -> Dict[str, dict]:
        """Resolve shares against a concrete pool size: the ``tenants=``
        mapping :class:`~repro_torch.core.sva.kv_manager.PagedKVManager` (and
        the engines) take. Shares floor to whole pages; a nonzero share
        always grants at least one page."""
        if pool_pages < 1:
            raise ValueError(f"pool_pages={pool_pages} (need >= 1)")
        out: Dict[str, dict] = {}
        for t in self.tenants:
            spec: Dict[str, int] = {}
            if t.pool_share:
                spec["quota_pages"] = max(1, int(t.pool_share * pool_pages))
            if t.prefix_share:
                spec["quota_prefix_pages"] = max(
                    1, int(t.prefix_share * pool_pages))
            if t.tlb_ways:
                spec["tlb_ways"] = t.tlb_ways
            out[t.name] = spec
        return out

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(t.name for t in self.tenants)


def two_tenant_demo(partitioned: bool = True,
                    ways: int = 4) -> "DeploymentConfig":
    """The benchmarks' stock two-tenant deployment: tenant ``a`` holds
    half the pool with 2 private ways, tenant ``b`` a quarter with 1;
    ``partitioned=False`` keeps the quotas but shares the whole TLB (the
    A/B's control arm)."""
    return DeploymentConfig(
        tenants=(TenantSpec("a", pool_share=0.5,
                            tlb_ways=2 if partitioned else 0),
                 TenantSpec("b", pool_share=0.25,
                            tlb_ways=1 if partitioned else 0)),
        tlb_ways=ways)
