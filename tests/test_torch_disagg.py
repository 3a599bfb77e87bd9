"""The port's disaggregated engine against the JAX one: a prefill worker
and a decode worker over one pool, KV handed off by ``migrate`` in share
mode (pages re-attached, zero copy) or copy mode (pages duplicated on the
device). Held on every arrival interleaving of the shared workloads: the
same tokens, ``stats()`` apart from wall-clock fields (``sched``,
``transfer`` and ``disagg`` blocks included) and translation trace
(``("xfer", ...)`` events included). Inside the port, the conformance
matrix of ``tests/test_conformance.py`` (fixed, continuous, disagg-share,
disagg-copy x no tenancy, one tenant, two tenants) is replayed through the
shared harness with a port-side engine constructor."""
import dataclasses
from typing import Dict, Optional

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks.trace_replay import replay_trace  # noqa: E402
from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.configs.paper_soc import PaperSoCConfig  # noqa: E402
from repro.core.serving.disagg import DisaggEngine as JaxDisagg  # noqa: E402
from repro.core.sva.iommu import IOMMU as JaxIOMMU  # noqa: E402
from repro.core.sva.iommu import Sv39Walk as JaxSv39Walk  # noqa: E402
from repro.core.sva.iommu import TLBConfig as JaxTLBConfig  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.deployment import (DeploymentConfig,  # noqa: E402
                                            TenantSpec)
from repro_torch.core.serving.disagg import DisaggEngine  # noqa: E402
from repro_torch.core.serving.engine import ServingEngine  # noqa: E402
from repro_torch.core.sva.iommu import (IOMMU, CountingWalk,  # noqa: E402
                                        Sv39Walk, TLBConfig)
from repro_torch.models import from_jax_params  # noqa: E402
from tests.conformance import (ARRIVAL_CASES, ENGINE_KINDS, POOL,  # noqa: E402
                               drive, pressure_workload)
from tests.test_torch_engine import (_strip_wall_clock,  # noqa: E402
                                     _workload)

ENGINE_KW = dict(max_len=64, page_size=8, record_translation_trace=True)
TENANCIES = ("off", "single", "two")
STRAGGLERS = [0, 0, 9, 9, 0, 4]


def make_port_engine(cfg, params, kind: str, n_slots: int = 4,
                     max_len: int = 64, page_size: int = 8,
                     tenants: Optional[Dict[str, dict]] = None, **engine_kw):
    """The port's counterpart of ``tests.conformance.make_engine``: every
    engine kind on the CPU, ``disagg-*`` splitting the slots evenly."""
    if kind.startswith("disagg-"):
        return DisaggEngine(cfg, params, n_prefill_slots=n_slots // 2,
                            n_decode_slots=n_slots - n_slots // 2,
                            max_len=max_len, page_size=page_size,
                            disagg_mode=kind.split("-", 1)[1],
                            tenants=tenants, device="cpu", **engine_kw)
    return ServingEngine(cfg, params, n_slots=n_slots, max_len=max_len,
                         page_size=page_size, scheduler=kind,
                         tenants=tenants, device="cpu", **engine_kw)


def serve_port(cfg, params, kind, workload, **engine_kw):
    eng = make_port_engine(cfg, params, kind, **engine_kw)
    outs, finished = drive(eng, workload)
    return outs, eng, finished


@pytest.fixture(scope="module")
def setup():
    cfg = reduce_for_smoke(get_config("llama3.2-1b"))
    tcfg = reduce_for_smoke(tconfigs.get_config("llama3.2-1b"))
    params = init_params(cfg, jax.random.key(0))
    tparams = from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                              device="cpu")
    return cfg, tcfg, params, tparams


@pytest.fixture(scope="module")
def ref(setup):
    """The port's unconstrained fixed engine, untenanted: the ground truth
    of the conformance matrix."""
    _, tcfg, _, tparams = setup
    return serve_port(tcfg, tparams, "fixed",
                      pressure_workload(tcfg.vocab_size))[0]


def _assert_same(jeng, teng, wl):
    jouts, _ = drive(jeng, wl)
    touts, _ = drive(teng, wl)
    assert touts == jouts
    assert _strip_wall_clock(teng.stats()) == _strip_wall_clock(jeng.stats())
    assert teng.translation_trace == jeng.translation_trace
    return teng.stats()


def _pair(setup, mode, **kw):
    cfg, tcfg, params, tparams = setup
    split = dict(n_prefill_slots=2, n_decode_slots=2, disagg_mode=mode)
    return (JaxDisagg(cfg, params, **split, **ENGINE_KW, **kw),
            DisaggEngine(tcfg, tparams, **split, **ENGINE_KW, device="cpu",
                         **kw))


@pytest.mark.parametrize("arrival", range(len(ARRIVAL_CASES)))
@pytest.mark.parametrize("name", ["pressure", "prefix"])
@pytest.mark.parametrize("mode", ["share", "copy"])
def test_disagg_matches_jax_engine(setup, mode, name, arrival):
    """Pressure at POOL pages (deferred and cancelled transfers,
    decode-side preemption) and the shared-prefix mix, every arrival
    interleaving, both transfer modes."""
    wl = _workload(name, setup[0].vocab_size, ARRIVAL_CASES[arrival])
    s = _assert_same(*_pair(setup, mode,
                            pool_pages=POOL if name == "pressure" else None),
                     wl)
    assert s["disagg"]["transfers"] >= 1
    assert s["transfer"]["transfers"] == s["disagg"]["transfers"]


def test_disagg_external_xfer_iommu_matches_jax(setup):
    """Transfers priced through a separate transfer IOMMU (a 4-entry IOTLB
    over a no-LLC Sv39 walk): the same cold-walk cost as the JAX engine."""
    wl = _workload("pressure", setup[0].vocab_size, ARRIVAL_CASES[1])
    cfg, tcfg, params, tparams = setup
    split = dict(n_prefill_slots=2, n_decode_slots=2, disagg_mode="share")
    jeng = JaxDisagg(cfg, params, **split, **ENGINE_KW,
                     xfer_iommu=JaxIOMMU(walk_model=JaxSv39Walk(llc=False),
                                         tlb=JaxTLBConfig(4, "lru")))
    teng = DisaggEngine(tcfg, tparams, **split, **ENGINE_KW, device="cpu",
                        xfer_iommu=IOMMU(walk_model=Sv39Walk(llc=False),
                                         tlb=TLBConfig(4, "lru")))
    s = _assert_same(jeng, teng, wl)
    assert s["transfer"]["ptw_cycles"] > 0 and "xfer_iommu" in s["disagg"]


@pytest.mark.parametrize("mode", ["share", "copy"])
def test_disagg_bit_identical_ample_pool(setup, ref, mode):
    """No pool pressure: prefill-worker chunking, migration and the decode
    worker's masked decode reproduce the fixed engine; every request
    carries its first-decode-step stamp."""
    _, tcfg, _, tparams = setup
    outs, eng, done = serve_port(tcfg, tparams, f"disagg-{mode}",
                                 pressure_workload(tcfg.vocab_size))
    assert outs == ref
    assert eng.stats()["disagg"]["transfers"] >= 1
    assert all(r.first_decode_step is not None
               and r.first_decode_step >= r.submitted_step
               for r in done.values())


@pytest.mark.parametrize("mode", ["share", "copy"])
def test_disagg_bit_identical_under_pressure(setup, ref, mode):
    _, tcfg, _, tparams = setup
    outs, eng, _ = serve_port(tcfg, tparams, f"disagg-{mode}",
                              pressure_workload(tcfg.vocab_size),
                              pool_pages=POOL)
    assert outs == ref
    assert eng.stats()["disagg"]["transfers"] >= 1


@pytest.mark.parametrize("mode", ["share", "copy"])
def test_transfer_payload_by_mode(setup, mode):
    """Share hands off table entries only; copy duplicates every page on
    the device, and the decode side's pages then hold the prefill side's
    KV (the copy is real, not only priced)."""
    _, tcfg, _, tparams = setup
    eng = make_port_engine(tcfg, tparams, f"disagg-{mode}")
    seen = []
    real_migrate = eng._migrate

    def migrate(seq_id, dst_slot):      # the prefill side's pages and KV
        pages = list(eng.mgr.seqs[seq_id].pages)
        seen.append((seq_id, pages, [(kv.k_pool[pages].clone(),
                                      kv.v_pool[pages].clone())
                                     for kv in eng.cache]))
        real_migrate(seq_id, dst_slot)

    eng._migrate = migrate
    eng.submit(list(range(3, 3 + 19)), max_tokens=4)      # 3 pages of 8
    while not seen:
        eng.step({})
    eng._apply_cow()
    (sid, src_pages, src_kv), = seen
    t = eng.stats()["transfer"]
    dst_pages = list(eng.mgr.seqs[sid].pages)
    assert t["transfers"] == 1 and len(src_pages) == 3
    if mode == "share":
        assert t["payload_bytes"] == 0 and t["pages_copied"] == 0
        assert dst_pages == src_pages
    else:
        assert t["pages_copied"] == len(src_pages) and t["pages_shared"] == 0
        assert t["payload_bytes"] == (len(src_pages) * 8
                                      * eng.mgr.kv_bytes_per_token)
        assert not set(dst_pages) & set(src_pages)
    n = 19         # the prompt's KV (the same step's decode appends more)
    for kv, (k, v) in zip(eng.cache, src_kv):
        assert k.abs().sum() > 0
        for pool, src in ((kv.k_pool, k), (kv.v_pool, v)):
            assert torch.equal(pool[dst_pages].flatten(0, 1)[:n],
                               src.flatten(0, 1)[:n])
    eng.run()


@pytest.mark.parametrize("mode", ["share", "copy"])
def test_migration_svasan_clean(setup, mode):
    """Migration follows the release/admit refcount discipline, so the
    sanitizer sees balanced refcounts across every transfer, deferral,
    cancellation and decode-side preemption."""
    _, tcfg, _, tparams = setup
    wl = pressure_workload(tcfg.vocab_size, arrivals=STRAGGLERS)
    _, eng, _ = serve_port(dataclasses.replace(tcfg, svasan=True), tparams,
                           f"disagg-{mode}", wl, pool_pages=POOL)
    s = eng.stats()
    assert s["disagg"]["transfers"] >= 1
    assert s["svasan"]["reports"] == 0 and s["svasan"]["checks"] > 0


def test_preempt_during_pending_transfer(setup, ref):
    """A sequence preempted while its transfer is queued cancels the
    transfer and re-queues after its resumed prefill: copy mode under the
    straggler arrivals forces the race, and the tokens do not change."""
    _, tcfg, _, tparams = setup
    outs, eng, _ = serve_port(
        tcfg, tparams, "disagg-copy",
        pressure_workload(tcfg.vocab_size, arrivals=STRAGGLERS),
        pool_pages=POOL)
    d = eng.stats()["disagg"]
    assert d["cancelled"] >= 1 and d["deferred"] >= 1
    assert outs == ref


def test_xfer_trace_replays_end_to_end(setup):
    _, tcfg, _, tparams = setup
    _, eng, _ = serve_port(tcfg, tparams, "disagg-share",
                           pressure_workload(tcfg.vocab_size),
                           pool_pages=POOL, record_translation_trace=True)
    trace = eng.translation_trace
    assert {"xfer", "map", "unmap", "step"} <= {ev[0] for ev in trace}
    assert (sum(1 for ev in trace if ev[0] == "xfer")
            == eng.stats()["transfer"]["transfers"])
    for i, ev in enumerate(trace):
        if ev[0] == "xfer":
            assert ev[3] == "share" and trace[i + 1][0] == "unmap"
            assert trace[i + 2][0] == "map" and trace[i + 2][1] == []
    iommu = IOMMU(walk_model=CountingWalk(), tlb=TLBConfig(8, "lru"))
    per_step = replay_trace(trace, iommu, kv_bytes_per_token=256,
                            compute_per_token=10.0, soc=PaperSoCConfig(),
                            dram_latency=200)
    assert len(per_step) == sum(1 for ev in trace if ev[0] == "step")


def test_disagg_engine_validation(setup):
    _, tcfg, _, tparams = setup
    with pytest.raises(ValueError):
        DisaggEngine(tcfg, tparams, n_prefill_slots=2, n_decode_slots=2,
                     max_len=64, disagg_mode="move", device="cpu")
    with pytest.raises(ValueError):
        DisaggEngine(tcfg, tparams, n_prefill_slots=0, n_decode_slots=4,
                     max_len=64, device="cpu")


# ------------------------------------------------- the conformance matrix

def _tenancy(cfg, kind, tenancy, n_req=6):
    """As in tests/test_conformance.py: quotas equal the whole pool and
    partitioning stays off, so tenancy adds bookkeeping, never behavior."""
    pool = POOL if kind != "fixed" else None
    if tenancy == "off":
        return cfg, None, None, pool
    if tenancy == "single":
        dep = DeploymentConfig((TenantSpec("t0", pool_share=1.0),))
        quota_base = pool if pool is not None else 32   # 4 slots x 8 pages
        return (dep.compile(cfg), dep.tenant_dict(quota_base),
                ("t0",) * n_req, pool)
    return (cfg, {"a": {}, "b": {}},
            tuple("ab"[i % 2] for i in range(n_req)), pool)


@pytest.mark.parametrize("tenancy", TENANCIES)
@pytest.mark.parametrize("kind", ENGINE_KINDS)
def test_cross_engine_matrix(setup, ref, kind, tenancy):
    _, tcfg, _, tparams = setup
    ecfg, tenants, names, pool = _tenancy(tcfg, kind, tenancy)
    wl = pressure_workload(tcfg.vocab_size, tenants=names)
    outs, eng, _ = serve_port(ecfg, tparams, kind, wl, tenants=tenants,
                              pool_pages=pool)
    assert outs == ref
    if tenants is not None:
        s = eng.stats()["tenant"]
        assert sorted(s) == sorted(tenants)
        assert all(b["denials"] == 0 for b in s.values())
        assert sum(b["seqs"] for b in s.values()) == 0   # all released


@pytest.mark.parametrize("arrivals", ARRIVAL_CASES)
def test_two_tenant_interleavings_bit_identical(setup, ref, arrivals):
    _, tcfg, _, tparams = setup
    wl = pressure_workload(tcfg.vocab_size, arrivals=arrivals,
                           tenants=tuple("ab"[i % 2] for i in range(6)))
    outs, _, _ = serve_port(tcfg, tparams, "continuous", wl,
                            tenants={"a": {}, "b": {}}, pool_pages=POOL)
    assert outs == ref


def test_port_fixed_ref_matches_jax(setup, ref):
    """The matrix's ground truth is the JAX fixed engine's too."""
    from tests.conformance import serve
    cfg, _, params, _ = setup
    assert serve(cfg, params, "fixed",
                 pressure_workload(cfg.vocab_size))[0] == ref
