"""The port's continuous-batching engine against the JAX one: chunked
prefill through the prefix path, masked decode at full slot width, and
preemption and resume under pool pressure give the same tokens, the same
``stats()`` (its ``sched`` block included) apart from wall-clock fields,
and the same translation trace (preempt/resume events included) on every
arrival interleaving of the shared workloads; and inside the port the
continuous engine reproduces the fixed engine token for token."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks.trace_replay import replay_trace  # noqa: E402
from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.configs.paper_soc import PaperSoCConfig  # noqa: E402
from repro.core.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.core.sva.iommu import IOMMU, CountingWalk, TLBConfig  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.serving.engine import ServingEngine  # noqa: E402
from repro_torch.core.serving.scheduler import Scheduler  # noqa: E402
from repro_torch.core.serving.sequence_buffer import SequenceBuffer  # noqa: E402
from repro_torch.core.sva.kv_manager import PagedKVManager  # noqa: E402
from repro_torch.models import from_jax_params  # noqa: E402
from tests.conformance import (ARRIVAL_CASES, POOL, drive,  # noqa: E402
                               pressure_workload)
from tests.test_torch_engine import (_strip_wall_clock,  # noqa: E402
                                     _workload)

ENGINE_KW = dict(n_slots=4, max_len=64, page_size=8,
                 record_translation_trace=True)


@pytest.fixture(scope="module")
def setup():
    cfg = reduce_for_smoke(get_config("llama3.2-1b"))
    tcfg = reduce_for_smoke(tconfigs.get_config("llama3.2-1b"))
    params = init_params(cfg, jax.random.key(0))
    tparams = from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                              device="cpu")
    return cfg, tcfg, params, tparams


@pytest.fixture(scope="module")
def fixed_ref(setup):
    """The port's fixed engine on the pressure workload, ample pool: the
    tokens every scheduler must reproduce."""
    _, tcfg, _, tparams = setup
    eng = ServingEngine(tcfg, tparams, n_slots=4, max_len=64, page_size=8,
                        device="cpu")
    return drive(eng, pressure_workload(tcfg.vocab_size))[0]


def _port(setup, **kw):
    _, tcfg, _, tparams = setup
    return ServingEngine(tcfg, tparams, device="cpu", **kw)


@pytest.mark.parametrize("arrival", range(len(ARRIVAL_CASES)))
@pytest.mark.parametrize("name", ["pressure", "prefix"])
def test_continuous_matches_jax_engine(setup, name, arrival):
    """Pressure at POOL pages (preempt/resume) and the shared-prefix mix
    (prefix hits, CoW), on every arrival interleaving."""
    cfg, _, params, _ = setup
    wl = _workload(name, cfg.vocab_size, ARRIVAL_CASES[arrival])
    kw = dict(ENGINE_KW, scheduler="continuous",
              pool_pages=POOL if name == "pressure" else None)
    jeng = JaxEngine(cfg, params, **kw)
    jouts, _ = drive(jeng, wl)
    teng = _port(setup, **kw)
    touts, _ = drive(teng, wl)
    assert touts == jouts
    assert _strip_wall_clock(teng.stats()) == _strip_wall_clock(jeng.stats())
    assert teng.translation_trace == jeng.translation_trace
    st = teng.stats()
    assert st["staging_copies"] == 0
    if name == "pressure":
        assert st["sched"]["preemptions"] >= 1
    else:
        assert st["shared_admissions"] > 0


def test_continuous_matches_fixed_ample_pool(setup, fixed_ref):
    """No pool pressure: chunked prefill and masked decode reproduce the
    fixed engine token for token, and nothing is preempted."""
    eng = _port(setup, n_slots=4, max_len=64, page_size=8,
                scheduler="continuous")
    assert drive(eng, pressure_workload(setup[1].vocab_size))[0] == fixed_ref
    assert eng.stats()["sched"]["preemptions"] == 0


def test_preempt_resume_bit_identical_under_pressure(setup, fixed_ref):
    """A pool of POOL pages: the engine preempts and resumes and still gives
    the unconstrained tokens (the pending token re-injected, max_tokens
    rebased, the KV rebuilt from warm prefix pages)."""
    eng = _port(setup, n_slots=4, max_len=64, page_size=8,
                scheduler="continuous", pool_pages=POOL)
    outs, done = drive(eng, pressure_workload(setup[1].vocab_size))
    s = eng.stats()
    assert s["sched"]["preemptions"] >= 1 and s["sched"]["resumes"] >= 1
    assert s["preemptions"] == s["sched"]["preemptions"]    # manager mirror
    assert outs == fixed_ref
    assert all(r.first_decode_step is not None
               and r.first_decode_step >= r.first_token_step
               for r in done.values())


@pytest.mark.parametrize("arrivals", ARRIVAL_CASES)
def test_interleaving_bit_identity(setup, fixed_ref, arrivals):
    eng = _port(setup, n_slots=4, max_len=64, page_size=8,
                scheduler="continuous", pool_pages=POOL)
    wl = pressure_workload(setup[1].vocab_size, arrivals=arrivals)
    assert drive(eng, wl)[0] == fixed_ref


def test_preemption_svasan_clean(setup):
    """Preempt mirrors release under the translation sanitizer: no stale
    mapping, leak or double free across preempt/resume round trips."""
    _, tcfg, _, tparams = setup
    eng = ServingEngine(dataclasses.replace(tcfg, svasan=True), tparams,
                        n_slots=4, max_len=64, page_size=8, device="cpu",
                        scheduler="continuous", pool_pages=POOL)
    drive(eng, pressure_workload(tcfg.vocab_size))
    s = eng.stats()
    assert s["sched"]["preemptions"] >= 1
    assert s["svasan"]["reports"] == 0 and s["svasan"]["checks"] > 0


def test_preemption_trace_replays_end_to_end(setup):
    """The port's continuous trace carries preempt/resume events and
    replays through the IOMMU cost model."""
    eng = _port(setup, scheduler="continuous", pool_pages=POOL, **ENGINE_KW)
    drive(eng, pressure_workload(setup[1].vocab_size))
    trace = eng.translation_trace
    assert {"preempt", "resume", "map", "unmap", "step"} <= {
        ev[0] for ev in trace}
    iommu = IOMMU(walk_model=CountingWalk(), tlb=TLBConfig(8, "lru"))
    per_step = replay_trace(trace, iommu, kv_bytes_per_token=256,
                            compute_per_token=10.0, soc=PaperSoCConfig(),
                            dram_latency=200)
    assert len(per_step) == sum(1 for ev in trace if ev[0] == "step")


def test_continuous_eos_matches_fixed(setup):
    """A request stops at the eos token in the continuous engine as in the
    fixed one."""
    _, tcfg, _, tparams = setup
    wl = pressure_workload(tcfg.vocab_size, n=3)
    kw = dict(n_slots=4, max_len=64, page_size=8, device="cpu")
    first, _ = drive(ServingEngine(tcfg, tparams, **kw), wl)
    eos = first[0][2]
    fixed, _ = drive(ServingEngine(tcfg, tparams, eos_token=eos, **kw), wl)
    cont, _ = drive(ServingEngine(tcfg, tparams, eos_token=eos,
                                  scheduler="continuous", pool_pages=POOL,
                                  **kw), wl)
    assert cont == fixed and cont[0] == first[0][:first[0].index(eos) + 1]


def test_continuous_submit_and_knob_validation(setup):
    eng = _port(setup, n_slots=2, max_len=32, scheduler="continuous")
    with pytest.raises(ValueError, match="non-empty prompt"):
        eng.submit([], max_tokens=4)
    assert not eng.has_work
    eng.submit([5, 6, 7], max_tokens=2)
    assert eng.has_work
    eng.step({})
    assert eng.has_work and eng.sched.has_work
    mgr = PagedKVManager(n_slots=2, max_pages_per_slot=4, page_size=8)
    buf = SequenceBuffer(2, 32)
    for budget, chunk in ((0, 8), (8, 0)):
        with pytest.raises(ValueError):
            Scheduler(mgr, buf, token_budget=budget, prefill_chunk=chunk)


def test_masked_decode_takes_tokens_on_the_device(setup, monkeypatch):
    """The masked decode runs at full slot width with every non-decoding
    row's table all NULL and its length 0, and only the argmax tokens
    leave the device: no (B, V) logits are copied to the host."""
    from repro_torch.core.serving import engine as eng_mod
    _, tcfg, _, tparams = setup
    seen = []
    real = eng_mod.forward_decode

    def spy(cfg, params, token, pos, cache):
        seen.append((token.clone(), pos.clone(),
                     cache[0].block_table.clone()))
        return real(cfg, params, token, pos, cache)

    monkeypatch.setattr(eng_mod, "forward_decode", spy)
    eng = _port(setup, n_slots=4, max_len=64, page_size=8,
                scheduler="continuous")
    copied = []
    real_cpu = torch.Tensor.cpu

    def cpu(t, *a, **k):
        copied.append(tuple(t.shape))
        return real_cpu(t, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    drive(eng, pressure_workload(tcfg.vocab_size, n=3))
    monkeypatch.undo()
    assert seen and all(t.shape == (4, 1) for t, _, _ in seen)
    assert all(len(s) == 1 for s in copied)          # (B,) tokens only
    for token, pos, table in seen:
        idle = pos == 0                  # a decoding row holds its prompt
        assert idle.any() and (table[idle] == eng.null_page).all()
        assert (token[idle] == 0).all()
