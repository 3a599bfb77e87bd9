"""The port's zero-copy serving engine against the JAX ServingEngine (fixed
scheduler, zero_copy) on the shared conformance workloads: the same tokens,
the same ``stats()`` apart from wall-clock fields, and the same translation
trace, with the same weights on both sides."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.core.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.serving.engine import ServingEngine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import from_jax_params  # noqa: E402
from tests.conformance import (ARRIVAL_CASES, POOL, Workload,  # noqa: E402
                               drive, prefix_workload, pressure_workload)

ENGINE_KW = dict(n_slots=4, max_len=64, page_size=8,
                 record_translation_trace=True)
WALL_CLOCK = ("prefill_s", "decode_s", "admit_s")


@pytest.fixture(scope="module")
def setup():
    cfg = reduce_for_smoke(get_config("llama3.2-1b"))
    tcfg = reduce_for_smoke(tconfigs.get_config("llama3.2-1b"))
    params = init_params(cfg, jax.random.key(0))
    tparams = from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                              device="cpu")
    return cfg, tcfg, params, tparams


def _workload(name, vocab, arrivals):
    base = (prefix_workload(vocab) if name == "prefix"
            else pressure_workload(vocab))
    return Workload(base.prompts, base.maxtoks, arrivals=tuple(arrivals))


def _strip_wall_clock(stats):
    s = {k: v for k, v in stats.items() if k not in WALL_CLOCK}
    s["sva"] = {k: v for k, v in s["sva"].items() if k != "host_seconds"}
    return s


def _assert_same(jeng, teng, wl):
    jouts, _ = drive(jeng, wl)
    touts, _ = drive(teng, wl)
    assert touts == jouts
    assert _strip_wall_clock(teng.stats()) == _strip_wall_clock(jeng.stats())
    assert teng.translation_trace == jeng.translation_trace
    return touts


def _engines(setup, **kw):
    cfg, tcfg, params, tparams = setup
    return (JaxEngine(cfg, params, **ENGINE_KW, **kw),
            ServingEngine(tcfg, tparams, device="cpu", **ENGINE_KW, **kw))


@pytest.mark.parametrize("arrival", [1, 3])
@pytest.mark.parametrize("name", ["prefix", "pressure"])
def test_engine_matches_jax_engine(setup, name, arrival):
    wl = _workload(name, setup[0].vocab_size, ARRIVAL_CASES[arrival])
    jeng, teng = _engines(setup)
    _assert_same(jeng, teng, wl)
    st = teng.stats()
    assert st["staging_copies"] == 0
    if name == "prefix":
        assert st["shared_admissions"] > 0 and st["prefill_tokens_saved"] > 0


@pytest.mark.parametrize("case", ["two_tenants", "tight_pool"])
def test_engine_tenants_and_pool_match_jax(setup, case):
    """Two tenant domains (ASID isolation, tenant-scoped prefix index), or a
    physical pool of POOL pages that makes admission wait."""
    base = pressure_workload(setup[0].vocab_size, arrivals=ARRIVAL_CASES[1])
    if case == "two_tenants":
        kw = dict(tenants={"a": {}, "b": {}})
        wl = Workload(base.prompts, base.maxtoks, arrivals=base.arrivals,
                      tenants=("a", "b") * 3)
    else:
        kw = dict(pool_pages=POOL)
        wl = base
    _assert_same(*_engines(setup, **kw), wl)


def test_engine_eos_matches_jax(setup):
    """A request stops at the eos token, on both engines alike."""
    cfg, tcfg, params, tparams = setup
    wl = pressure_workload(cfg.vocab_size, n=3)
    first, _ = drive(ServingEngine(tcfg, tparams, device="cpu", **ENGINE_KW),
                     wl)
    eos = first[0][2]
    outs = _assert_same(*_engines(setup, eos_token=eos), wl)
    assert outs[0] == first[0][:first[0].index(eos) + 1]


def test_engine_cow_divergence_matches_jax(setup):
    """Prompts that end mid-page inside a shared prefix: the first decode
    append lands in a shared page and is served by a CoW page copy."""
    r = np.random.default_rng(11)
    system = r.integers(0, setup[0].vocab_size, 20).tolist()
    wl = Workload((tuple(system), tuple(system), tuple(system[:12])), (5, 5, 5))
    jeng, teng = _engines(setup)
    _assert_same(jeng, teng, wl)
    assert teng.stats()["cow_page_copies"] > 0


def test_cuda_device_raises_without_a_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg, _, tparams = setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(tcfg, tparams, n_slots=2, max_len=32)


@pytest.mark.parametrize("kw", [dict(offload_mode="copy"),
                                dict(scheduler="continuous")])
def test_unported_modes_raise(setup, kw):
    _, tcfg, _, tparams = setup
    with pytest.raises(NotImplementedError):
        ServingEngine(tcfg, tparams, n_slots=2, max_len=32, device="cpu", **kw)


def test_per_slot_state_archs_raise(setup):
    _, tcfg, _, tparams = setup
    local = dataclasses.replace(tcfg, n_layers=2, sliding_window=8,
                                block_pattern=("attn_mlp_local", "attn_mlp"))
    with pytest.raises(NotImplementedError):
        ServingEngine(local, tparams, n_slots=2, max_len=32, device="cpu")


def test_serve_cli_on_cpu(capsys):
    assert serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                       "--slots", "2", "--max-tokens", "3",
                       "--prompt-len", "9"]) == 0
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and '"staging_copies": 0' in out
