"""The port's serving engine against the JAX ServingEngine (fixed
scheduler, zero_copy and copy offload) on the shared conformance workloads:
the same tokens, the same ``stats()`` apart from wall-clock fields, and the
same translation trace, with the same weights on both sides."""
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


@pytest.mark.parametrize("kw", [dict(offload_mode="copy",
                                     scheduler="continuous")])
def test_unported_modes_raise(setup, kw):
    _, tcfg, _, tparams = setup
    with pytest.raises(NotImplementedError):
        ServingEngine(tcfg, tparams, n_slots=2, max_len=32, device="cpu", **kw)


@pytest.mark.parametrize("arrival", [1, 3])
@pytest.mark.parametrize("name", ["prefix", "pressure"])
def test_copy_engine_matches_jax_engine(setup, name, arrival):
    """Copy mode: per-slot pools, exact-length B=1 prefill, staging copy,
    full table upload every step; and the same batch-cache pools after the
    serve (a staging copy or slot write that aliased would corrupt them)."""
    wl = _workload(name, setup[0].vocab_size, ARRIVAL_CASES[arrival])
    jeng, teng = _engines(setup, offload_mode="copy")
    _assert_same(jeng, teng, wl)
    st = teng.stats()
    assert st["staging_copies"] == len(wl.prompts)
    assert st["sva"]["bytes_copied"] > 0 and st["sva"]["bytes_mapped"] == 0
    assert st["table_uploads_full"] == st["decode_steps"]
    jkv = jeng.cache["blocks"]["0"]["kv"]
    for pool, name_ in ((jkv.k_pool, "k_pool"), (jkv.v_pool, "v_pool")):
        tpool = np.stack([getattr(kv, name_).numpy() for kv in teng.cache])
        np.testing.assert_allclose(tpool, np.asarray(pool), atol=1e-4,
                                   rtol=1e-4)


def test_copy_mode_same_tokens_as_zero_copy(setup):
    """Copy-based admission gives the zero-copy engine's tokens but pays a
    staging copy per admission."""
    _, tcfg, _, tparams = setup
    wl = pressure_workload(setup[0].vocab_size, arrivals=ARRIVAL_CASES[1])
    kw = dict(ENGINE_KW, device="cpu", prefix_sharing=False)
    zc = ServingEngine(tcfg, tparams, **kw)
    cp = ServingEngine(tcfg, tparams, offload_mode="copy", **kw)
    assert drive(cp, wl)[0] == drive(zc, wl)[0]
    assert cp.stats()["staging_copies"] > 0
    assert zc.stats()["staging_copies"] == 0


def test_copy_mode_stages_a_real_copy(setup, monkeypatch):
    """What reaches the slot write is a device duplicate of the prefilled
    single-sequence cache, never the prefill's own tensors."""
    from repro_torch.core.serving import engine as eng_mod
    _, tcfg, _, tparams = setup
    prefilled, written = [], []
    real_prefill, real_write = eng_mod.forward_prefill, eng_mod._write_slot

    def prefill(*a, **k):
        logits, cache = real_prefill(*a, **k)
        prefilled.extend(t.data_ptr() for kv in cache for t in kv)
        return logits, cache

    def write_slot(batch_cache, single, slot):
        written.extend(t.data_ptr() for kv in single for t in kv)
        return real_write(batch_cache, single, slot)

    monkeypatch.setattr(eng_mod, "forward_prefill", prefill)
    monkeypatch.setattr(eng_mod, "_write_slot", write_slot)
    eng = ServingEngine(tcfg, tparams, n_slots=2, max_len=32, page_size=8,
                        offload_mode="copy", device="cpu")
    eng.submit([3, 1, 4, 1, 5], max_tokens=2)
    eng.run()
    assert eng.stats()["staging_copies"] == 1
    assert written and not set(written) & set(prefilled)


def test_copy_mode_single_slot_writes_its_slot(setup):
    """With one slot the batch cache and the single-sequence cache have the
    same shape; the slot write must still happen (the JAX ``_write_slot``
    skips leaves of equal shape, so its copy mode decodes over an empty
    cache there), so copy gives zero-copy's tokens."""
    _, tcfg, _, tparams = setup
    prompts = [[11, 4, 9, 30, 2], [87, 23, 1, 5]]
    outs = []
    for mode in ("zero_copy", "copy"):
        eng = ServingEngine(tcfg, tparams, n_slots=1, max_len=32, page_size=8,
                            offload_mode=mode, device="cpu")
        ids = [eng.submit(p, max_tokens=5) for p in prompts]
        done = eng.run()
        outs.append([done[i].out_tokens for i in ids])
    assert outs[0] == outs[1]


def test_copy_mode_constructs_per_slot_cache(setup):
    _, tcfg, _, tparams = setup
    eng = ServingEngine(tcfg, tparams, n_slots=3, max_len=32, page_size=8,
                        offload_mode="copy", device="cpu")
    assert len(eng.cache) == tcfg.n_layers
    for kv in eng.cache:
        assert tuple(kv.k_pool.shape) == (3, 4, 8, tcfg.n_kv_heads,
                                          tcfg.d_head)
        assert kv.block_table.tolist() == [[0, 1, 2, 3]] * 3
        assert kv.length.tolist() == [0, 0, 0]
    with pytest.raises(ValueError, match="refusing to wrap"):
        eng._map_tables(eng.cache, np.array([[0, 1, 2, 4]] * 3, np.int32),
                        np.zeros(3, np.int32))


@pytest.fixture(scope="module")
def gemma2():
    cfg = reduce_for_smoke(get_config("gemma2-2b"))
    tcfg = reduce_for_smoke(tconfigs.get_config("gemma2-2b"))
    params = init_params(cfg, jax.random.key(0))
    return cfg, tcfg, params, from_jax_params(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("kind,kw", [
    ("fixed", dict(offload_mode="copy")),
    ("fixed", dict(scheduler="continuous")),
    ("disagg", dict(disagg_mode="share")),
    ("disagg", dict(disagg_mode="copy"))])
def test_per_slot_state_archs_raise(gemma2, kind, kw):
    """gemma2's sliding-window rings (max_len 32 past its window of 8) serve
    neither in copy mode nor under the continuous scheduler (nor so in
    DisaggEngine, which runs it): the port raises where the JAX engine
    does."""
    from repro.core.serving.disagg import DisaggEngine as JaxDisagg
    from repro_torch.core.serving.disagg import DisaggEngine
    cfg, tcfg, params, tparams = gemma2
    size = (dict(n_slots=2) if kind == "fixed"
            else dict(n_prefill_slots=1, n_decode_slots=1))
    jax_cls, cls = ((JaxEngine, ServingEngine) if kind == "fixed"
                    else (JaxDisagg, DisaggEngine))
    with pytest.raises(NotImplementedError):
        jax_cls(cfg, params, max_len=32, **size, **kw)
    with pytest.raises(NotImplementedError):
        cls(tcfg, tparams, max_len=32, device="cpu", **size, **kw)


def test_serve_cli_on_cpu(capsys):
    assert serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                       "--slots", "2", "--max-tokens", "3",
                       "--prompt-len", "9"]) == 0
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and '"staging_copies": 0' in out


def test_serve_cli_copy_mode_on_cpu(capsys):
    assert serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                       "--slots", "2", "--max-tokens", "3",
                       "--prompt-len", "9", "--offload-mode", "copy"]) == 0
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and '"staging_copies": 3' in out
