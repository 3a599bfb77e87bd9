"""The port's other dense decoders against the JAX package: smoke qwen2-7b
(QKV bias), llama3.2-3b (tied embeddings) and gemma2-2b (sliding-window
``attn_mlp_local`` layers beside global ones, attention and logit
softcaps, scaled embeddings, gelu), with the same weights on both sides
(JAX ``init_params`` -> numpy -> ``from_jax_params``; qwen2's zero-init
biases are set to random values first so that they count).

Model level: a right-padded prefill through the serving layout (the
global pool, plus per-slot rings for gemma2's local layers, built and
merged as the engine does) and a decode step, logits and every pool at
atol/rtol 1e-4; gemma2's unaligned-window decode against prefill. Engine
level: tokens, ``stats()`` minus wall clock and the translation trace
against the JAX engine on the conformance workloads (gemma2's prompts pass
its window of 8, so its rings wrap in prefill and decode), qwen2 also in
copy mode, continuous and disaggregated; the
bucketed-prefill regression of ``tests/test_sva_serving.py``; the serve
CLIs on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.core.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.core.serving.engine import \
    _build_prefill_view as j_build_view  # noqa: E402
from repro.core.serving.engine import _install_tables as j_install  # noqa: E402
from repro.core.serving.engine import \
    _merge_prefill_view as j_merge_view  # noqa: E402
from repro.models import forward_decode as j_decode  # noqa: E402
from repro.models import forward_prefill as j_prefill  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.serving.engine import (  # noqa: E402
    ServingEngine, _build_prefill_view, _install_tables, _merge_prefill_view)
from repro_torch.launch import serve, serve_paged  # noqa: E402
from repro_torch.models import (forward_decode, forward_prefill,  # noqa: E402
                                from_jax_params, init_cache)
from tests.conformance import (ARRIVAL_CASES, POOL, Workload,  # noqa: E402
                               drive, make_engine, prefix_workload,
                               pressure_workload)
from tests.test_torch_disagg import make_port_engine  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("qwen2-7b", "llama3.2-3b", "gemma2-2b")
SLOTS, MAX_LEN, PAGE = 4, 32, 8
P = MAX_LEN // PAGE
TOTAL = SLOTS * P
ENGINE_KW = dict(n_slots=4, max_len=64, page_size=8,
                 record_translation_trace=True)
WALL_CLOCK = ("prefill_s", "decode_s", "admit_s")


@pytest.fixture(scope="module")
def models():
    """arch -> (cfg, tcfg, JAX params, port params), built once a module."""
    built = {}

    def get(arch):
        if arch not in built:
            cfg = reduce_for_smoke(get_config(arch))
            tcfg = reduce_for_smoke(tconfigs.get_config(arch))
            jp = j_init_params(cfg, jax.random.key(0))
            if cfg.qkv_bias:
                r = np.random.default_rng(1)
                attn = jp["blocks"]["0"]["attn"]
                for name in ("bq", "bk", "bv"):
                    attn[name] = jnp.asarray(r.standard_normal(
                        attn[name].shape).astype(np.float32) * 0.5)
            tp = from_jax_params(tcfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")
            built[arch] = (cfg, tcfg, jp, tp)
        return built[arch]
    return get


def _pools(cfg, jcache, tcache):
    """(port, JAX) K and V pools of every layer, in layer order."""
    n = len(cfg.block_pattern)
    for li, kv in enumerate(tcache):
        jkv = jcache["blocks"][str(li % n)]["kv"]
        for t, j in ((kv.k_pool, jkv.k_pool), (kv.v_pool, jkv.v_pool)):
            yield t.numpy().copy(), np.asarray(j)[li // n]


@pytest.fixture(scope="module", params=ARCHS)
def served(request, models):
    """Three right-padded prompts beside an empty slot, prefilled through
    the serving layout, then one decode step of all four slots."""
    arch = request.param
    cfg, tcfg, jp, tp = models(arch)
    r = np.random.default_rng(0)
    lengths = np.array([12, 7, 16, 0], np.int32)
    tokens = np.zeros((4, 16), np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = r.integers(0, cfg.vocab_size, n)
    tables = np.full((4, P), TOTAL, np.int32)
    tables[0, :2], tables[1, :1], tables[2, :2] = [5, 2], [9], [0, 14]
    jcache = j_init_cache(cfg, SLOTS, MAX_LEN, PAGE, per_seq=True,
                          global_pages=TOTAL)
    tcache = init_cache(tcfg, SLOTS, MAX_LEN, PAGE, global_pages=TOTAL,
                        device="cpu")
    view = j_build_view(jcache, jnp.asarray(tables), jnp.asarray(lengths))
    jl, view = j_prefill(cfg, jp, {"tokens": jnp.asarray(tokens),
                                   "lengths": jnp.asarray(lengths)}, view)
    jcache = j_merge_view(jcache, view, jnp.arange(4))
    tview = _build_prefill_view(tcache, torch.from_numpy(tables),
                                torch.from_numpy(lengths))
    tl, _ = forward_prefill(tcfg, tp, {"tokens": torch.from_numpy(tokens)
                                       .long(),
                                       "lengths": torch.from_numpy(lengths)},
                            tview)
    _merge_prefill_view(tcache, tview, torch.arange(4))
    prefill = (np.asarray(jl), tl.numpy(), list(_pools(cfg, jcache, tcache)))
    tok = r.integers(0, cfg.vocab_size, (SLOTS, 1)).astype(np.int32)
    jc = j_install(jcache, jnp.asarray(tables), jnp.asarray(lengths))
    jd, jc = j_decode(cfg, jp, jnp.asarray(tok), jnp.asarray(lengths), jc)
    tc = _install_tables(tcache, torch.from_numpy(tables),
                         torch.from_numpy(lengths))
    td, tc = forward_decode(tcfg, tp, torch.from_numpy(tok).long(),
                            torch.from_numpy(lengths), tc)
    return dict(cfg=cfg, tcache=tc, prefill=prefill,
                decode=(np.asarray(jd), td.numpy(), list(_pools(cfg, jc, tc))))


def test_cache_layout(served):
    """gemma2's local layers hold per-slot rings of window / page pages
    with identity tables; every other layer the shared pool."""
    cfg = served["cfg"]
    for kind, kv in zip(cfg.layer_kinds(), served["tcache"]):
        if kind == "attn_mlp_local":
            assert tuple(kv.k_pool.shape) == (SLOTS, 1, PAGE, cfg.n_kv_heads,
                                              cfg.d_head)
            assert kv.block_table.tolist() == [[0]] * SLOTS
        else:
            assert tuple(kv.k_pool.shape) == (TOTAL, PAGE, cfg.n_kv_heads,
                                              cfg.d_head)
    assert ("attn_mlp_local" in cfg.layer_kinds()) == (cfg.name == "gemma2-2b")


def test_prefill_logits_and_pools(served):
    jl, tl, pools = served["prefill"]
    np.testing.assert_allclose(tl[:3], jl[:3], **TOL)
    for t, j in pools:
        np.testing.assert_allclose(t, j, **TOL)


def test_decode_logits_and_pools(served):
    jd, td, pools = served["decode"]
    np.testing.assert_allclose(td, jd, **TOL)
    for t, j in pools:
        np.testing.assert_allclose(t, j, **TOL)
    assert all(kv.length.tolist() == [13, 8, 17, 1]
               for kv in served["tcache"])


def test_decode_matches_prefill_sliding_window_unaligned(models):
    """tests/test_decode_consistency.py's gemma2 case on the port: a prompt
    of 20 tokens, not a multiple of the window of 8, then one decode step
    against a prefill of 21; and both against the JAX model."""
    cfg, tcfg, jp, tp = models("gemma2-2b")
    assert tcfg.sliding_window == 8
    B, S = 2, 20
    toks = np.asarray(jax.random.randint(jax.random.key(0), (B, S + 1), 0,
                                         cfg.vocab_size))
    tt = torch.from_numpy(np.array(toks)).long()
    ref, _ = forward_prefill(tcfg, tp, {"tokens": tt},
                             init_cache(tcfg, B, 32, 8, device="cpu"))
    _, cb = forward_prefill(tcfg, tp, {"tokens": tt[:, :S]},
                            init_cache(tcfg, B, 32, 8, device="cpu"))
    dec, _ = forward_decode(tcfg, tp, tt[:, S:], S, cb)
    rel = (ref - dec).abs().max().item() / (ref.abs().max().item() + 1e-9)
    assert rel < 1e-4, rel
    jcache = j_init_cache(cfg, B, max_len=32, page_size=8)
    _, jcache = j_prefill(cfg, jp, {"tokens": jnp.asarray(toks[:, :S])},
                          jcache)
    jdec, _ = j_decode(cfg, jp, jnp.asarray(toks[:, S:]), jnp.int32(S),
                       jcache)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), **TOL)


# ------------------------------------------------------------ engine

def _strip_wall_clock(stats):
    s = {k: v for k, v in stats.items() if k not in WALL_CLOCK}
    s["sva"] = {k: v for k, v in s["sva"].items() if k != "host_seconds"}
    return s


def _assert_same(models, arch, wl, **kw):
    cfg, tcfg, jp, tp = models(arch)
    jeng = JaxEngine(cfg, jp, **ENGINE_KW, **kw)
    teng = ServingEngine(tcfg, tp, device="cpu", **ENGINE_KW, **kw)
    jouts, _ = drive(jeng, wl)
    touts, _ = drive(teng, wl)
    assert touts == jouts
    assert _strip_wall_clock(teng.stats()) == _strip_wall_clock(jeng.stats())
    assert teng.translation_trace == jeng.translation_trace
    return teng


@pytest.mark.parametrize("arch,name,arrival", [
    ("qwen2-7b", "prefix", 1), ("qwen2-7b", "pressure", 3),
    ("llama3.2-3b", "prefix", 3), ("gemma2-2b", "prefix", 1),
    ("gemma2-2b", "pressure", 1), ("gemma2-2b", "pressure", 3)])
def test_engine_matches_jax_engine(models, arch, name, arrival):
    cfg = models(arch)[0]
    base = (prefix_workload(cfg.vocab_size) if name == "prefix"
            else pressure_workload(cfg.vocab_size))
    wl = Workload(base.prompts, base.maxtoks,
                  arrivals=tuple(ARRIVAL_CASES[arrival]))
    teng = _assert_same(models, arch, wl)
    st = teng.stats()
    assert st["staging_copies"] == 0
    if arch == "gemma2-2b":
        # no prefix sharing beside per-slot rings; the rings wrapped
        assert st["shared_admissions"] == 0 and not teng._can_share
        assert sum(len(p) > cfg.sliding_window for p in wl.prompts) >= 4
        rings = [kv for kv in teng.cache if kv.k_pool.dim() == 5]
        assert len(rings) == 1 and rings[0].k_pool.shape[1] == 1
    elif name == "prefix":
        assert st["shared_admissions"] > 0 and st["prefill_tokens_saved"] > 0


@pytest.mark.parametrize("kind", ["continuous", "disagg-share"])
def test_scheduled_engines_match_jax_engines(models, kind):
    """qwen2 through the continuous scheduler (a pool of POOL pages: it
    preempts) and the disaggregated engine, against the JAX engines."""
    cfg, tcfg, jp, tp = models("qwen2-7b")
    wl = pressure_workload(cfg.vocab_size, arrivals=ARRIVAL_CASES[1])
    kw = dict(record_translation_trace=True,
              pool_pages=POOL if kind == "continuous" else None)
    jeng = make_engine(cfg, jp, kind, **kw)
    teng = make_port_engine(tcfg, tp, kind, **kw)
    assert drive(teng, wl)[0] == drive(jeng, wl)[0]
    assert _strip_wall_clock(teng.stats()) == _strip_wall_clock(jeng.stats())
    assert teng.translation_trace == jeng.translation_trace
    if kind == "continuous":
        assert teng.stats()["sched"]["preemptions"] > 0


def test_copy_engine_matches_jax_engine(models):
    wl = pressure_workload(models("qwen2-7b")[0].vocab_size,
                           arrivals=ARRIVAL_CASES[1])
    teng = _assert_same(models, "qwen2-7b", wl, offload_mode="copy")
    assert teng.stats()["staging_copies"] == len(wl.prompts)


def test_gemma2_copy_within_window_matches_jax_engine(models):
    """With max_len within the window, gemma2's local layers hold all their
    tokens and copy mode serves, as the reference's does."""
    cfg, tcfg, jp, tp = models("gemma2-2b")
    wl = Workload(((3, 9, 27, 81), (5, 25), (7, 49, 343)), (3, 4, 2))
    kw = dict(n_slots=2, max_len=8, page_size=4, offload_mode="copy",
              record_translation_trace=True)
    jeng = JaxEngine(cfg, jp, **kw)
    teng = ServingEngine(tcfg, tp, device="cpu", **kw)
    assert drive(teng, wl)[0] == drive(jeng, wl)[0]
    assert _strip_wall_clock(teng.stats()) == _strip_wall_clock(jeng.stats())
    assert teng.stats()["staging_copies"] == 3


def test_engine_sliding_window_bucketed_prefill_matches_manual(models):
    """tests/test_sva_serving.py's regression on the port: bucket-padding a
    prompt past the window (12 tokens -> bucket 16 > window 8) must not
    store pad-token KV in the ring; each row keeps its own last
    min(len, window) real tokens."""
    _, tcfg, _, tp = models("gemma2-2b")
    prompts = [[5, 9, 2, 14, 8, 1, 7, 3, 11, 13, 4, 6], [100, 7, 42]]

    def manual(prompt, n=4):
        cache = init_cache(tcfg, 1, 64, 8, device="cpu")
        lg, cache = forward_prefill(tcfg, tp, {"tokens": torch.tensor(
            [prompt])}, cache)
        toks = [int(lg[0, -1].argmax())]
        for pos in range(len(prompt), len(prompt) + n - 1):
            lg, cache = forward_decode(tcfg, tp, torch.tensor([[toks[-1]]]),
                                       torch.tensor([pos]), cache)
            toks.append(int(lg[0, 0].argmax()))
        return toks

    expected = [manual(p) for p in prompts]
    eng = ServingEngine(tcfg, tp, n_slots=2, max_len=64, page_size=8,
                        device="cpu")
    rids = [eng.submit(p, max_tokens=4) for p in prompts]
    done = eng.run()
    assert [done[r].out_tokens for r in rids] == expected
    with pytest.raises(NotImplementedError):
        ServingEngine(tcfg, tp, n_slots=2, max_len=64, page_size=8,
                      offload_mode="copy", device="cpu")


# ------------------------------------------------------------ front-ends

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(capsys, arch):
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-tokens", "3",
                       "--prompt-len", "12"]) == 0
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and '"staging_copies": 0' in out


@pytest.mark.parametrize("argv,expect", [
    ([], "prefill tokens saved: 112"),
    (["--scheduler", "continuous"], "preemptions=2 resumes=2"),
    (["--disagg", "share"], "transfers: 10 (share)")])
def test_serve_paged_on_cpu(capsys, argv, expect):
    assert serve_paged.main(["--device", "cpu", *argv]) == 0
    out = capsys.readouterr().out
    assert expect in out and out.count("  req ") == 4
