"""The port's recurrent-state decoders against the JAX package: rwkv6-3b's
time mix and channel mix, jamba's selective SSM (``mamba``, ``mamba_moe``)
beside its ``attn`` layer, with the same weights on both sides (JAX
``init_params`` -> numpy -> ``from_jax_params``; mamba's zero-init
``conv_b`` is set to random values first) and inputs from a numpy seed.

Module level, fp32 at atol/rtol 1e-5: ``rwkv_time_mix`` at T = 24, 64 and
96 from a non-zero state, ``rwkv_time_mix_step``, ``rwkv_channel_mix``,
``token_shift``, and the data-dependent decay with a random ``w_lora_b``;
``mamba_mix`` at chunk 256 (one chunk) and chunk 8 (six) and
``mamba_mix_step``, outputs and states. The time mix runs on the
reference's init, whose ``w_lora_b`` is zero: with it drawn at std 0.3
the log-decays reach -400 a token, and the chunked form's ``exp(cl_prev -
cl)`` and group norm carry each package's fp32 rounding to ~1e-4 from an
fp64 evaluation of the same form (both alike), past 1e-5. Both packages
refuse the lengths the reference's chunking cannot reshape (71 tokens at
chunk 32, 513 at chunk 256). Model level, at 1e-4: an exact-length prefill through
the serving layout (one padding row, as the engine's) and a decode step,
logits, every state leaf and jamba's pools; decode against prefill.
Engine level: tokens, ``stats()`` minus wall clock and the translation
trace equal the JAX engine's in zero_copy and copy, on a workload whose
first wave holds two prompts of one length; the continuous scheduler and
the disaggregated engine raise as the reference's do. The serve CLIs run
with ``--smoke`` on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.core.serving.disagg import DisaggEngine as JaxDisagg  # noqa: E402
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
from repro.models import mamba as jmam  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models.model import NO_MESH  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.serving.disagg import DisaggEngine  # noqa: E402
from repro_torch.core.serving.engine import (  # noqa: E402
    ServingEngine, _build_prefill_view, _install_tables, _merge_prefill_view)
from repro_torch.launch import serve, serve_paged  # noqa: E402
from repro_torch.models import (forward_decode, forward_prefill,  # noqa: E402
                                from_jax_params, init_cache)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import mamba as tmam  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402
from tests.conformance import Workload, drive  # noqa: E402

MOD_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
RWKV, JAMBA = "rwkv6-3b", "jamba-1.5-large-398b"
ARCHS = (RWKV, JAMBA)
SLOTS, MAX_LEN, PAGE = 4, 32, 8
P = MAX_LEN // PAGE
TOTAL = SLOTS * P
WALL_CLOCK = ("prefill_s", "decode_s", "admit_s")


def _smoke(arch, capacity_factor=None):
    cfg = reduce_for_smoke(get_config(arch))
    tcfg = reduce_for_smoke(tconfigs.get_config(arch))
    if capacity_factor is not None and cfg.moe is not None:
        cfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor)) for c in (cfg, tcfg))
    return cfg, tcfg


@pytest.fixture(scope="module")
def models():
    """(arch, capacity factor) -> (cfg, tcfg, JAX params, port params),
    built once a module, mamba's conv_b made random."""
    built = {}

    def get(arch, capacity_factor=None):
        key = (arch, capacity_factor)
        if key not in built:
            cfg, tcfg = _smoke(arch, capacity_factor)
            jp = j_init_params(cfg, jax.random.key(0))
            r = np.random.default_rng(1)
            for layer in jp["blocks"].values():
                if "mamba" in layer:
                    a = layer["mamba"]["conv_b"]
                    layer["mamba"]["conv_b"] = jnp.asarray(
                        r.standard_normal(a.shape).astype(np.float32) * 0.3,
                        a.dtype)
            tp = from_jax_params(tcfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")
            built[key] = (cfg, tcfg, jp, tp)
        return built[key]
    return get


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(t, j, tol=MOD_TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


# ------------------------------------------------------------ rwkv

def _rwkv_layer(models):
    cfg, tcfg, jp, tp = models(RWKV)
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["0"])
    return cfg, tcfg, jl, tp["blocks"][0]["0"]


@pytest.mark.parametrize("T", [24, 64, 96])
def test_rwkv_time_mix_matches_jax(models, T):
    """The chunked form (1, 2 and 3 chunks of 32) from a non-zero state."""
    cfg, tcfg, jl, tl = _rwkv_layer(models)
    r = np.random.default_rng(T)
    B, H, N, d = 2, cfg.n_heads, cfg.d_head, cfg.d_model
    x = r.standard_normal((B, T, d)).astype(np.float32)
    carry = r.standard_normal((B, d)).astype(np.float32)
    state = (r.standard_normal((B, H, N, N)) * 0.5).astype(np.float32)
    jx_prev, _ = jrwkv.token_shift(jnp.asarray(x), jnp.asarray(carry))
    tx_prev, _ = trwkv.token_shift(_t(x), _t(carry))
    _close(tx_prev, jx_prev, dict(atol=0, rtol=0))
    jy, js = jrwkv.rwkv_time_mix(jl["tm"], jnp.asarray(x), jx_prev, cfg,
                                 NO_MESH, jnp.asarray(state))
    ty, ts = trwkv.rwkv_time_mix(tl["tm"], _t(x), tx_prev, tcfg, _t(state))
    _close(ty, jy)
    _close(ts, js)
    assert ts.dtype == torch.float32


def test_rwkv_step_channel_mix_and_shift_match_jax(models):
    cfg, tcfg, jl, tl = _rwkv_layer(models)
    r = np.random.default_rng(5)
    B, H, N, d = 3, cfg.n_heads, cfg.d_head, cfg.d_model
    x = r.standard_normal((B, 1, d)).astype(np.float32)
    x_prev = r.standard_normal((B, 1, d)).astype(np.float32)
    state = (r.standard_normal((B, H, N, N)) * 0.5).astype(np.float32)
    jy, js = jrwkv.rwkv_time_mix_step(jl["tm"], jnp.asarray(x),
                                      jnp.asarray(x_prev), cfg,
                                      jnp.asarray(state))
    ty, ts = trwkv.rwkv_time_mix_step(tl["tm"], _t(x), _t(x_prev), tcfg,
                                      _t(state))
    _close(ty, jy)
    _close(ts, js)
    xs = r.standard_normal((B, 7, d)).astype(np.float32)
    carry = r.standard_normal((B, d)).astype(np.float32)
    jprev, jcarry = jrwkv.token_shift(jnp.asarray(xs), jnp.asarray(carry))
    tprev, tcarry = trwkv.token_shift(_t(xs), _t(carry))
    _close(tprev, jprev, dict(atol=0, rtol=0))
    _close(tcarry, jcarry, dict(atol=0, rtol=0))
    _close(trwkv.rwkv_channel_mix(tl["cm"], _t(xs), tprev),
           jrwkv.rwkv_channel_mix(jl["cm"], jnp.asarray(xs), jprev))


def test_rwkv_decay_matches_jax(models):
    """The data-dependent decay's low-rank path, with w_lora_b drawn at std
    0.3 (the init's is zero): log w in [-e^6, -e^-8], fp32."""
    cfg, tcfg, jl, tl = _rwkv_layer(models)
    r = np.random.default_rng(6)
    lora_b = (r.standard_normal(jl["tm"]["w_lora_b"].shape) * 0.3) \
        .astype(np.float32)
    jp = dict(jl["tm"], w_lora_b=jnp.asarray(lora_b))
    tp = dict(tl["tm"], w_lora_b=_t(lora_b))
    xw = r.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    jw, tw = jrwkv._decay(jp, jnp.asarray(xw)), trwkv._decay(tp, _t(xw))
    _close(tw, jw)
    assert tw.dtype == torch.float32 and float(tw.min()) < -100


# ------------------------------------------------------------ mamba

def _mamba_layer(models):
    cfg, tcfg, jp, tp = models(JAMBA)
    assert cfg.block_pattern[0] == "mamba"
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["0"])
    return cfg, tcfg, jl["mamba"], tp["blocks"][0]["0"]["mamba"]


def _mamba_state(cfg, B, r):
    d_in, _, N, K = jmam._dims(cfg)
    return (r.standard_normal((B, K - 1, d_in)).astype(np.float32),
            (r.standard_normal((B, d_in, N)) * 0.5).astype(np.float32))


@pytest.mark.parametrize("chunk", [256, 8])
def test_mamba_mix_matches_jax(models, chunk):
    """48 tokens from a non-zero state: one chunk at 256, six at 8 (the
    doubling scan within each, the carry across them)."""
    cfg, tcfg, jp, tp = _mamba_layer(models)
    r = np.random.default_rng(chunk)
    B, T = 2, 48
    x = r.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    conv, ssm = _mamba_state(cfg, B, r)
    jy, js = jmam.mamba_mix(jp, jnp.asarray(x), cfg, NO_MESH,
                            jmam.MambaState(jnp.asarray(conv),
                                            jnp.asarray(ssm)), chunk=chunk)
    ty, ts = tmam.mamba_mix(tp, _t(x), tcfg,
                            tmam.MambaState(_t(conv), _t(ssm)), chunk=chunk)
    _close(ty, jy)
    _close(ts.conv, js.conv)
    _close(ts.ssm, js.ssm)


def test_mamba_mix_step_matches_jax(models):
    cfg, tcfg, jp, tp = _mamba_layer(models)
    r = np.random.default_rng(9)
    B = 3
    x = r.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    conv, ssm = _mamba_state(cfg, B, r)
    jy, js = jmam.mamba_mix_step(jp, jnp.asarray(x), cfg, jmam.MambaState(
        jnp.asarray(conv), jnp.asarray(ssm)))
    ty, ts = tmam.mamba_mix_step(tp, _t(x), tcfg,
                                 tmam.MambaState(_t(conv), _t(ssm)))
    _close(ty, jy)
    _close(ts.conv, js.conv)
    _close(ts.ssm, js.ssm)


def test_both_refuse_lengths_the_chunking_cannot_reshape(models):
    """The reference's reshape fails on a 71-token rwkv prompt (nC 2, C 35)
    and a 513-token mamba sequence (nC 2, C 256); the port raises there
    too, and takes 64 and 512."""
    cfg, tcfg, jl, tl = _rwkv_layer(models)
    r = np.random.default_rng(0)
    for T, ok in ((71, False), (64, True)):
        x = r.standard_normal((1, T, cfg.d_model)).astype(np.float32)
        s0 = np.zeros((1, cfg.n_heads, cfg.d_head, cfg.d_head), np.float32)
        call_j = lambda: jrwkv.rwkv_time_mix(jl["tm"], jnp.asarray(x),
                                             jnp.asarray(x), cfg, NO_MESH,
                                             jnp.asarray(s0))
        call_t = lambda: trwkv.rwkv_time_mix(tl["tm"], _t(x), _t(x), tcfg,
                                             _t(s0))
        if ok:
            call_j(), call_t()
        else:
            with pytest.raises(TypeError, match="reshape"):
                call_j()
            with pytest.raises(ValueError, match="71"):
                call_t()
    mcfg, mtcfg, mjp, mtp = _mamba_layer(models)
    for T, ok in ((513, False), (512, True)):
        x = r.standard_normal((1, T, mcfg.d_model)).astype(np.float32)
        conv, ssm = _mamba_state(mcfg, 1, r)
        call_j = lambda: jmam.mamba_mix(mjp, jnp.asarray(x), mcfg, NO_MESH,
                                        jmam.MambaState(jnp.asarray(conv),
                                                        jnp.asarray(ssm)))
        call_t = lambda: tmam.mamba_mix(mtp, _t(x), mtcfg,
                                        tmam.MambaState(_t(conv), _t(ssm)))
        if ok:
            call_j(), call_t()
        else:
            with pytest.raises(TypeError, match="reshape"):
                call_j()
            with pytest.raises(ValueError, match="513"):
                call_t()


# ------------------------------------------------------------ model

def _states(cfg, jcache, tcache):
    """(port, JAX) leaves of every recurrent layer's state, in layer
    order."""
    n = len(cfg.block_pattern)
    for li, entry in enumerate(tcache):
        if isinstance(entry, tattn.PagedKV):
            continue
        jst = jcache["blocks"][str(li % n)]
        jst = jst["rwkv"] if "rwkv" in jst else jst["ssm"]
        for t, j in zip(entry, jst):
            yield t.numpy().copy(), np.asarray(j)[li // n]


def _pools(cfg, jcache, tcache):
    n = len(cfg.block_pattern)
    for li, kv in enumerate(tcache):
        if not isinstance(kv, tattn.PagedKV):
            continue
        jkv = jcache["blocks"][str(li % n)]["kv"]
        for t, j in ((kv.k_pool, jkv.k_pool), (kv.v_pool, jkv.v_pool)):
            yield t.numpy().copy(), np.asarray(j)[li // n]


@pytest.fixture(scope="module", params=ARCHS)
def served(request, models):
    """Three prompts of one length and a padding row (length 0, NULL
    table, dropped on the merge), prefilled through the serving layout as
    the engine's exact-length prefill does, then one decode step of all
    four slots."""
    arch = request.param
    cfg, tcfg, jp, tp = models(arch)
    r = np.random.default_rng(0)
    S = 13
    lengths = np.array([S, S, S, 0], np.int32)
    tokens = np.zeros((4, S), np.int32)
    tokens[:3] = r.integers(0, cfg.vocab_size, (3, S))
    tables = np.full((4, P), TOTAL, np.int32)
    tables[0, :2], tables[1, :2], tables[2, :2] = [5, 2], [9, 1], [0, 14]
    slots = np.array([0, 1, 2, SLOTS], np.int32)      # padding: dropped
    jcache = j_init_cache(cfg, SLOTS, MAX_LEN, PAGE, per_seq=True,
                          global_pages=TOTAL)
    tcache = init_cache(tcfg, SLOTS, MAX_LEN, PAGE, global_pages=TOTAL,
                        device="cpu")
    view = j_build_view(jcache, jnp.asarray(tables), jnp.asarray(lengths))
    jl, view = j_prefill(cfg, jp, {"tokens": jnp.asarray(tokens),
                                   "lengths": jnp.asarray(lengths)}, view)
    jcache = j_merge_view(jcache, view, jnp.asarray(slots))
    tview = _build_prefill_view(tcache, torch.from_numpy(tables),
                                torch.from_numpy(lengths))
    tl, tview = forward_prefill(tcfg, tp, {
        "tokens": torch.from_numpy(tokens).long(),
        "lengths": torch.from_numpy(lengths)}, tview)
    _merge_prefill_view(tcache, tview, torch.arange(3))
    prefill = (np.asarray(jl), tl.numpy(), list(_states(cfg, jcache, tcache)),
               list(_pools(cfg, jcache, tcache)))
    tok = r.integers(0, cfg.vocab_size, (SLOTS, 1)).astype(np.int32)
    jc = j_install(jcache, jnp.asarray(tables), jnp.asarray(lengths))
    jd, jc = j_decode(cfg, jp, jnp.asarray(tok), jnp.asarray(lengths), jc)
    tc = _install_tables(tcache, torch.from_numpy(tables),
                         torch.from_numpy(lengths))
    td, tc = forward_decode(tcfg, tp, torch.from_numpy(tok).long(),
                            torch.from_numpy(lengths), tc)
    return dict(cfg=cfg, tcache=tc, prefill=prefill,
                decode=(np.asarray(jd), td.numpy(), list(_states(cfg, jc, tc)),
                        list(_pools(cfg, jc, tc))))


def test_cache_layout(served):
    """One entry a layer: rwkv and mamba states with the reference's shapes
    and dtypes (wkv and ssm fp32), jamba's attention layer in the pool."""
    cfg = served["cfg"]
    for kind, entry in zip(cfg.layer_kinds(), served["tcache"]):
        if kind == "rwkv":
            assert isinstance(entry, trwkv.RWKVState)
            assert tuple(entry.wkv.shape) == (SLOTS, cfg.n_heads, cfg.d_head,
                                              cfg.d_head)
            assert entry.wkv.dtype == torch.float32
        elif kind in ("mamba", "mamba_moe"):
            d_in, _, N, K = jmam._dims(cfg)
            assert isinstance(entry, tmam.MambaState)
            assert tuple(entry.conv.shape) == (SLOTS, K - 1, d_in)
            assert tuple(entry.ssm.shape) == (SLOTS, d_in, N)
            assert entry.ssm.dtype == torch.float32
        else:
            assert kind == "attn"
            assert tuple(entry.k_pool.shape) == (TOTAL, PAGE, cfg.n_kv_heads,
                                                 cfg.d_head)


def test_prefill_logits_states_and_pools(served):
    jl, tl, states, pools = served["prefill"]
    np.testing.assert_allclose(tl[:3], jl[:3], **TOL)
    assert states and (pools or served["cfg"].name == RWKV)
    for t, j in states + pools:
        np.testing.assert_allclose(t, j, **TOL)


def test_decode_logits_states_and_pools(served):
    jd, td, states, pools = served["decode"]
    np.testing.assert_allclose(td, jd, **TOL)
    for t, j in states + pools:
        np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(models, arch):
    """tests/test_decode_consistency.py on the port (capacity factor 16:
    no MoE drops): prefill 24 tokens into a cache and decode one against a
    prefill of 25, rel < 1e-4; the decode also against the JAX one."""
    cfg, tcfg, jp, tp = models(arch, 16.0)
    B, S = 2, 24
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


def _workload(vocab: int) -> Workload:
    """Six prompts into four slots: the first wave holds two of 9 tokens
    (one exact-length prefill) and one of 64 (rwkv: two chunks of 32)."""
    r = np.random.default_rng(3)
    return Workload(tuple(tuple(r.integers(0, vocab, n).tolist())
                          for n in (9, 5, 9, 64, 13, 17)), (6, 8, 5, 6, 7, 4))


@pytest.mark.parametrize("mode", ["zero_copy", "copy"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(models, arch, mode):
    cfg, tcfg, jp, tp = models(arch)
    kw = dict(n_slots=4, max_len=128, page_size=8, offload_mode=mode,
              record_translation_trace=True)
    wl = _workload(cfg.vocab_size)
    jeng = JaxEngine(cfg, jp, **kw)
    teng = ServingEngine(tcfg, tp, device="cpu", **kw)
    jouts, _ = drive(jeng, wl)
    touts, _ = drive(teng, wl)
    assert touts == jouts
    st = teng.stats()
    assert _strip_wall_clock(st) == _strip_wall_clock(jeng.stats())
    assert teng.translation_trace == jeng.translation_trace
    assert teng._exact_prefill and not teng._can_share
    # zero-copy: the two 9-token prompts share one prefill
    assert st["prefills"] == (6 if mode == "copy" else 5)
    assert st["staging_copies"] == (6 if mode == "copy" else 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_rwkv_prompt_of_71_tokens_raises_in_both_engines(models, arch):
    """A prompt length the chunking cannot reshape (71 for rwkv's chunk of
    32; jamba's mamba layers take it, in one chunk) fails the same way in
    both engines' first prefill."""
    cfg, tcfg, jp, tp = models(arch)
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                               71).tolist()
    engines = (JaxEngine(cfg, jp, n_slots=2, max_len=128, page_size=8),
               ServingEngine(tcfg, tp, n_slots=2, max_len=128, page_size=8,
                             device="cpu"))
    outs = []
    for eng in engines:
        eng.submit(prompt, max_tokens=2)
        if arch == RWKV:
            with pytest.raises((TypeError, ValueError), match="reshape"):
                eng.run()
        else:
            outs.append(eng.run()[0].out_tokens)
    assert arch == RWKV or outs[0] == outs[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_and_disagg_raise_as_the_reference(models, arch):
    cfg, tcfg, jp, tp = models(arch)
    with pytest.raises(NotImplementedError):
        JaxEngine(cfg, jp, n_slots=4, max_len=64, scheduler="continuous")
    with pytest.raises(NotImplementedError):
        ServingEngine(tcfg, tp, n_slots=4, max_len=64,
                      scheduler="continuous", device="cpu")
    with pytest.raises(NotImplementedError):
        JaxDisagg(cfg, jp, n_prefill_slots=2, n_decode_slots=2, max_len=64)
    with pytest.raises(NotImplementedError):
        DisaggEngine(tcfg, tp, n_prefill_slots=2, n_decode_slots=2,
                     max_len=64, device="cpu")


# ------------------------------------------------------------ front-ends

@pytest.mark.parametrize("mode", ["zero_copy", "copy"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(capsys, arch, mode):
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-tokens", "3",
                       "--prompt-len", "12", "--offload-mode", mode]) == 0
    out = capsys.readouterr().out
    want = 3 if mode == "copy" else 0
    assert out.count("req ") == 3 and f'"staging_copies": {want}' in out


def test_serve_cli_refuses_jamba_without_smoke(capsys):
    with pytest.raises(SystemExit):
        serve.main(["--arch", JAMBA, "--device", "cpu"])
    assert "needs --smoke" in capsys.readouterr().err


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_paged_on_cpu(capsys, arch):
    assert serve_paged.main(["--device", "cpu", "--arch", arch]) == 0
    out = capsys.readouterr().out
    assert out.count("  req ") == 4 and "prefix cache: off" in out
