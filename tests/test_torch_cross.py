"""The port's cross-attention models against the JAX package:
llama-3.2-vision-90b's gated image cross-attention (``xattn_mlp``) and
seamless-m4t-medium's encoder and ``cross_mlp`` decoder, with the same
weights on both sides (JAX ``init_params`` -> numpy -> ``from_jax_params``)
and inputs from a numpy seed.

Every cross gate is set to 0.5 in both trees first: the reference draws
both archs' gates at zero, and tanh(0) = 0 would leave the cross path out
of every output. The serving engine feeds zero encoder input and zero image
embeddings, and nothing on those paths has a bias, so its tokens cannot
depend on the cross path; the model-level cases below feed random
``enc_x`` (B, 16, d) and ``img_x`` (B, n_image_tokens, d).

Module level, fp32 at atol/rtol 1e-5: ``mlp2``, ``_cross_attention`` in
prefill (its K/V too) and decode, GQA in the vision smoke config (4/2
heads), and the encoder. Model level, at 1e-4: a prefill through the
serving layout (the global pool, per-slot cross K/V and encoder output,
one padding row) and a decode step, logits, pools, cross K/V and encoder
output; decode against prefill; ``from_jax_params`` carries the encoder and
the gates. Engine level: tokens, ``stats()`` minus wall clock and the
translation trace equal the JAX engine's in zero_copy and copy (seamless at
``src_len`` 16, vision at its 8 image tokens); both engines refuse vision
at ``src_len`` 16 (the port at construction, the reference in its first
prefill); the continuous scheduler and the disaggregated engine raise in
both. The serve CLIs run on the CPU."""
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
from repro.models.blocks import FwdCtx as JCtx  # noqa: E402
from repro.models.blocks import _cross_attention as j_cross  # noqa: E402
from repro.models.layers import mlp2 as j_mlp2  # noqa: E402
from repro.models.model import NO_MESH  # noqa: E402
from repro.models.model import _run_encoder as j_encoder  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.serving.disagg import DisaggEngine  # noqa: E402
from repro_torch.core.serving.engine import (  # noqa: E402
    ServingEngine, _build_prefill_view, _install_tables, _merge_prefill_view)
from repro_torch.launch import serve, serve_paged  # noqa: E402
from repro_torch.models import (forward_decode, forward_prefill,  # noqa: E402
                                from_jax_params, init_cache)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.blocks import FwdCtx  # noqa: E402
from repro_torch.models.blocks import _cross_attention  # noqa: E402
from repro_torch.models.layers import mlp2  # noqa: E402
from repro_torch.models.model import EncOut, _run_encoder  # noqa: E402
from tests.conformance import Workload, drive  # noqa: E402

MOD_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
VISION, SEAMLESS = "llama-3.2-vision-90b", "seamless-m4t-medium"
ARCHS = (VISION, SEAMLESS)
GATE = 0.5
ENC_LEN = 16                       # the engine's default src_len
SLOTS, MAX_LEN, PAGE = 4, 32, 8
P = MAX_LEN // PAGE
TOTAL = SLOTS * P
WALL_CLOCK = ("prefill_s", "decode_s", "admit_s")


def _src_len(cfg) -> int:
    return cfg.n_image_tokens or ENC_LEN


def _cross_batch(cfg, B: int, rng) -> dict:
    """Random image embeddings or encoder input for B rows (numpy)."""
    x = rng.standard_normal((B, _src_len(cfg), cfg.d_model)).astype(
        np.float32)
    return {"img_x" if cfg.n_image_tokens else "enc_x": x}


@pytest.fixture(scope="module")
def models():
    """arch -> (cfg, tcfg, JAX params, port params), built once a module,
    every cross gate set to GATE in both trees."""
    built = {}

    def get(arch):
        if arch not in built:
            cfg = reduce_for_smoke(get_config(arch))
            tcfg = reduce_for_smoke(tconfigs.get_config(arch))
            jp = j_init_params(cfg, jax.random.key(0))
            for layer in jp["blocks"].values():
                if "xattn" in layer:
                    g = layer["xattn"]["gate"]
                    layer["xattn"]["gate"] = jnp.full_like(g, GATE)
            tp = from_jax_params(tcfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")
            built[arch] = (cfg, tcfg, jp, tp)
        return built[arch]
    return get


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(t, j, tol=MOD_TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def _cross_layer(models, arch):
    """The first cross-attention layer's parameters in both trees."""
    cfg, tcfg, jp, tp = models(arch)
    i = next(i for i, k in enumerate(cfg.block_pattern)
             if k in ("xattn_mlp", "cross_mlp"))
    jl = jax.tree.map(lambda a: a[0], jp["blocks"][str(i)]["xattn"])
    return cfg, tcfg, jl, tp["blocks"][0][str(i)]["xattn"]


# ------------------------------------------------------------ modules

def test_mlp2_matches_jax():
    r = np.random.default_rng(0)
    p = {"w1": r.standard_normal((32, 96)).astype(np.float32) * 0.2,
         "w2": r.standard_normal((96, 32)).astype(np.float32) * 0.1}
    x = r.standard_normal((2, 7, 32)).astype(np.float32)
    want = j_mlp2({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                  "relu")
    _close(mlp2({k: _t(v) for k, v in p.items()}, _t(x), "relu"), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attention_prefill_matches_jax(models, arch):
    """Prefill: K/V projected from the source become the layer's entry;
    the output through the gate."""
    cfg, tcfg, jl, tl = _cross_layer(models, arch)
    r = np.random.default_rng(1)
    B, S, L = 2, 11, _src_len(cfg)
    x = r.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    src = r.standard_normal((B, L, cfg.d_model)).astype(np.float32)
    zeros = np.zeros((B, L, cfg.n_kv_heads, cfg.d_head), np.float32)
    jy, jc = j_cross(jl, jnp.asarray(x), JCtx(
        cfg=cfg, mi=NO_MESH, mode="prefill", cross_x=jnp.asarray(src)),
        {"xkv": {"k": jnp.asarray(zeros), "v": jnp.asarray(zeros)}})
    ty, tc = _cross_attention(tl, _t(x), FwdCtx(
        cfg=tcfg, mode="prefill", cross_x=_t(src)),
        tattn.CrossKV(_t(zeros), _t(zeros)))
    assert float(tl["gate"]) == GATE
    _close(ty, jy)
    _close(tc.k, jc["xkv"]["k"])
    _close(tc.v, jc["xkv"]["v"])


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attention_decode_matches_jax(models, arch):
    """Decode: the query alone over cached K/V (GQA 4/2 for vision)."""
    cfg, tcfg, jl, tl = _cross_layer(models, arch)
    r = np.random.default_rng(2)
    B, L = 3, _src_len(cfg)
    x = r.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    k, v = (r.standard_normal((B, L, cfg.n_kv_heads, cfg.d_head)).astype(
        np.float32) for _ in range(2))
    jy, _ = j_cross(jl, jnp.asarray(x), JCtx(cfg=cfg, mi=NO_MESH,
                                             mode="decode"),
                    {"xkv": {"k": jnp.asarray(k), "v": jnp.asarray(v)}})
    xkv = tattn.CrossKV(_t(k), _t(v))
    ty, tc = _cross_attention(tl, _t(x), FwdCtx(cfg=tcfg, mode="decode"),
                              xkv)
    _close(ty, jy)
    assert tc is xkv                    # a decode reads, never writes, it
    assert cfg.n_heads != cfg.n_kv_heads or arch == SEAMLESS


def test_encoder_matches_jax(models):
    cfg, tcfg, jp, tp = models(SEAMLESS)
    assert len(tp["encoder"]["blocks"]) == cfg.n_enc_layers == 2
    enc_x = np.random.default_rng(3).standard_normal(
        (2, ENC_LEN, cfg.d_model)).astype(np.float32)
    _close(_run_encoder(tcfg, tp, _t(enc_x)),
           j_encoder(cfg, jp, jnp.asarray(enc_x), NO_MESH))


def test_from_jax_params_carries_encoder_and_gates(models):
    for arch in ARCHS:
        cfg, tcfg, jp, tp = models(arch)
        n = len(cfg.block_pattern)
        for blk in tp["blocks"]:
            for i, kind in enumerate(cfg.block_pattern):
                if kind in ("xattn_mlp", "cross_mlp"):
                    g = blk[str(i)]["xattn"]["gate"]
                    assert g.shape == () and float(g) == GATE
                    assert "bq" not in blk[str(i)]["xattn"]
        assert len(tp["blocks"]) * n == cfg.n_layers
    cfg, tcfg, jp, tp = models(SEAMLESS)
    jenc = jp["encoder"]
    for b, blk in enumerate(tp["encoder"]["blocks"]):
        for name in ("wq", "wo"):
            np.testing.assert_array_equal(
                blk["0"]["attn"][name].numpy(),
                np.asarray(jenc["blocks"]["0"]["attn"][name])[b])
        np.testing.assert_array_equal(
            blk["0"]["mlp"]["w2"].numpy(),
            np.asarray(jenc["blocks"]["0"]["mlp"]["w2"])[b])
    np.testing.assert_array_equal(tp["encoder"]["final_ln"].numpy(),
                                  np.asarray(jenc["final_ln"]))


# ------------------------------------------------------------ model

def _leaves(cfg, jcache, tcache):
    """(port, JAX) arrays of every pool, cross K/V and encoder output, in
    cache order."""
    n = len(cfg.block_pattern)
    i = 0
    for li, kind in enumerate(cfg.layer_kinds()):
        jl = jcache["blocks"][str(li % n)]
        if kind != "xattn_mlp":
            kv = tcache[i]
            assert isinstance(kv, tattn.PagedKV)
            for t, j in ((kv.k_pool, jl["kv"].k_pool),
                         (kv.v_pool, jl["kv"].v_pool)):
                yield t.numpy().copy(), np.asarray(j)[li // n]
            i += 1
        if kind in ("xattn_mlp", "cross_mlp"):
            x = tcache[i]
            assert isinstance(x, tattn.CrossKV)
            for t, j in ((x.k, jl["xkv"]["k"]), (x.v, jl["xkv"]["v"])):
                yield t.numpy().copy(), np.asarray(j)[li // n]
            i += 1
    if cfg.is_encdec:
        assert isinstance(tcache[i], EncOut) and i == len(tcache) - 1
        yield tcache[i].x.numpy().copy(), np.asarray(jcache["enc_out"])
    else:
        assert i == len(tcache)


@pytest.fixture(scope="module", params=ARCHS)
def served(request, models):
    """Three prompts of 13, 6 and 9 tokens and a padding row (length 0,
    NULL table, dropped on the merge), prefilled through the serving layout
    with random image embeddings or encoder input, then one decode step of
    all four slots."""
    arch = request.param
    cfg, tcfg, jp, tp = models(arch)
    r = np.random.default_rng(0)
    S, L = 13, _src_len(cfg)
    lengths = np.array([13, 6, 9, 0], np.int32)
    tokens = np.zeros((4, S), np.int32)
    for i, n in enumerate(lengths[:3]):
        tokens[i, :n] = r.integers(0, cfg.vocab_size, n)
    tables = np.full((4, P), TOTAL, np.int32)
    tables[0, :2], tables[1, :2], tables[2, :2] = [5, 2], [9, 1], [0, 14]
    slots = np.array([0, 1, 2, SLOTS], np.int32)      # padding: dropped
    extra = _cross_batch(cfg, 4, r)
    jcache = j_init_cache(cfg, SLOTS, MAX_LEN, PAGE, src_len=L,
                          per_seq=True, global_pages=TOTAL)
    tcache = init_cache(tcfg, SLOTS, MAX_LEN, PAGE, global_pages=TOTAL,
                        device="cpu", src_len=L)
    view = j_build_view(jcache, jnp.asarray(tables), jnp.asarray(lengths))
    jl, view = j_prefill(cfg, jp, {"tokens": jnp.asarray(tokens),
                                   "lengths": jnp.asarray(lengths),
                                   **{k: jnp.asarray(v)
                                      for k, v in extra.items()}}, view)
    jcache = j_merge_view(jcache, view, jnp.asarray(slots))
    tview = _build_prefill_view(tcache, torch.from_numpy(tables),
                                torch.from_numpy(lengths))
    tl, tview = forward_prefill(tcfg, tp, {
        "tokens": torch.from_numpy(tokens).long(),
        "lengths": torch.from_numpy(lengths),
        **{k: _t(v) for k, v in extra.items()}}, tview)
    _merge_prefill_view(tcache, tview, torch.arange(3))
    prefill = (np.asarray(jl), tl.numpy(), list(_leaves(cfg, jcache,
                                                        tcache)))
    tok = r.integers(0, cfg.vocab_size, (SLOTS, 1)).astype(np.int32)
    jc = j_install(jcache, jnp.asarray(tables), jnp.asarray(lengths))
    jd, jc = j_decode(cfg, jp, jnp.asarray(tok), jnp.asarray(lengths), jc)
    tc = _install_tables(tcache, torch.from_numpy(tables),
                         torch.from_numpy(lengths))
    td, tc = forward_decode(tcfg, tp, torch.from_numpy(tok).long(),
                            torch.from_numpy(lengths), tc)
    return dict(cfg=cfg, tcache=tc, prefill=prefill,
                decode=(np.asarray(jd), td.numpy(),
                        list(_leaves(cfg, jc, tc))))


def test_cache_layout(served):
    """A PagedKV a self-attention layer, a CrossKV of src_len rows a slot
    a cross-attention, and seamless's encoder output last."""
    cfg, tcache = served["cfg"], served["tcache"]
    L = _src_len(cfg)
    n_cross = sum(k in ("xattn_mlp", "cross_mlp") for k in cfg.layer_kinds())
    crosses = [e for e in tcache if isinstance(e, tattn.CrossKV)]
    assert len(crosses) == n_cross > 0
    for e in crosses:
        assert tuple(e.k.shape) == (SLOTS, L, cfg.n_kv_heads, cfg.d_head)
    pools = [e for e in tcache if isinstance(e, tattn.PagedKV)]
    assert len(pools) == sum(k != "xattn_mlp" for k in cfg.layer_kinds())
    if cfg.is_encdec:
        assert tuple(tcache[-1].x.shape) == (SLOTS, L, cfg.d_model)


def test_prefill_logits_and_cross_cache(served):
    jl, tl, leaves = served["prefill"]
    np.testing.assert_allclose(tl[:3], jl[:3], **TOL)
    assert leaves
    for t, j in leaves:
        np.testing.assert_allclose(t, j, **TOL)
    # the cross path is live: the cross K/V of a real row is not zero
    assert any(np.abs(t[0]).max() > 0 for t, _ in leaves)


def test_decode_logits_and_cross_cache(served):
    jd, td, leaves = served["decode"]
    np.testing.assert_allclose(td, jd, **TOL)
    for t, j in leaves:
        np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(models, arch):
    """tests/test_decode_consistency.py on the port, with random image
    embeddings or encoder input: prefill 24 tokens into a cache and decode
    one against a prefill of 25, rel < 1e-4; the decode also against the
    JAX one."""
    cfg, tcfg, jp, tp = models(arch)
    B, S, L = 2, 24, _src_len(cfg)
    r = np.random.default_rng(5)
    toks = r.integers(0, cfg.vocab_size, (B, S + 1))
    extra = _cross_batch(cfg, B, r)
    tx = {k: _t(v) for k, v in extra.items()}
    tt = torch.from_numpy(toks).long()
    ref, _ = forward_prefill(tcfg, tp, {"tokens": tt, **tx},
                             init_cache(tcfg, B, 32, 8, device="cpu",
                                        src_len=L))
    _, cb = forward_prefill(tcfg, tp, {"tokens": tt[:, :S], **tx},
                            init_cache(tcfg, B, 32, 8, device="cpu",
                                       src_len=L))
    dec, _ = forward_decode(tcfg, tp, tt[:, S:], S, cb)
    rel = (ref - dec).abs().max().item() / (ref.abs().max().item() + 1e-9)
    assert rel < 1e-4, rel
    jx = {k: jnp.asarray(v) for k, v in extra.items()}
    jcache = j_init_cache(cfg, B, max_len=32, page_size=8, src_len=L)
    _, jcache = j_prefill(cfg, jp, {"tokens": jnp.asarray(toks[:, :S]),
                                    **jx}, jcache)
    jdec, _ = j_decode(cfg, jp, jnp.asarray(toks[:, S:]), jnp.int32(S),
                       jcache)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), **TOL)
    # and the cross path moves the logits: zero source, other logits
    zero = {k: torch.zeros_like(v) for k, v in tx.items()}
    other, _ = forward_prefill(tcfg, tp, {"tokens": tt, **zero}, None)
    assert (other - ref).abs().max().item() > 1e-3


# ------------------------------------------------------------ engine

def _strip_wall_clock(stats):
    s = {k: v for k, v in stats.items() if k not in WALL_CLOCK}
    s["sva"] = {k: v for k, v in s["sva"].items() if k != "host_seconds"}
    return s


def _workload(vocab: int) -> Workload:
    """Six prompts into four slots, two waves; three prompt lengths, so
    the reference's copy mode compiles three exact-length prefills."""
    r = np.random.default_rng(3)
    return Workload(tuple(tuple(r.integers(0, vocab, n).tolist())
                          for n in (9, 5, 9, 13, 5, 9)), (5, 7, 4, 6, 5, 3))


@pytest.mark.parametrize("mode", ["zero_copy", "copy"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(models, arch, mode):
    cfg, tcfg, jp, tp = models(arch)
    kw = dict(n_slots=4, max_len=64, page_size=8, offload_mode=mode,
              src_len=_src_len(cfg), record_translation_trace=True)
    wl = _workload(cfg.vocab_size)
    jeng = JaxEngine(cfg, jp, **kw)
    teng = ServingEngine(tcfg, tp, device="cpu", **kw)
    jouts, _ = drive(jeng, wl)
    touts, _ = drive(teng, wl)
    assert touts == jouts
    st = teng.stats()
    assert _strip_wall_clock(st) == _strip_wall_clock(jeng.stats())
    assert teng.translation_trace == jeng.translation_trace
    assert not teng._can_share
    assert st["staging_copies"] == (6 if mode == "copy" else 0)
    # the cross cache of every slot: src_len rows, finite
    for e in teng.cache:
        if isinstance(e, (tattn.CrossKV, EncOut)):
            assert e[0].shape[1] == _src_len(cfg)
            assert all(torch.isfinite(t).all() for t in e)


def test_vision_refuses_src_len_other_than_image_tokens(models):
    """At src_len 16 against 8 image tokens the reference's prefill fails
    to write the cross cache; the port refuses at construction."""
    cfg, tcfg, jp, tp = models(VISION)
    assert cfg.n_image_tokens == 8
    with pytest.raises(ValueError, match="src_len=16 != n_image_tokens=8"):
        ServingEngine(tcfg, tp, n_slots=2, max_len=32, src_len=16,
                      device="cpu")
    jeng = JaxEngine(cfg, jp, n_slots=2, max_len=32, src_len=16)
    jeng.submit([1, 2, 3], max_tokens=2)
    with pytest.raises(ValueError, match="broadcast"):
        jeng.run()


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_and_disagg_raise_as_the_reference(models, arch):
    cfg, tcfg, jp, tp = models(arch)
    for eng in (lambda: JaxEngine(cfg, jp, n_slots=4, max_len=64,
                                  scheduler="continuous"),
                lambda: ServingEngine(tcfg, tp, n_slots=4, max_len=64,
                                      scheduler="continuous", device="cpu"),
                lambda: JaxDisagg(cfg, jp, n_prefill_slots=2,
                                  n_decode_slots=2, max_len=64),
                lambda: DisaggEngine(tcfg, tp, n_prefill_slots=2,
                                     n_decode_slots=2, max_len=64,
                                     device="cpu")):
        with pytest.raises(NotImplementedError, match="cross-KV"):
            eng()


# ------------------------------------------------------------ front-ends

@pytest.mark.parametrize("mode", ["zero_copy", "copy"])
def test_serve_cli_seamless_on_cpu(capsys, mode):
    assert serve.main(["--arch", SEAMLESS, "--smoke", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-tokens", "3",
                       "--prompt-len", "12", "--offload-mode", mode]) == 0
    out = capsys.readouterr().out
    want = 3 if mode == "copy" else 0
    assert out.count("req ") == 3 and f'"staging_copies": {want}' in out


def test_serve_cli_refuses_vision(capsys):
    """Without --smoke an argparse error (about 175 GB of weights); with it
    the engine's refusal, since the CLI passes no src_len (as the
    reference's, whose prefill fails there)."""
    with pytest.raises(SystemExit):
        serve.main(["--arch", VISION, "--device", "cpu"])
    assert "needs --smoke" in capsys.readouterr().err
    with pytest.raises(ValueError, match="src_len"):
        serve.main(["--arch", VISION, "--smoke", "--device", "cpu",
                    "--requests", "1", "--max-tokens", "2"])


def test_serve_paged_seamless_on_cpu(capsys):
    assert serve_paged.main(["--device", "cpu", "--arch", SEAMLESS]) == 0
    out = capsys.readouterr().out
    assert out.count("  req ") == 4 and "prefix cache: off" in out
