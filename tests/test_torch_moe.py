"""The port's MoE decoders against the JAX package: smoke olmoe-1b-7b
(every layer ``attn_moe``) and smoke kimi-k2-1t-a32b (a dense first layer,
then MoE layers with a shared expert), with the same weights on both sides
(JAX ``init_params`` -> numpy -> ``from_jax_params``).

Layer level: ``moe_ffn`` (index dispatch) and ``moe_ffn_ref`` (the
reference's one-hot einsums) against JAX ``moe_ffn`` at high capacity (the
dense mixture), under capacity drops (the keep masks equal), with a shared
expert, on a right-padded batch whose padding takes capacity on both
sides, and with tied router probabilities. Model level: a right-padded
prefill through the serving layout and a decode step, logits and every
pool at 1e-4; decode against prefill at capacity 16. Engine level: tokens,
``stats()`` minus wall clock and the translation trace against the JAX
engines (olmoe in zero-copy, copy, continuous and both disaggregated
modes; kimi in zero-copy). kimi's head dim, 112, at a narrow width
(``KIMI_D112``: d_model 224, 2/1 heads, 8 experts) through the model and
the engine levels. Also the router's float32 at bf16 parameters,
the experts' damped init, the serve CLIs on the CPU, and on the card the
main path against the plain version with no host sync."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.core.serving.engine import \
    _build_prefill_view as j_build_view  # noqa: E402
from repro.core.serving.engine import _install_tables as j_install  # noqa: E402
from repro.core.serving.engine import \
    _merge_prefill_view as j_merge_view  # noqa: E402
from repro.models import forward_decode as j_decode  # noqa: E402
from repro.models import forward_prefill as j_prefill  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models.dist import NO_MESH  # noqa: E402
from repro.models.model import model_specs as j_model_specs  # noqa: E402
from repro.models.moe import moe_ffn as j_moe_ffn  # noqa: E402
from repro.models.moe import moe_specs as j_moe_specs  # noqa: E402
from repro.models.params import materialize  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.serving.engine import (  # noqa: E402
    ServingEngine, _build_prefill_view, _install_tables, _merge_prefill_view)
from repro_torch.launch import serve, serve_paged  # noqa: E402
from repro_torch.models import (forward_decode, forward_prefill,  # noqa: E402
                                from_jax_params, init_cache, init_params)
from repro_torch.models.moe import (capacity, moe_ffn,  # noqa: E402
                                    moe_ffn_ref, positions)
from repro_torch.models.params import model_specs  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
OLMOE, KIMI = "olmoe-1b-7b", "kimi-k2-1t-a32b"
# kimi-k2's head dim at a narrow width: smoke kimi (a dense first layer,
# then one attn_moe layer with a shared expert) at d_model 224, 2/1 heads
# of 112, 8 experts, top 2
KIMI_D112 = "kimi-k2-1t-a32b@d112"
D112 = dict(d_model=224, n_heads=2, n_kv_heads=1, d_head=112)
IMPLS = {"main": moe_ffn, "ref": moe_ffn_ref}
SLOTS, MAX_LEN, PAGE = 4, 32, 8
P = MAX_LEN // PAGE
TOTAL = SLOTS * P


def _cfgs(arch, **moe):
    """(JAX cfg, port cfg) of the smoke arch (KIMI_D112: smoke kimi at
    D112's widths and 8 experts), the MoE fields replaced."""
    narrow = arch == KIMI_D112
    arch = KIMI if narrow else arch
    cfg = reduce_for_smoke(get_config(arch))
    tcfg = reduce_for_smoke(tconfigs.get_config(arch))
    if narrow:
        cfg = dataclasses.replace(cfg, **D112)
        tcfg = dataclasses.replace(tcfg, **D112)
        moe = dict(moe, n_experts=moe.get("n_experts", 8))
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
        tcfg = dataclasses.replace(tcfg,
                                   moe=dataclasses.replace(tcfg.moe, **moe))
    return cfg, tcfg


def _layer(arch, x, **moe):
    """JAX moe_ffn's output and keep mask on x (B, S, d) beside the port's
    parameters: one layer's MoE weights, from the reference's specs."""
    cfg, tcfg = _cfgs(arch, **moe)
    p = materialize(j_moe_specs(cfg), jax.random.key(0))
    out = np.asarray(j_moe_ffn(p, jnp.asarray(x), cfg, NO_MESH))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    return tcfg, tp, out, _j_keep(p, x, cfg)


def _j_keep(p, x, cfg):
    """The reference's keep mask (T, K): ``repro/models/moe.py``'s routing
    and capacity lines with one token group."""
    m = cfg.moe
    xt = jnp.asarray(x).reshape(1, -1, x.shape[-1])
    T = xt.shape[1]
    cap = capacity(T, m)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ p["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, m.experts_per_token)
    onehot = jax.nn.one_hot(idx, m.n_experts, dtype=jnp.int32)
    oh = onehot.swapaxes(1, 2).reshape(1, -1, m.n_experts)
    pos = ((jnp.cumsum(oh, axis=1) - 1).reshape(
        1, m.experts_per_token, T, m.n_experts).swapaxes(1, 2)
        * onehot).sum(-1)
    return np.asarray(pos < cap)[0]


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            .astype(np.float32) * scale)


# ------------------------------------------------------------ layer

@pytest.mark.parametrize("impl", IMPLS)
def test_moe_high_capacity_matches_dense_mixture(impl):
    """tests/test_layers.py's case on the port: top-K = E and capacity 64,
    so nothing drops and the output is the softmax-weighted mixture of
    every expert; against JAX too."""
    x = _x((2, 8, 64), scale=0.5)
    tcfg, tp, j_out, j_keep = _layer(OLMOE, x, n_experts=4,
                                     experts_per_token=4, capacity_factor=64.0)
    xt = torch.from_numpy(x)
    out, keep = IMPLS[impl](tp, xt, tcfg, return_keep=True)
    assert keep.all() and j_keep.all()
    w = torch.softmax(xt @ tp["router"], -1)
    dense = sum(w[..., e:e + 1] * (torch.nn.functional.silu(
        xt @ tp["w_gate"][e]) * (xt @ tp["w_up"][e]) @ tp["w_down"][e])
        for e in range(4))
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=1e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(out.numpy(), j_out, **LAYER_TOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch,cf", [(OLMOE, 0.25), (OLMOE, 1.25),
                                     (KIMI, 0.25), (KIMI, 1.25)])
def test_moe_matches_jax_under_drops(impl, arch, cf):
    """At capacity 0.25 most choices drop (C = 4 for 64 choices): the keep
    masks equal the reference's and the outputs agree at 1e-5. kimi adds
    its shared expert, which every token takes whatever drops."""
    x = _x((2, 16, 64))
    tcfg, tp, j_out, j_keep = _layer(arch, x, capacity_factor=cf)
    assert ("shared" in tp) == (arch == KIMI)
    out, keep = IMPLS[impl](tp, torch.from_numpy(x), tcfg, return_keep=True)
    np.testing.assert_array_equal(keep.numpy(), j_keep)
    if cf < 1:
        assert 0 < int(j_keep.sum()) < j_keep.size // 2
    np.testing.assert_allclose(out.numpy(), j_out, **LAYER_TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_moe_padding_takes_capacity(impl):
    """A right-padded batch: row 0 holds 5 real tokens and 11 padding
    positions (all one vector, as token 0's are), row 1 16 real tokens.
    Every position routes, so row 0's padding, which comes before row 1 in
    flattened order, takes capacity that row 1's tokens then lose: they
    come out otherwise than in a batch of row 1 alone with the same
    capacity, on both sides alike."""
    x = _x((2, 16, 64))
    x[0, 5:] = x[0, 5]
    kw = dict(capacity_factor=0.5)
    tcfg, tp, j_out, j_keep = _layer(OLMOE, x, **kw)
    out, keep = IMPLS[impl](tp, torch.from_numpy(x), tcfg, return_keep=True)
    np.testing.assert_array_equal(keep.numpy(), j_keep)
    np.testing.assert_allclose(out.numpy(), j_out, **LAYER_TOL)
    # the same capacity (C = 4) for row 1 alone at twice the factor
    alone_cfg, _ = _cfgs(OLMOE, capacity_factor=1.0)
    assert capacity(16, alone_cfg.moe) == capacity(32, tcfg.moe)
    _, _, j_alone, j_alone_keep = _layer(OLMOE, x[1:], capacity_factor=1.0)
    alone = IMPLS[impl](tp, torch.from_numpy(x[1:]), dataclasses.replace(
        tcfg, moe=alone_cfg.moe))
    np.testing.assert_allclose(alone.numpy(), j_alone, **LAYER_TOL)
    assert j_alone_keep.sum() > j_keep[16:].sum()
    assert np.abs(out.numpy()[1] - alone.numpy()[0]).max() > 1e-3


def test_moe_ties_go_to_the_lower_expert():
    """Zero inputs give every expert the same probability: both sides pick
    experts 0..K-1 in that order (jax.lax.top_k's), and positions count
    choice-major, so token t's first choice sits at position t."""
    from repro_torch.models.moe import route
    tcfg, tp, j_out, j_keep = _layer(OLMOE, np.zeros((1, 3, 64), np.float32))
    experts, gates = route(tp, torch.zeros(3, 64), tcfg)
    assert experts.tolist() == [[0, 1]] * 3
    probs = jax.nn.softmax(jnp.zeros((3, 4)), -1)
    assert np.asarray(jax.lax.top_k(probs, 2)[1]).tolist() == [[0, 1]] * 3
    assert positions(experts).tolist() == [[0, 0], [1, 1], [2, 2]]
    np.testing.assert_allclose(gates.numpy(), 0.5)
    out, keep = moe_ffn(tp, torch.zeros(1, 3, 64), tcfg, return_keep=True)
    np.testing.assert_array_equal(keep.numpy(), j_keep)


# ------------------------------------------------------------ params

@pytest.mark.parametrize("arch", [OLMOE, KIMI])
def test_router_float32_at_bf16_params(arch):
    """The router stays float32 on both paths when the parameters are
    bf16, as the reference's spec; every other leaf takes bf16."""
    cfg, tcfg = (dataclasses.replace(c, param_dtype="bfloat16")
                 for c in _cfgs(arch))
    jp = j_init_params(cfg, jax.random.key(0))
    assert jp["blocks"]["0"]["moe"]["router"].dtype == jnp.float32
    for tp in (init_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu"),
               from_jax_params(tcfg, jax.tree.map(np.asarray, jp),
                               device="cpu")):
        moe = tp["blocks"][0]["0"]["moe"]
        assert moe["router"].dtype == torch.float32
        assert moe["w_down"].dtype == torch.bfloat16
        assert tp["embed"]["table"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            moe["router"].shape, jp["blocks"]["0"]["moe"]["router"].shape[1:])
    np.testing.assert_array_equal(
        from_jax_params(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
        ["blocks"][0]["0"]["moe"]["router"].numpy(),
        np.asarray(jp["blocks"]["0"]["moe"]["router"][0]))


@pytest.mark.parametrize("arch", [OLMOE, KIMI])
def test_moe_init_equals_reference_spec(arch):
    """Full-size specs (nothing allocated): the experts' w_down (fan-in
    d_ff) and the shared expert's are damped by 1/sqrt(2L) as the
    reference's; the router keeps d**-0.5 and float32; kimi's dense first
    layer sits under "first" at d_ff."""
    cfg, tcfg = get_config(arch), tconfigs.get_config(arch)
    j = j_model_specs(cfg)
    t = model_specs(tcfg)
    jm, tm = j["blocks"]["0"]["moe"], t["blocks"][0]["0"]["moe"]
    damp = (2.0 * cfg.n_layers) ** -0.5
    assert tm["w_down"].std() == pytest.approx(jm["w_down"].scale, rel=1e-12)
    assert tm["w_down"].std() == pytest.approx(cfg.moe.d_ff ** -0.5 * damp,
                                               rel=1e-12)
    assert tm["router"].std() == pytest.approx(jm["router"].scale, rel=1e-12)
    assert tm["router"].dtype == "float32" == jnp.dtype(jm["router"].dtype)
    assert tm["w_gate"].std() == pytest.approx(cfg.d_model ** -0.5)
    assert ("first" in t) == ("first" in j) == (arch == KIMI)
    if arch == KIMI:
        sh = tm["shared"]["w_down"]
        assert sh.std() == pytest.approx(jm["shared"]["w_down"].scale,
                                         rel=1e-12)
        assert t["first"]["0"]["mlp"]["w_up"].shape == (cfg.d_model,
                                                        cfg.d_ff)
        assert t["first"]["0"]["mlp"]["w_down"].std() == pytest.approx(
            j["first"]["0"]["mlp"]["w_down"].scale, rel=1e-12)


# ------------------------------------------------------------ model

@pytest.fixture(scope="module")
def models():
    """arch -> (cfg, tcfg, JAX params, port params), built once a module."""
    built = {}

    def get(arch, **moe):
        key = (arch, tuple(sorted(moe.items())))
        if key not in built:
            cfg, tcfg = _cfgs(arch, **moe)
            jp = j_init_params(cfg, jax.random.key(0))
            tp = from_jax_params(tcfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")
            built[key] = (cfg, tcfg, jp, tp)
        return built[key]
    return get


def _pools(cfg, jcache, tcache):
    """(port, JAX) K and V pools of every layer in layer_kinds() order: the
    first dense layers', then the blocks' (stacked in the JAX cache)."""
    n, fk = len(cfg.block_pattern), cfg.first_k_dense
    for li, kv in enumerate(tcache):
        if li < fk:
            jkv, at = jcache["first"][str(li)]["kv"], None
        else:
            jkv, at = jcache["blocks"][str((li - fk) % n)]["kv"], (li - fk) // n
        for t, j in ((kv.k_pool, jkv.k_pool), (kv.v_pool, jkv.v_pool)):
            j = np.asarray(j)
            yield t.numpy().copy(), j if at is None else j[at]


@pytest.fixture(scope="module", params=[OLMOE, KIMI, KIMI_D112])
def served(request, models):
    """Three right-padded prompts beside an empty slot, prefilled through
    the serving layout (the padding and the empty row route and take
    capacity), then one decode step of all four slots."""
    cfg, tcfg, jp, tp = models(request.param)
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
    """One shared-pool layer per layer kind, the first dense layers
    first."""
    cfg = served["cfg"]
    assert len(served["tcache"]) == cfg.n_layers == len(cfg.layer_kinds())
    assert cfg.layer_kinds()[0] == ("attn_mlp" if cfg.first_k_dense
                                    else "attn_moe")
    for kv in served["tcache"]:
        assert tuple(kv.k_pool.shape) == (TOTAL, PAGE, cfg.n_kv_heads,
                                          cfg.d_head)


def test_prefill_logits_and_pools(served):
    jl, tl, pools = served["prefill"]
    np.testing.assert_allclose(tl[:3], jl[:3], **TOL)
    assert len(pools) == 2 * served["cfg"].n_layers
    for t, j in pools:
        np.testing.assert_allclose(t, j, **TOL)


def test_decode_logits_and_pools(served):
    jd, td, pools = served["decode"]
    np.testing.assert_allclose(td, jd, **TOL)
    for t, j in pools:
        np.testing.assert_allclose(t, j, **TOL)
    assert all(kv.length.tolist() == [13, 8, 17, 1]
               for kv in served["tcache"])


@pytest.mark.parametrize("arch", [OLMOE, KIMI, KIMI_D112])
def test_decode_matches_prefill(models, arch):
    """tests/test_decode_consistency.py's MoE case on the port: at capacity
    16 nothing drops, so a prefill of 24 tokens and one decode step equal a
    prefill of 25; and the decode equals the JAX model's."""
    cfg, tcfg, jp, tp = models(arch, capacity_factor=16.0)
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

@pytest.mark.parametrize("arch,kind,mode,name,arrival", [
    (OLMOE, "fixed", "zero_copy", "prefix", 1),
    (OLMOE, "fixed", "zero_copy", "pressure", 3),
    (OLMOE, "fixed", "copy", "pressure", 1),
    (OLMOE, "continuous", "zero_copy", "pressure", 1),
    (OLMOE, "disagg-share", "zero_copy", "pressure", 1),
    (OLMOE, "disagg-copy", "zero_copy", "pressure", 3),
    (KIMI, "fixed", "zero_copy", "prefix", 3),
    (KIMI_D112, "fixed", "zero_copy", "prefix", 3)])
def test_engine_matches_jax_engine(models, arch, kind, mode, name, arrival):
    """The same tokens, stats (wall clock aside) and translation trace as
    the JAX engine of the same kind; the continuous engine over a pool of
    POOL pages, which preempts."""
    # imported here, not with the module, so that the on_card cases also
    # run where an installed ``tests`` package shadows this repo's
    from tests.conformance import (ARRIVAL_CASES, POOL, Workload, drive,
                                   make_engine, prefix_workload,
                                   pressure_workload)
    from tests.test_torch_archs import _strip_wall_clock
    from tests.test_torch_disagg import make_port_engine
    cfg, tcfg, jp, tp = models(arch)
    base = (prefix_workload(cfg.vocab_size) if name == "prefix"
            else pressure_workload(cfg.vocab_size))
    wl = Workload(base.prompts, base.maxtoks,
                  arrivals=tuple(ARRIVAL_CASES[arrival]))
    kw = dict(record_translation_trace=True, offload_mode=mode)
    if kind == "continuous":
        kw["pool_pages"] = POOL
    if kind.startswith("disagg-"):
        kw.pop("offload_mode")
    jeng = make_engine(cfg, jp, kind, **kw)
    teng = make_port_engine(tcfg, tp, kind, **kw)
    assert drive(teng, wl)[0] == drive(jeng, wl)[0]
    st = teng.stats()
    assert _strip_wall_clock(st) == _strip_wall_clock(jeng.stats())
    assert teng.translation_trace == jeng.translation_trace
    if mode == "copy":
        assert st["staging_copies"] == len(wl.prompts)
    else:
        assert st["staging_copies"] == 0
    if kind == "continuous":
        assert st["sched"]["preemptions"] > 0
    if name == "prefix" and kind == "fixed":
        assert st["shared_admissions"] > 0 and st["prefill_tokens_saved"] > 0


def test_kv_bytes_count_attention_layers(models):
    """The manager's per-token KV bytes count the layers that hold KV, as
    the reference's expression does."""
    from tests.conformance import make_engine
    cfg, tcfg, jp, tp = models(KIMI)
    kw = dict(n_slots=2, max_len=32, page_size=8)
    jeng = make_engine(cfg, jp, "fixed", **kw)
    teng = ServingEngine(tcfg, tp, device="cpu", **kw)
    want = 2 * tcfg.n_kv_heads * tcfg.d_head * tcfg.n_layers * 4
    assert teng.mgr.kv_bytes_per_token == jeng.mgr.kv_bytes_per_token == want


# ------------------------------------------------------------ front-ends

@pytest.mark.parametrize("arch", [OLMOE, KIMI])
@pytest.mark.parametrize("mode", ["zero_copy", "copy"])
def test_serve_cli_on_cpu(capsys, arch, mode):
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-tokens", "3",
                       "--prompt-len", "12", "--offload-mode", mode]) == 0
    out = capsys.readouterr().out
    assert out.count("req ") == 3
    assert f'"staging_copies": {3 if mode == "copy" else 0}' in out


def test_serve_cli_refuses_kimi_at_full_width(capsys):
    with pytest.raises(SystemExit):
        serve.main(["--arch", KIMI, "--device", "cpu"])
    assert "--smoke" in capsys.readouterr().err


@pytest.mark.parametrize("argv,expect", [
    (["--arch", OLMOE], "prefill tokens saved: 112"),
    (["--arch", OLMOE, "--disagg", "copy"], "transfers: 10 (copy)"),
    (["--arch", KIMI], "prefill tokens saved: 112")])
def test_serve_paged_on_cpu(capsys, argv, expect):
    assert serve_paged.main(["--device", "cpu", *argv]) == 0
    out = capsys.readouterr().out
    assert expect in out and out.count("  req ") == 4


# ------------------------------------------------------------ card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("arch,cf", [(OLMOE, 0.25), (OLMOE, 1.25),
                                     (KIMI, 1.25)])
def test_index_dispatch_matches_plain_on_card(cuda, dtype, tol, arch, cf):
    """On the card the main path gives the plain version's keep mask bit
    for bit and its output within the dtype's tolerance."""
    _, tcfg = _cfgs(arch, capacity_factor=cf)
    tcfg = dataclasses.replace(tcfg, param_dtype=dtype,
                               activation_dtype=dtype)
    params = init_params(tcfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    p = params["blocks"][0]["0"]["moe"]
    x = torch.from_numpy(_x((3, 40, 64))).to(cuda, getattr(torch, dtype))
    out, keep = moe_ffn(p, x, tcfg, return_keep=True)
    ref, ref_keep = moe_ffn_ref(p, x, tcfg, return_keep=True)
    torch.cuda.synchronize()
    assert torch.equal(keep, ref_keep)
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_index_dispatch_makes_no_host_sync_on_card(cuda):
    _, tcfg = _cfgs(OLMOE)
    params = init_params(tcfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    p = params["blocks"][0]["0"]["moe"]
    x = torch.randn(4, 16, 64, device=cuda)
    moe_ffn(p, x, tcfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        moe_ffn(p, x, tcfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
