"""Smoke llama3.2-1b (fp32) in the port against the JAX model, with the same
weights (JAX ``init_params`` -> numpy -> ``from_jax_params``): prefill
logits over right-padded rows, a prefix-continuation prefill through
``write_tables``, a decode step, and the shared KV pools after each; then
the per-slot layout of the copy baseline (each branch of its prefill write,
then a decode step), at atol 1e-4 / rtol 1e-4. Last, the same smoke model
in bf16 (the dtype the serving path runs in), prefill and decode logits at
a bf16 tolerance."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.core.serving.engine import (_build_prefill_view,  # noqa: E402
                                       _install_tables, _merge_prefill_view)
from repro.models import forward_decode as j_decode  # noqa: E402
from repro.models import forward_prefill as j_prefill  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models.model import \
    set_cache_length as j_set_cache_length  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import (forward_decode, forward_prefill,  # noqa: E402
                                from_jax_params, init_cache, init_params)
from repro_torch.models.model import (install_tables,  # noqa: E402
                                      set_cache_length)
from repro_torch.models.params import count_params, model_specs  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
SLOTS, MAX_LEN, PAGE = 4, 32, 8
P = MAX_LEN // PAGE
TOTAL = SLOTS * P


@pytest.fixture(scope="module")
def models():
    cfg = reduce_for_smoke(get_config("llama3.2-1b"))
    tcfg = reduce_for_smoke(tconfigs.get_config("llama3.2-1b"))
    jp = j_init_params(cfg, jax.random.key(0))
    tp = from_jax_params(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, tcfg, jp, tp


def _j_pools(cache):
    kv = cache["blocks"]["0"]["kv"]
    return np.asarray(kv.k_pool), np.asarray(kv.v_pool)


def _t_pools(cache):
    return (np.stack([kv.k_pool.numpy() for kv in cache]),
            np.stack([kv.v_pool.numpy() for kv in cache]))


def _prefill_both(models, tokens, lengths, tables, jcache, tcache,
                  prefix=None, wtables=None):
    cfg, tcfg, jp, tp = models
    jb = {"tokens": jnp.asarray(tokens), "lengths": jnp.asarray(lengths)}
    tb = {"tokens": torch.from_numpy(tokens).long(),
          "lengths": torch.from_numpy(lengths)}
    if prefix is not None:
        jb["prefix_lens"], jb["write_tables"] = (jnp.asarray(prefix),
                                                 jnp.asarray(wtables))
        tb["prefix_lens"], tb["write_tables"] = (torch.from_numpy(prefix),
                                                 torch.from_numpy(wtables))
    view = _build_prefill_view(jcache, jnp.asarray(tables), jnp.asarray(lengths))
    jl, view = j_prefill(cfg, jp, jb, view)
    jcache = _merge_prefill_view(jcache, view, jnp.arange(len(lengths)))
    tl, _ = forward_prefill(tcfg, tp, tb, install_tables(
        tcache, torch.from_numpy(tables), tb["lengths"]))
    return np.asarray(jl), tl.float().numpy(), jcache


@pytest.fixture(scope="module")
def prefilled(models):
    """Three right-padded prompts (one slot left empty) prefilled into a
    fresh pool; then a fourth sequence that maps row 0's first page as a
    cached prefix and prefills only its suffix."""
    cfg, tcfg, _, _ = models
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
    jl, tl, jcache = _prefill_both(models, tokens, lengths, tables, jcache,
                                   tcache)
    after_plain = (_j_pools(jcache), _t_pools(tcache))
    # Prefix continuation: slot 3 shares page 5 (row 0's first 8 tokens).
    prefix = np.array([PAGE, 0], np.int32)
    suf = np.array([5, 0], np.int32)
    stoks = np.zeros((2, 8), np.int32)
    stoks[0, :5] = r.integers(0, cfg.vocab_size, 5)
    stables = np.full((2, P), TOTAL, np.int32)
    stables[0, :2] = [5, 11]
    wtables = stables.copy()
    wtables[0, 0] = TOTAL                 # the shared page is never written
    jl2, tl2, jcache = _prefill_both(models, stoks, suf, stables, jcache,
                                     tcache, prefix=prefix, wtables=wtables)
    return dict(plain=(jl, tl), after_plain=after_plain, prefix=(jl2, tl2),
                after_prefix=(_j_pools(jcache), _t_pools(tcache)),
                jcache=jcache, tcache=tcache, lengths=lengths)


def test_specs_and_init_match_jax_shapes(models):
    cfg, tcfg, jp, tp = models
    shapes = jax.tree.map(lambda a: a.shape, jp)
    specs = model_specs(tcfg)
    assert specs["embed"]["table"].shape == shapes["embed"]["table"]
    for name, leaf in specs["blocks"][0]["0"]["attn"].items():
        assert (tcfg.n_blocks,) + leaf.shape == shapes["blocks"]["0"]["attn"][name]
    g = torch.Generator().manual_seed(0)
    fresh = init_params(tcfg, g, device="cpu")
    assert count_params(fresh) == count_params(tp) == sum(
        int(np.prod(s)) for s in jax.tree.leaves(shapes,
                                                 is_leaf=lambda x: isinstance(x, tuple)))
    assert torch.equal(fresh["final_ln"], torch.ones(tcfg.d_model))
    std = fresh["embed"]["table"].std().item()
    assert 0.018 < std < 0.022
    wo = fresh["blocks"][0]["0"]["attn"]["wo"]     # fan_in**-0.5 * 1/sqrt(2L)
    expect = tcfg.d_head ** -0.5 / np.sqrt(2 * tcfg.n_layers)
    assert abs(wo.std().item() / expect - 1) < 0.1


def test_prefill_logits_right_padded(prefilled):
    jl, tl = prefilled["plain"]
    np.testing.assert_allclose(tl[:3], jl[:3], **TOL)


def test_prefill_pools(prefilled):
    (jk, jv), (tk, tv) = prefilled["after_plain"]
    np.testing.assert_allclose(tk, jk, **TOL)
    np.testing.assert_allclose(tv, jv, **TOL)


def test_prefix_continuation_logits(prefilled):
    jl, tl = prefilled["prefix"]
    np.testing.assert_allclose(tl[:1], jl[:1], **TOL)


def test_prefix_continuation_pools(prefilled):
    (jk, jv), (tk, tv) = prefilled["after_prefix"]
    np.testing.assert_allclose(tk, jk, **TOL)
    np.testing.assert_allclose(tv, jv, **TOL)
    # the shared page kept row 0's KV: the suffix-only prefill never wrote it
    np.testing.assert_array_equal(tk[:, 5], prefilled["after_plain"][1][0][:, 5])


def test_decode_step(models, prefilled):
    cfg, tcfg, jp, tp = models
    r = np.random.default_rng(1)
    tables = np.full((SLOTS, P), TOTAL, np.int32)
    tables[0, :2], tables[1, :1], tables[2, :2] = [5, 2], [9], [0, 14]
    tables[3, :2] = [5, 11]
    kv_len = np.array([12, 7, 16, 13], np.int32)
    tok = r.integers(0, cfg.vocab_size, (SLOTS, 1)).astype(np.int32)
    jc = _install_tables(prefilled["jcache"], jnp.asarray(tables),
                         jnp.asarray(kv_len))
    jl, jc = j_decode(cfg, jp, jnp.asarray(tok), jnp.asarray(kv_len), jc)
    tc = install_tables(prefilled["tcache"], torch.from_numpy(tables),
                        torch.from_numpy(kv_len))
    tl, tc = forward_decode(tcfg, tp, torch.from_numpy(tok).long(),
                            torch.from_numpy(kv_len), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jk, jv = _j_pools(jc)
    tk, tv = _t_pools(tc)
    np.testing.assert_allclose(tk, jk, **TOL)
    np.testing.assert_allclose(tv, jv, **TOL)
    assert tc[0].length.tolist() == (kv_len + 1).tolist()


def test_from_jax_params_rejects_wrong_shapes(models):
    cfg, tcfg, jp, _ = models
    tree = jax.tree.map(np.asarray, jp)
    tree["final_ln"] = tree["final_ln"][:-1]
    with pytest.raises(ValueError):
        from_jax_params(tcfg, tree, device="cpu")


# ------------------------------------------------ per-slot (copy-mode) layout

def _slot_caches(models, batch, max_len, seed):
    """JAX and port per-slot caches of ``batch`` slots, both mapped through
    the same random permutation tables, lengths 0."""
    from repro.core.serving.engine import _map_tables as j_map_tables
    cfg, tcfg, _, _ = models
    n_pages = max_len // PAGE
    r = np.random.default_rng(seed)
    tables = np.stack([r.permutation(n_pages)
                       for _ in range(batch)]).astype(np.int32)
    zeros = np.zeros((batch,), np.int32)
    jcache = j_map_tables(j_init_cache(cfg, batch, max_len, PAGE,
                                       per_seq=True), tables, zeros)
    tcache = install_tables(init_cache(tcfg, batch, max_len, PAGE,
                                       device="cpu"),
                            torch.from_numpy(tables), torch.from_numpy(zeros))
    return jcache, tcache, tables


# (max_len, S, lengths): right-padded rows with and without a row longer
# than the pool, then one exact-length prompt shorter than, as long as and
# longer than the pool (the ``eff > S``, ``eff == S`` and ``eff < S``
# branches).
SLOT_PREFILLS = [(32, 16, (12, 7, 16)), (16, 24, (24, 9, 20)),
                 (32, 13, None), (32, 32, None), (16, 21, None)]


@pytest.mark.parametrize("max_len,S,lengths", SLOT_PREFILLS)
def test_slot_prefill_write_then_decode(models, max_len, S, lengths):
    """Per-slot prefill through permutation tables, then one decode step with
    an inactive (length-0) slot beside the live ones: logits, pools and
    lengths against the JAX model."""
    cfg, tcfg, jp, tp = models
    B = len(lengths) if lengths is not None else 1
    jcache, tcache, tables = _slot_caches(models, B + 1, max_len, S)
    r = np.random.default_rng(S)
    tokens = r.integers(0, cfg.vocab_size, (B + 1, S)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens)}
    tb = {"tokens": torch.from_numpy(tokens).long()}
    if lengths is not None:
        lens = np.array(lengths + (0,), np.int32)
        tokens[np.arange(S)[None, :] >= lens[:, None]] = 0
        jb = {"tokens": jnp.asarray(tokens), "lengths": jnp.asarray(lens)}
        tb = {"tokens": torch.from_numpy(tokens).long(),
              "lengths": torch.from_numpy(lens)}
    jl, jcache = j_prefill(cfg, jp, jb, jcache)
    tl, tcache = forward_prefill(tcfg, tp, tb, tcache)
    live = slice(0, B)
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], **TOL)
    jk, jv = _j_pools(jcache)
    tk, tv = _t_pools(tcache)
    np.testing.assert_allclose(tk, jk, **TOL)
    np.testing.assert_allclose(tv, jv, **TOL)
    # one decode step; the last slot is inactive (length 0)
    kv_len = (np.array(lengths + (0,), np.int32) if lengths is not None
              else np.array([S, 0], np.int32))
    tok = r.integers(0, cfg.vocab_size, (B + 1, 1)).astype(np.int32)
    jl, jcache = j_decode(cfg, jp, jnp.asarray(tok), jnp.asarray(kv_len),
                          j_set_cache_length(jcache, jnp.asarray(kv_len)))
    tl, tc = forward_decode(tcfg, tp, torch.from_numpy(tok).long(),
                            torch.from_numpy(kv_len),
                            set_cache_length(tcache, torch.from_numpy(kv_len)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jk, jv = _j_pools(jcache)
    tk, tv = _t_pools(tc)
    np.testing.assert_allclose(tk, jk, **TOL)
    np.testing.assert_allclose(tv, jv, **TOL)
    assert tc[0].length.tolist() == (kv_len + 1).tolist()


# ------------------------------------------------------------ bf16 model

# The logits are bf16, and the two frameworks round the same bf16 values at
# other points (matmul sums, the softmax, the norms), so a logit may land a
# few rounding steps away: bf16 keeps 8 significant bits, a step of 2**-8
# at the logits' size here (|logit| < 1). 2**-6 allows four such steps.
BF16_TOL = dict(atol=2.0 ** -6, rtol=2.0 ** -6)


@pytest.fixture(scope="module")
def bf16_served():
    """The smoke llama3.2-1b with bf16 weights and activations in both
    models (JAX weights -> numpy -> the port): right-padded prefill of three
    prompts beside an empty slot, then one decode step of all four slots."""
    bf = dict(param_dtype="bfloat16", activation_dtype="bfloat16")
    cfg = dataclasses.replace(reduce_for_smoke(get_config("llama3.2-1b")), **bf)
    tcfg = dataclasses.replace(
        reduce_for_smoke(tconfigs.get_config("llama3.2-1b")), **bf)
    jp = j_init_params(cfg, jax.random.key(0))
    tp = from_jax_params(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
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
    jl, tl, jcache = _prefill_both((cfg, tcfg, jp, tp), tokens, lengths,
                                   tables, jcache, tcache)
    tok = r.integers(0, cfg.vocab_size, (SLOTS, 1)).astype(np.int32)
    jc = _install_tables(jcache, jnp.asarray(tables), jnp.asarray(lengths))
    jd, jc = j_decode(cfg, jp, jnp.asarray(tok), jnp.asarray(lengths), jc)
    tc = install_tables(tcache, torch.from_numpy(tables),
                        torch.from_numpy(lengths))
    td, tc = forward_decode(tcfg, tp, torch.from_numpy(tok).long(),
                            torch.from_numpy(lengths), tc)
    return dict(prefill=(jl, tl), decode=(np.asarray(jd), td),
                tcache=tcache, jcache=jc)


def _f32(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a).astype(np.float32))


def test_bf16_prefill_logits(bf16_served):
    jl, tl = bf16_served["prefill"]
    np.testing.assert_allclose(tl[:3], _f32(jl)[:3], **BF16_TOL)


def test_bf16_decode_logits(bf16_served):
    jd, td = bf16_served["decode"]
    assert td.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(td), _f32(jd), **BF16_TOL)
    jk, jv = _j_pools(bf16_served["jcache"])
    tk = np.stack([_f32(kv.k_pool) for kv in bf16_served["tcache"]])
    tv = np.stack([_f32(kv.v_pool) for kv in bf16_served["tcache"]])
    np.testing.assert_allclose(tk, _f32(jk), **BF16_TOL)
    np.testing.assert_allclose(tv, _f32(jv), **BF16_TOL)
