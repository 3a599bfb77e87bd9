"""Smoke llama3.2-1b (fp32) in the port against the JAX model, with the same
weights (JAX ``init_params`` -> numpy -> ``from_jax_params``): prefill
logits over right-padded rows, a prefix-continuation prefill through
``write_tables``, a decode step, and the shared KV pools after each, at
atol 1e-4 / rtol 1e-4."""
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
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import (forward_decode, forward_prefill,  # noqa: E402
                                from_jax_params, init_cache, init_params)
from repro_torch.models.model import install_tables  # noqa: E402
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
    return np.asarray(jl), tl.numpy(), jcache


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
