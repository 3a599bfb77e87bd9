"""The port's random init against the reference's, and what that init does
at depth.

``repro_torch.models.init_params`` draws every leaf from the distribution
the reference's ``model_specs`` gives it: the same shape, init kind and
std, residual damping included. This is checked on the specs of the
full-size configs, so nothing is allocated.

That init is chaotic at full depth. ``ParamSpec.fan_in`` is a weight's
``shape[-2]``, which for a (d_model, heads, d_head) projection is the
heads axis, so wq and wk draw at std heads**-0.5 and attention is sharp.
Moving each embedding element by one part in 128 (a bf16 rounding step or
two) then moves the last logits by ``CHAOTIC`` or more (relative to their
largest), so no end-to-end comparison of two bf16 paths can hold on it.
With wq and wk scaled by 0.1 the same move stays below 0.05. At the
smoke widths all four archs read chaotic; the gain depends on width too,
so ``chip_smoke.py`` phase 3e reads it on the card at full width
(``sensitivity``) and chooses its end-to-end checks by it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models.blocks import FwdCtx  # noqa: E402
from repro.models.layers import logits_fn, rmsnorm  # noqa: E402
from repro.models.model import NO_MESH, _embed_in, _run_blocks  # noqa: E402
from repro.models.model import model_specs as j_model_specs  # noqa: E402
from repro.models.params import is_spec  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models.params import model_specs  # noqa: E402

ARCHS = ("llama3.2-1b", "qwen2-7b", "llama3.2-3b", "gemma2-2b")
SPEC_ARCHS = ARCHS + ("olmoe-1b-7b", "kimi-k2-1t-a32b")
CHAOTIC = 0.5           # chip_smoke.py's threshold of the same name
QK_SCALE = 0.1
STABLE = 0.05


def _j_leaves(tree, path=()):
    """(path, spec) of the reference's specs, the stacked blocks split into
    the port's per-block dicts."""
    if is_spec(tree):
        yield path, tree
        return
    for k, v in tree.items():
        if k == "blocks":
            for name, layer in v.items():
                for p, s in _j_leaves(layer):
                    yield ("blocks", name) + p, s
        else:
            yield from _j_leaves(v, path + (k,))


def _flat(tree, path=()):
    """{path: (shape, init kind, std or None)} of the port's specs."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    std = tree.std() if tree.init == "normal" else None
    return {path: (tuple(tree.shape), tree.init, std)}


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_init_distribution_equals_reference(arch):
    """Full-size specs: every leaf's shape, init kind and std agree."""
    cfg, tcfg = get_config(arch), tconfigs.get_config(arch)
    ref = {}
    for path, s in _j_leaves(j_model_specs(cfg)):
        shape = s.shape[1:] if path[0] == "blocks" else s.shape
        assert path[0] != "blocks" or s.shape[0] == cfg.n_blocks
        std = (s.scale if s.scale is not None else s.fan_in() ** -0.5) \
            if s.init == "normal" else None
        ref[path] = (tuple(shape), s.init, std)
    specs = model_specs(tcfg)
    blocks = specs.pop("blocks")
    assert len(blocks) == tcfg.n_blocks
    assert all(_flat(b) == _flat(blocks[0]) for b in blocks)
    got = {**_flat(specs), **_flat(blocks[0], ("blocks",))}
    assert set(got) == set(ref)
    for p in ref:
        assert got[p][:2] == ref[p][:2], p
        if ref[p][2] is not None:
            assert got[p][2] == pytest.approx(ref[p][2], rel=1e-12), p
    # the heads axis is the fan-in of wq: std heads**-0.5, not d_model**-0.5
    wq = got[("blocks", "0", "attn", "wq")]
    assert wq[2] == pytest.approx(cfg.n_heads ** -0.5)


def _sensitivity(cfg, params, qk_scale=1.0, S=64, B=2):
    """The reference's logits' rel move when each embedding element moves
    by one part in 128 (as chip_smoke.py's ``_input_sensitivity``)."""
    def scale(path, a):
        name = jax.tree_util.keystr(path)
        return a * qk_scale if ("'wq'" in name or "'wk'" in name) else a
    params = jax.tree_util.tree_map_with_path(scale, params)
    r = np.random.default_rng(2)
    toks = jnp.asarray(r.integers(0, cfg.vocab_size, (B, S)))
    sign = jnp.asarray(r.integers(0, 2, (B, S, cfg.d_model)) * 2 - 1,
                       jnp.float32)
    ctx = FwdCtx(cfg=cfg, mi=NO_MESH, mode="prefill")
    x0 = _embed_in(cfg, params, toks, NO_MESH)
    out = []
    for x in (x0, x0 * (1 + sign / 128)):
        y, _ = _run_blocks(cfg, params, x, ctx, None)
        y = rmsnorm(y[:, -1:], params["final_ln"], cfg.norm_eps)
        out.append(np.asarray(logits_fn(params["embed"], y,
                                        cfg.logit_softcap)))
    return float(np.abs(out[1] - out[0]).max() / np.abs(out[0]).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_init_is_chaotic_at_full_depth(arch):
    """The reference's own init, smoke widths at the full config's depth:
    chaotic as built, stable with wq and wk scaled by QK_SCALE."""
    full = get_config(arch)
    cfg = dataclasses.replace(reduce_for_smoke(full), n_layers=full.n_layers)
    params = j_init_params(cfg, jax.random.key(0))
    assert _sensitivity(cfg, params) >= CHAOTIC
    assert _sensitivity(cfg, params, QK_SCALE) < STABLE
