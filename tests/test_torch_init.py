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

The recurrent archs differ. rwkv6-3b has no attention and is not chaotic
at full depth, so phase 3g serves it as built and gates its end-to-end
checks. jamba's five-layer cut (phase 3g's) is chaotic as built, and with
wq and wk scaled it still reads above 0.05 (the scaling leaves its four
mamba layers and its expert routing as they were). So phase 3g's first-
token check holds each jamba request whose serve prefill made the B=1
prefill's expert choices, and reads the rest beside their flipped choices.
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
RWKV, JAMBA = "rwkv6-3b", "jamba-1.5-large-398b"
VISION, SEAMLESS = "llama-3.2-vision-90b", "seamless-m4t-medium"
SPEC_ARCHS = ARCHS + ("olmoe-1b-7b", "kimi-k2-1t-a32b", RWKV, JAMBA, VISION,
                      SEAMLESS)
JAMBA_CUT = 5           # chip_smoke.py phase 3g's cut of jamba's period
CHAOTIC = 0.5           # chip_smoke.py's threshold of the same name
QK_SCALE = 0.1
STABLE = 0.05


def _j_leaves(tree, path=()):
    """(path, spec) of the reference's specs, the stacked blocks (the
    decoder's, and an encoder's under ``("encoder",)``) split into the
    port's per-block dicts."""
    if is_spec(tree):
        yield path, tree
        return
    for k, v in tree.items():
        if k == "blocks":
            for name, layer in v.items():
                for p, s in _j_leaves(layer):
                    yield path + ("blocks", name) + p, s
        else:
            yield from _j_leaves(v, path + (k,))


def _flat(tree, cfg, path=()):
    """{path: (shape, init kind, std (normal) or half-width (uniform_pm) or
    None, dtype name)} of the port's specs."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, cfg, path + (k,)))
        return out
    std = tree.std() if tree.init in ("normal", "uniform_pm") else None
    return {path: (tuple(tree.shape), tree.init, std,
                   str(tree.torch_dtype(cfg)).split(".")[-1])}


def _ref_flat(cfg):
    """The same of the reference's specs, the blocks unstacked."""
    ref = {}
    n_enc = cfg.n_enc_layers // len(cfg.enc_block_pattern)
    for path, s in _j_leaves(j_model_specs(cfg)):
        stacked = "blocks" in path[:2]
        shape = s.shape[1:] if stacked else s.shape
        assert not stacked or s.shape[0] == (
            n_enc if path[0] == "encoder" else cfg.n_blocks)
        std = (s.scale if s.scale is not None else s.fan_in() ** -0.5) \
            if s.init in ("normal", "uniform_pm") else None
        ref[path] = (tuple(shape), s.init, std, jnp.dtype(s.dtype).name)
    return ref


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_init_distribution_equals_reference(arch):
    """Full-size specs: every leaf's shape, init kind, std (or uniform
    half-width) and dtype agree."""
    cfg, tcfg = get_config(arch), tconfigs.get_config(arch)
    ref = _ref_flat(cfg)
    got = _port_flat(tcfg)
    assert set(got) == set(ref)
    for p in ref:
        assert got[p][:2] == ref[p][:2], p
        assert got[p][3] == ref[p][3], p
        if ref[p][2] is not None:
            assert got[p][2] == pytest.approx(ref[p][2], rel=1e-12), p
    # the heads axis is the fan-in of wq: std heads**-0.5, not d_model**-0.5
    attn = [p for p in got if p[-2:] == ("attn", "wq")]
    assert attn or arch == RWKV
    for p in attn:
        assert got[p][2] == pytest.approx(cfg.n_heads ** -0.5)


def _port_flat(tcfg):
    """The port's specs flattened, each stack of blocks (the decoder's and
    an encoder's) as its first block, which every other equals."""
    specs = model_specs(tcfg)
    out = {}
    for where in (specs, specs.get("encoder", {})):
        if "blocks" not in where:
            continue
        blocks = where.pop("blocks")
        assert all(_flat(b, tcfg) == _flat(blocks[0], tcfg) for b in blocks)
        prefix = ("encoder",) if where is not specs else ()
        out.update(_flat(blocks[0], tcfg, prefix + ("blocks",)))
    assert len(model_specs(tcfg)["blocks"]) == tcfg.n_blocks
    return {**_flat(specs, tcfg), **out}


@pytest.mark.parametrize("arch,damped,fp32,uniform", [
    (RWKV, {("tm", "wo")}, {("tm", k) for k in ("w0", "w_lora_b", "u",
                                                 "ln_w")},
     {("tm", "mu"): 0.5, ("tm", "w0"): 1.0, ("tm", "u"): 0.5,
      ("cm", "mu_k"): 0.5, ("cm", "mu_r"): 0.5}),
    (JAMBA, {("attn", "wo"), ("mlp", "w_down"), ("moe", "w_down"),
             ("mamba", "out_proj")},
     {("moe", "router")} | {("mamba", k) for k in ("dt_bias", "A_log", "D")},
     {("mamba", "dt_bias"): 4.0, ("mamba", "A_log"): 1.0})])
def test_recurrent_leaves(arch, damped, fp32, uniform):
    """Full size, bf16 parameters: the leaves whose std is damped by
    1/sqrt(2L) (rwkv's channel-mix wv is not: the reference damps only
    wo, w_down, w2 and out_proj), the float32 leaves and the uniform_pm
    half-widths, over every layer of a block."""
    tcfg = tconfigs.get_config(arch)
    assert tcfg.param_dtype == "bfloat16"
    got = _port_flat(tcfg)
    damp = (2.0 * tcfg.n_layers) ** -0.5
    layer = lambda p: p[2:] if p[0] == "blocks" else None
    assert damped == {layer(p) for p, (shape, init, std, _) in got.items()
                      if p[0] == "blocks" and init == "normal"
                      and std != pytest.approx(_undamped(shape))}
    for p, (shape, init, std, dt) in got.items():
        if layer(p) in damped:
            assert std == pytest.approx(_undamped(shape) * damp), p
        assert (dt == "float32") == (layer(p) in fp32), p
        if init == "uniform_pm":
            assert std == uniform[layer(p)], p
    assert {layer(p) for p in got if got[p][1] == "uniform_pm"} == \
        set(uniform)


@pytest.mark.parametrize("arch,damped,n_enc_blocks", [
    (VISION, {("attn", "wo"), ("xattn", "wo"), ("mlp", "w_down")}, 0),
    (SEAMLESS, {("attn", "wo"), ("xattn", "wo"), ("mlp", "w2")}, 12)])
def test_cross_leaves(arch, damped, n_enc_blocks):
    """Full size, bf16 parameters: the cross-attention's and the 2-layer
    MLP's residual projections damped by 1/sqrt(2L) at the decoder's depth
    (the encoder's too), the cross gate a zero scalar, no cross biases, and
    the encoder's blocks and final norm."""
    tcfg = tconfigs.get_config(arch)
    got = _port_flat(tcfg)
    damp = (2.0 * tcfg.n_layers) ** -0.5
    stacks = [("blocks",)] + ([("encoder", "blocks")] if n_enc_blocks else [])
    seen = set()
    for p, (shape, init, std, dt) in got.items():
        stack = next((s for s in stacks if p[:len(s)] == s), None)
        if stack is None or init != "normal":
            continue
        layer = p[len(stack) + 1:]
        if std != pytest.approx(_undamped(shape)):
            assert layer in damped, p
            assert std == pytest.approx(_undamped(shape) * damp), p
            seen.add(layer)
    assert seen == damped
    gates = {p: v for p, v in got.items() if p[-1] == "gate"}
    assert gates and all(v == ((), "zeros", None, "bfloat16")
                         for v in gates.values())
    assert not [p for p in got if "xattn" in p and p[-1].startswith("b")]
    specs = model_specs(tcfg)
    if n_enc_blocks:
        assert len(specs["encoder"]["blocks"]) == n_enc_blocks
        assert got[("encoder", "final_ln")] == ((tcfg.d_model,), "ones",
                                                None, "bfloat16")
        assert {p[3:] for p in got if p[:2] == ("encoder", "blocks")} >= {
            ("attn", "wo"), ("mlp", "w1"), ("mlp", "w2")}
    else:
        assert "encoder" not in specs


def _undamped(shape):
    return shape[-2] ** -0.5 if len(shape) > 1 else shape[-1] ** -0.5


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


def _cut(arch, n_layers=None, pattern=None):
    """Smoke widths at ``n_layers`` (the full config's by default) over
    ``pattern`` (the config's by default)."""
    full = get_config(arch)
    pattern = pattern or full.block_pattern
    return dataclasses.replace(reduce_for_smoke(full),
                               n_layers=n_layers or full.n_layers,
                               block_pattern=pattern)


def test_recurrent_sensitivity_at_smoke_widths():
    """What phase 3g's (a) reads on the card, at smoke widths: rwkv6 at
    full depth is not chaotic (served as built); jamba's cut is chaotic as
    built and, q/k-scaled, still above STABLE."""
    rwkv = _cut(RWKV)
    assert rwkv.n_layers == 32
    assert _sensitivity(rwkv, j_init_params(rwkv, jax.random.key(0))) \
        < CHAOTIC
    full = get_config(JAMBA)
    cut = _cut(JAMBA, JAMBA_CUT, full.block_pattern[:JAMBA_CUT])
    params = j_init_params(cut, jax.random.key(0))
    assert _sensitivity(cut, params) >= CHAOTIC
    assert _sensitivity(cut, params, QK_SCALE) >= STABLE
