"""The port's training path against the JAX package on the CPU, fp32:
flash attention's backward against ``jax.grad`` of
``repro.models.attention.flash_attention`` (GQA, window, softcap,
non-causal over more keys than queries, a query offset, several chunks),
the plain forward's log-sum-exp against the reference's ``fwd_blocks``,
``chunked_xent``, ``aux_load_balance_loss``, and ``forward_train``'s loss
and every leaf's gradient against ``jax.value_and_grad(forward_train)`` on
the same weights (JAX ``init_params`` -> numpy -> ``from_jax_params``) for
one arch of each family; last, the three remat modes give one gradient.

Tolerances are relative to the largest magnitude of what is compared: the
two packages sum in other orders, and the backward adds up many blocks."""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models.layers import chunked_xent as j_chunked_xent  # noqa: E402
from repro.models.model import forward_train as j_forward_train  # noqa: E402
from repro.models.moe import \
    aux_load_balance_loss as j_aux_loss  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import forward_train, from_jax_params  # noqa: E402
from repro_torch.models.layers import chunked_xent  # noqa: E402
from repro_torch.models.moe import aux_load_balance_loss  # noqa: E402

# Flash backward: max |d| / max |jax grad| (observed <= 6e-7).
FLASH_GRAD_REL = 1e-5


def _rel_err(port: np.ndarray, ref: np.ndarray) -> float:
    scale = float(np.abs(ref).max())
    return float(np.abs(port - ref).max()) / (scale if scale > 0 else 1.0)


# (id, B, Sq, Skv, Hq, Hkv, D, causal, window, softcap, q_offset, q_chunk,
#  kv_chunk); the chunk sizes cut Sq and Skv into several blocks each
FLASH_BWD_CASES = [
    ("gqa4_causal", 2, 32, 32, 8, 2, 16, True, None, None, 0, 8, 16),
    ("window", 1, 24, 24, 4, 4, 16, True, 6, None, 0, 8, 8),
    ("softcap", 1, 24, 24, 4, 2, 16, True, None, 20.0, 0, 24, 24),
    ("cross_noncausal", 2, 16, 40, 4, 2, 16, False, None, None, 0, 8, 8),
    ("q_offset", 1, 16, 40, 4, 1, 16, True, None, None, 24, 8, 8),
    ("chunks_all_masks", 2, 48, 48, 4, 2, 16, True, 20, 30.0, 0, 12, 16),
]


@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=lambda c: c[0])
def test_flash_backward_matches_jax_grad(case):
    _, B, Sq, Skv, Hq, Hkv, D, causal, window, cap, qoff, qc, kc = case
    rng = np.random.default_rng(len(case[0]))
    q, k, v, w = (rng.standard_normal(s).astype(np.float32) for s in
                  ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D),
                   (B, Sq, Hq, D)))
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=qoff,
              q_chunk=qc, kv_chunk=kc)
    j_loss, j_grads = jax.value_and_grad(
        lambda q, k, v: jnp.sum(j_attn.flash_attention(q, k, v, **kw) * w),
        argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    t_loss = (t_attn.flash_attention(tq, tk, tv, **kw)
              * torch.from_numpy(w)).sum()
    t_loss.backward()
    assert abs(t_loss.item() - float(j_loss)) <= 1e-5 * max(
        1.0, abs(float(j_loss)))
    for name, jg, tt in zip("qkv", j_grads, (tq, tk, tv)):
        err = _rel_err(tt.grad.numpy(), np.asarray(jg))
        assert err <= FLASH_GRAD_REL, f"d{name}: {err}"


def test_flash_without_grad_keeps_no_residuals():
    """Serving (no gradient wanted) calls the forward alone, once, without
    the log-sum-exp; a differentiable call asks for it."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((1, 8, 1, 16)).astype(np.float32))
    calls = []

    def spy(*a, **kw):
        calls.append(kw.get("return_lse", False))
        return flash_attention_ref(*a, **kw)

    with mock.patch.object(t_attn, "flash_attention_fwd", spy):
        out = t_attn.flash_attention(q, kv, kv)
        assert out.grad_fn is None
        with torch.no_grad():
            t_attn.flash_attention(q.requires_grad_(), kv, kv)
        t_attn.flash_attention(q, kv, kv)
    assert calls == [False, False, True]


# (Skv, Sq, causal, window, q_offset, softcap): the last has rows that see
# no key at all (positions past every key and its window)
LSE_CASES = [(40, 40, True, None, 0, None), (40, 16, False, None, 0, 30.0),
             (24, 24, True, 5, 0, None), (8, 12, True, 4, 20, None)]


@pytest.mark.parametrize("Skv,Sq,causal,window,qoff,cap", LSE_CASES)
def test_plain_lse_matches_reference_fwd_blocks(Skv, Sq, causal, window, qoff,
                                                cap):
    """The residual of the reference's custom_vjp forward (its
    ``fwd_blocks``), K/V repeated to the q heads as its wrapper does."""
    rng = np.random.default_rng(Skv + Sq)
    B, Hq, Hkv, D, QC, C = 2, 4, 2, 16, 4, 8
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
            for _ in range(2))
    core = j_attn._flash_core(causal, window, cap, C, QC, False)
    rep = lambda a: jnp.repeat(a, Hq // Hkv, axis=2)
    j_out, res = core.fwd(q, rep(k), rep(v), jnp.int32(qoff))
    out, lse = flash_attention_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        window=window, softcap=cap, q_offset=qoff, q_chunk=QC, kv_chunk=C,
        return_lse=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(res[4]), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=1e-6)
    if qoff:
        assert np.all(lse.numpy()[:, -1] == np.float32(np.log(1e-20)))


@pytest.mark.parametrize("S,tied", [(32, True), (12, False)])
def test_chunked_xent_matches_jax(S, tied):
    """With a logit softcap; S 12 takes 6 chunks (the count search)."""
    rng = np.random.default_rng(S)
    B, D, V, cap = 2, 16, 40, 30.0
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    emb = {"table": rng.standard_normal((V, D)).astype(np.float32)}
    if not tied:
        emb["head"] = rng.standard_normal((D, V)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    j_loss, (j_ge, j_gx) = jax.value_and_grad(
        lambda e, x: j_chunked_xent(e, x, jnp.asarray(labels), cap),
        argnums=(0, 1))(emb, x)
    te = {k: torch.tensor(a, requires_grad=True) for k, a in emb.items()}
    tx = torch.tensor(x, requires_grad=True)
    t_loss = chunked_xent(te, tx, torch.from_numpy(labels), cap)
    t_loss.backward()
    assert abs(t_loss.item() - float(j_loss)) <= 1e-6 * abs(float(j_loss))
    assert _rel_err(tx.grad.numpy(), np.asarray(j_gx)) <= 1e-5
    for k in emb:              # an untied table takes no part in the logits
        g = te[k].grad if te[k].grad is not None else torch.zeros_like(te[k])
        assert _rel_err(g.numpy(), np.asarray(j_ge[k])) <= 1e-5, k


def test_aux_load_balance_loss_matches_jax():
    cfg = reduce_for_smoke(get_config("olmoe-1b-7b"))
    tcfg = reduce_for_smoke(tconfigs.get_config("olmoe-1b-7b"))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    router = rng.standard_normal((cfg.d_model, cfg.moe.n_experts)).astype(
        np.float32)
    j_loss, (j_gr, j_gx) = jax.value_and_grad(
        lambda r, x: j_aux_loss({"router": r}, x, cfg), argnums=(0, 1))(
            router, x)
    tr, tx = (torch.tensor(a, requires_grad=True) for a in (router, x))
    t_loss = aux_load_balance_loss({"router": tr}, tx, tcfg)
    t_loss.backward()
    assert abs(t_loss.item() - float(j_loss)) <= 1e-6 * abs(float(j_loss))
    assert _rel_err(tr.grad.numpy(), np.asarray(j_gr)) <= 1e-5
    assert _rel_err(tx.grad.numpy(), np.asarray(j_gx)) <= 1e-5


# --------------------------------------------------------------- forward_train

def _port_leaves(tree, path=()):
    """{path: tensor} of a port tree (dicts and lists of blocks)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_port_leaves(v, path + (k,)))
    return out


def _with_gates(tree, value: float):
    """Every cross-attention ``gate`` leaf set to ``value`` (the reference
    draws 0, which would hide the cross path from every gradient)."""
    if isinstance(tree, dict):
        return {k: (np.full_like(v, value) if k == "gate" else
                    _with_gates(v, value)) for k, v in tree.items()}
    return tree


def _batch(cfg, B: int, S: int, seed: int):
    rng = np.random.default_rng(seed)
    toks, labels = (rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
                    for _ in range(2))
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long()}
    src = ("enc_x", 16) if cfg.is_encdec else (
        ("img_x", cfg.n_image_tokens) if cfg.n_image_tokens else None)
    if src is not None:
        e = rng.standard_normal((B, src[1], cfg.d_model)).astype(np.float32)
        jb[src[0]], tb[src[0]] = jnp.asarray(e), torch.from_numpy(e)
    return jb, tb


def _port_grads(tcfg, np_params, tb):
    tp = from_jax_params(tcfg, np_params, device="cpu")
    leaves = _port_leaves(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = forward_train(tcfg, tp, tb)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.item(), dict(zip(leaves, grads))


# Per-leaf max |d| / max |jax grad|: 1e-4, wider where the smoke model
# itself amplifies rounding. The reference's own jitted and eager
# gradients differ by 1.1e-4 (jamba) and 8.5e-4 (vision, whose backward
# amplifies ~10^3 into the embedding) of a leaf's largest value, the
# others by < 1e-5; seamless's decoder layer moves its own gradients by
# 5.7e-5 under a 1e-7 relative jitter of its input (the port, on the CPU).
GRAD_REL = {"jamba-1.5-large-398b": 5e-4, "seamless-m4t-medium": 5e-4,
            "llama-3.2-vision-90b": 5e-3}
TRAIN_ARCHS = ("llama3.2-1b", "olmoe-1b-7b", "jamba-1.5-large-398b",
               "rwkv6-3b", "seamless-m4t-medium", "llama-3.2-vision-90b")


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_forward_train_loss_and_grads_match_jax(arch):
    """Smoke config, B 2 x S 32 (a length both recurrent chunkings take);
    the cross archs over random sources with every gate at 0.5."""
    cfg = reduce_for_smoke(get_config(arch))
    tcfg = reduce_for_smoke(tconfigs.get_config(arch))
    jp = jax.tree.map(np.asarray, j_init_params(cfg, jax.random.key(0)))
    if cfg.is_encdec or cfg.n_image_tokens:
        jp = _with_gates(jp, 0.5)
    jb, tb = _batch(cfg, 2, 32, seed=7)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_forward_train(cfg, p, b)))(jp, jb)
    t_loss, t_grads = _port_grads(tcfg, jp, tb)
    assert abs(t_loss - float(j_loss)) <= 1e-6 * abs(float(j_loss))
    ref = _port_leaves(from_jax_params(
        tcfg, jax.tree.map(np.asarray, j_grads), device="cpu"))
    assert ref.keys() == t_grads.keys()
    tol = GRAD_REL.get(arch, 1e-4)
    bad = {k: e for k in ref
           if (e := _rel_err(t_grads[k].numpy(), ref[k].numpy())) > tol}
    assert not bad, bad
    if cfg.is_encdec or cfg.n_image_tokens:      # the cross path trained
        assert any(float(np.abs(ref[k].numpy()).max()) > 0 for k in ref
                   if "xattn" in k and k[-1] == "wq")


def test_remat_modes_give_one_gradient():
    """llama smoke, 2 blocks: none, full and dots give the same loss and
    gradients; full and dots run the flash forward twice a layer (the
    backward's recompute), none once."""
    base = dataclasses.replace(
        reduce_for_smoke(tconfigs.get_config("llama3.2-1b")), n_layers=2)
    cfg = reduce_for_smoke(get_config("llama3.2-1b"))
    jp = jax.tree.map(np.asarray, j_init_params(
        dataclasses.replace(cfg, n_layers=2), jax.random.key(1)))
    _, tb = _batch(base, 2, 16, seed=9)
    runs = {}
    for mode in ("none", "full", "dots"):
        calls = []

        def spy(*a, **kw):
            calls.append(1)
            return flash_attention_ref(*a, **kw)

        with mock.patch.object(t_attn, "flash_attention_fwd", spy):
            loss, grads = _port_grads(dataclasses.replace(base, remat=mode),
                                      jp, tb)
        runs[mode] = (loss, grads, len(calls))
    assert [runs[m][2] for m in ("none", "full", "dots")] == [2, 4, 4]
    loss0, g0, _ = runs["none"]
    for mode in ("full", "dots"):
        loss, g, _ = runs[mode]
        assert loss == loss0, mode
        for k in g0:
            torch.testing.assert_close(g[k], g0[k], rtol=1e-6, atol=1e-7,
                                       msg=lambda m, k=k: f"{mode} {k}: {m}")


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_train_step_leaves_no_tensor_in_a_cycle(remat):
    """Two train steps of smoke llama (one block) with the collector off:
    nothing they leave behind holds a tensor in a reference cycle, so a
    step's activations and gradients are freed when it returns, not when
    the garbage collector next runs (the memory a step at full width
    leaves resident)."""
    import gc
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import init_opt_state
    cfg = dataclasses.replace(
        reduce_for_smoke(tconfigs.get_config("llama3.2-1b")), n_layers=1,
        remat=remat)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = init_opt_state(params)
    step = make_train_step(cfg, TrainConfig(total_steps=4, warmup_steps=1))
    _, batch = _batch(cfg, 2, 16, seed=3)
    gc.collect()
    gc.disable()
    try:
        for _ in range(2):
            params, opt, metrics = step(params, opt, batch)
        del metrics
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        held = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert not held, [tuple(t.shape) for t in held]
