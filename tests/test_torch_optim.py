"""The port's optimizer, int8 error-feedback compression and train step
against the JAX package on the CPU: mirrors of ``tests/test_optim.py``;
``lr_schedule``, ``adamw_update`` and ``ef_compress`` on equal inputs; and
one ``make_train_step`` step of smoke llama3.2-1b (fp32) against the
reference's jitted step (plain, two microbatches, int8_ef) in new
parameters, every ``OptState`` field and the metrics."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models import NO_MESH  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.optim import adamw_update as j_adamw_update  # noqa: E402
from repro.optim import init_opt_state as j_init_opt_state  # noqa: E402
from repro.optim import lr_schedule as j_lr_schedule  # noqa: E402
from repro.optim.compression import ef_compress as j_ef_compress  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import from_jax_params  # noqa: E402
from repro_torch.optim import (adamw_update, clip_by_global_norm,  # noqa: E402
                               init_opt_state, lr_schedule)
from repro_torch.optim.compression import ef_compress, init_ef  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402


def _normal(seed: int, shape, scale: float = 1.0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32))


# ------------------------------------------------- tests/test_optim.py mirrors

def test_adamw_converges_on_quadratic():
    target = _normal(0, (16,))
    params = {"w": torch.zeros(16)}
    tc = TrainConfig(lr=0.05, weight_decay=0.0, warmup_steps=1,
                     total_steps=400)
    opt = init_opt_state(params)

    def loss_fn(p):
        return torch.sum((p["w"] - target) ** 2)

    for _ in range(300):
        w = params["w"].detach().requires_grad_(True)
        g, = torch.autograd.grad(loss_fn({"w": w}), [w])
        g, _ = clip_by_global_norm({"w": g}, 100.0)
        params, opt, _ = adamw_update(params, g, opt, tc)
    assert float(loss_fn(params)) < 1e-2


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 3.0), "b": torch.full((10,), 4.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - np.sqrt(250.0)) < 1e-4
    total = sum(float(torch.sum(x ** 2)) for x in leaves(clipped))
    assert abs(total - 1.0) < 1e-4


def test_lr_schedule_shape():
    tc = TrainConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(lr_schedule(tc, torch.tensor(s, dtype=torch.int32)))
           for s in range(0, 101, 10)]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 1e-3) < 1e-9          # end of warmup
    assert lrs[-1] < 1e-5                      # cosine decayed


def test_ef_compression_error_feedback_unbiased():
    """Over repeated identical gradients, the accumulated compressed sum
    approaches the true sum (error feedback kills the bias)."""
    g = {"w": _normal(1, (64,), 0.1)}
    ef = init_ef(g)
    acc = torch.zeros(64)
    n = 50
    for _ in range(n):
        cg, ef = ef_compress(g, ef)
        acc = acc + cg["w"]
    rel = float(torch.max(torch.abs(acc - n * g["w"]))) / float(
        torch.max(torch.abs(n * g["w"])))
    assert rel < 0.02, rel


def test_ef_compression_single_step_is_quantized():
    g = {"w": _normal(2, (64,))}
    cg, ef = ef_compress(g, init_ef(g))
    scale = float(torch.max(torch.abs(g["w"]))) / 127.0
    lev = cg["w"].numpy() / scale
    np.testing.assert_allclose(lev, np.round(lev), atol=1e-4)


# ------------------------------------------------- against the reference

def test_lr_schedule_matches_reference():
    """Every step of a schedule, in fp32: within one ulp, plus one ulp of
    the cosine times lr (XLA's and PyTorch's cos may round differently,
    and 1 + cos cancels near the end of the decay)."""
    tc = TrainConfig(lr=3e-4, warmup_steps=7, total_steps=60)
    jtc = JTrainConfig(lr=3e-4, warmup_steps=7, total_steps=60)
    steps = np.arange(0, 70, dtype=np.int32)
    ours = lr_schedule(tc, torch.from_numpy(steps)).numpy()
    ref = np.asarray(j_lr_schedule(jtc, jnp.asarray(steps)))
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=2 ** -23, atol=tc.lr * 2 ** -23)


def test_adamw_update_matches_reference():
    """Three updates of a tree with bf16 and fp32 leaves from equal
    gradients: master, mu, nu within 2 ulp (an FMA where XLA contracts),
    the bf16 parameters within one bf16 rounding of each other."""
    tc = TrainConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    jtc = JTrainConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    p0 = {"a": _normal(3, (8, 16)), "b": {"c": _normal(4, (5,))}}
    params = {"a": p0["a"].to(torch.bfloat16), "b": {"c": p0["b"]["c"]}}
    jparams = {"a": jnp.asarray(p0["a"].numpy()).astype(jnp.bfloat16),
               "b": {"c": jnp.asarray(p0["b"]["c"].numpy())}}
    opt, jopt = init_opt_state(params), j_init_opt_state(jparams)
    for s in range(3):
        g = {"a": _normal(10 + s, (8, 16), 0.1),
             "b": {"c": _normal(20 + s, (5,), 0.1)}}
        jg = jax.tree.map(lambda t: jnp.asarray(t.numpy()), g)
        params, opt, m = adamw_update(params, g, opt, tc)
        jparams, jopt, jm = j_adamw_update(jparams, jg, jopt, jtc)
        assert float(m["lr"]) == float(jm["lr"])
    assert int(opt.count) == int(jopt.count) == 3
    for field in ("master", "mu", "nu"):
        for ours, ref in zip(leaves(getattr(opt, field)),
                             jax.tree.leaves(getattr(jopt, field))):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                       rtol=2.5e-7, atol=1e-12)
    np.testing.assert_allclose(params["a"].float().numpy(),
                               np.asarray(jparams["a"]).astype(np.float32),
                               rtol=2 ** -8)
    assert params["a"].dtype == torch.bfloat16


def test_ef_compress_bit_equal_to_reference():
    """Five steps of feedback on equal inputs: the dequantized gradients
    and the buffers bit for bit (both round half to even)."""
    g = {"w": _normal(5, (33, 7)), "v": {"u": _normal(6, (100,), 1e-3)}}
    jg = jax.tree.map(lambda t: jnp.asarray(t.numpy()), g)
    ef, jef = init_ef(g), jax.tree.map(jnp.zeros_like, jg)
    for _ in range(5):
        cg, ef = ef_compress(g, ef)
        jcg, jef = j_ef_compress(jg, jef)
        for ours, ref in zip(leaves(cg) + leaves(ef),
                             jax.tree.leaves(jcg) + jax.tree.leaves(jef)):
            assert np.array_equal(ours.numpy().view(np.int32),
                                  np.asarray(ref).view(np.int32))


# One train step of the smoke model: the case's TrainConfig fields.
STEP_CASES = {"plain": {}, "microbatches2": {"microbatches": 2},
              "int8_ef": {"grad_compression": "int8_ef"}}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_reference(case):
    """Smoke llama3.2-1b (fp32), B 4 x S 16, lr 1e-3 from the first step
    (warmup 1). Limits: the loss and the gradient norm 1e-5 relative; mu
    within 1e-4 of its leaf's largest value and nu within 2e-4 (the
    gradients' own agreement, tests/test_torch_train.py); the master and
    the parameters within 1e-6 relative + 1e-4 lr (one fp32 rounding) on
    every entry whose gradient is clear of zero (above 1e-3 of its leaf's
    largest and, with int8_ef, above 1.5 quanta), which must be most of
    them; within 2 lr + 1e-6 on the rest, where the gradient lies within
    the two packages' rounding of zero and its AdamW step
    (g / (|g| + eps)) may take either sign. With int8_ef the
    error-feedback buffers within one quantum of their leaf (a near-tie of
    the rounding may flip)."""
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10, **STEP_CASES[case])
    tc, jtc = TrainConfig(**kw), JTrainConfig(**kw)
    cfg = reduce_for_smoke(get_config("llama3.2-1b"))
    tcfg = reduce_for_smoke(tconfigs.get_config("llama3.2-1b"))
    jp = j_init_params(cfg, jax.random.key(0))
    jopt = j_init_opt_state(jp, with_ef=tc.grad_compression == "int8_ef")
    rng = np.random.default_rng(11)
    toks, labels = (rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
                    for _ in range(2))
    jparams, jopt, jm = jax.jit(j_make_train_step(cfg, jtc, NO_MESH))(
        jp, jopt, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})

    params = from_jax_params(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    opt = init_opt_state(params, with_ef=tc.grad_compression == "int8_ef")
    params, opt, m = make_train_step(tcfg, tc)(
        params, opt, {"tokens": torch.from_numpy(toks).long(),
                      "labels": torch.from_numpy(labels).long()})

    # with int8_ef, a leaf's quantum q: its largest dequantized gradient is
    # 127 q, and mu = (1 - beta1) * that gradient after one step. A near-tie
    # may move one value of a leaf by q, the squared norm by up to 255 q^2.
    conv = lambda t: from_jax_params(tcfg, jax.tree.map(np.asarray, t),
                                     device="cpu")
    quanta = ([float(mu.abs().max()) / ((1 - tc.beta1) * 127)
               for mu in leaves(conv(jopt.mu))]
              if jopt.ef is not None else None)
    flips = (sum(255 * q * q for q in quanta) / (2 * float(jm["grad_norm"]))
             if quanta else 0.0)
    for k in ("loss", "grad_norm"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * abs(
            float(jm[k])) + (flips if k == "grad_norm" else 0.0), k
    assert float(m["lr"]) == float(jm["lr"])
    assert int(opt.count) == int(jopt.count) == 1
    pairs = {"params": (params, conv(jparams)),
             "master": (opt.master, conv(jopt.master)),
             "mu": (opt.mu, conv(jopt.mu)), "nu": (opt.nu, conv(jopt.nu))}
    if jopt.ef is not None:
        pairs["ef"] = (opt.ef, conv(jopt.ef))
    else:
        assert opt.ef is None
    ref_g = [np.abs(mu.numpy()) / (1 - tc.beta1)
             for mu in leaves(conv(jopt.mu))]
    clear = [g > max(1e-3 * g.max(), 1.5 * quanta[i] if quanta else 0.0)
             for i, g in enumerate(ref_g)]
    assert sum(c.sum() for c in clear) > 0.5 * sum(c.size for c in clear)
    for name, (ours, ref) in pairs.items():
        for i, (a, b) in enumerate(zip(leaves(ours), leaves(ref))):
            a, b = a.numpy(), b.numpy()
            if name in ("params", "master"):
                c = clear[i]
                assert np.all(np.abs(a - b)[c] <= 1e-6 * np.abs(b)[c]
                              + 1e-4 * kw["lr"]), (name, i, a.shape)
                a, b = a[~c], b[~c]
                if not a.size:
                    continue
            scale = float(np.abs(b).max())
            q = quanta[i] * 1.01 if quanta else 0.0
            tol = {"params": 2 * kw["lr"] + 1e-6,
                   "master": 2 * kw["lr"] + 1e-6,
                   "mu": 1e-4 * scale + (1 - tc.beta1) * q,
                   "nu": 2e-4 * scale + (1 - tc.beta2) * q * (254 * q + q),
                   "ef": q + 1e-4 * 127 * q}[name] + 1e-12
            assert float(np.abs(a - b).max()) <= tol, (name, i, a.shape)
