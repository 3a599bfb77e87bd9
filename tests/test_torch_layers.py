"""Port layers against the JAX layers on the same numpy inputs (fp32,
atol 1e-5: the same arithmetic in a different framework)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

ATOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape,eps", [((2, 5, 64), 1e-5), ((3, 16), 1e-6)])
def test_rmsnorm(shape, eps):
    r = _rng()
    x = r.standard_normal(shape).astype(np.float32) * 3
    w = r.standard_normal(shape[-1:]).astype(np.float32)
    _close(tl.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), eps),
           jl.rmsnorm(jnp.asarray(x), jnp.asarray(w), eps))


@pytest.mark.parametrize("theta,per_row", [(10_000.0, False),
                                           (500_000.0, True)])
def test_rope(theta, per_row):
    r = _rng(1)
    B, S, H, D = 3, 7, 4, 16
    x = r.standard_normal((B, S, H, D)).astype(np.float32)
    if per_row:                       # decode / prefix-continuation positions
        pos = (np.arange(S)[None] + r.integers(0, 300, (B, 1))).astype(np.int32)
    else:
        pos = np.arange(S, dtype=np.int32)[None]
    _close(tl.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           jl.rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_glu_mlp(act):
    """silu, and gelu in the tanh approximation (``jax.nn.gelu``'s default,
    gemma2's MLP)."""
    r = _rng(2)
    d, ff = 32, 64
    p = {k: r.standard_normal(s).astype(np.float32) * 0.2
         for k, s in (("w_gate", (d, ff)), ("w_up", (d, ff)),
                      ("w_down", (ff, d)))}
    x = r.standard_normal((2, 5, d)).astype(np.float32)
    _close(tl.glu_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x), act),
           jl.glu_mlp({k: jnp.asarray(v) for k, v in p.items()},
                      jnp.asarray(x), act))


def test_embed():
    r = _rng(3)
    table = r.standard_normal((50, 16)).astype(np.float32)
    tok = r.integers(0, 50, (3, 9)).astype(np.int32)
    _close(tl.embed({"table": torch.from_numpy(table)},
                    torch.from_numpy(tok).long()),
           jl.embed({"table": jnp.asarray(table)}, jnp.asarray(tok)))


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_logits_fn_tied(softcap):
    r = _rng(4)
    table = r.standard_normal((50, 16)).astype(np.float32)
    x = r.standard_normal((3, 1, 16)).astype(np.float32) * 4
    _close(tl.logits_fn({"table": torch.from_numpy(table)},
                        torch.from_numpy(x), softcap),
           jl.logits_fn({"table": jnp.asarray(table)}, jnp.asarray(x),
                        softcap))


def test_qkv_and_out_proj():
    r = _rng(5)
    d, hq, hkv, dh = 32, 4, 2, 8
    p = {"wq": (d, hq, dh), "wk": (d, hkv, dh), "wv": (d, hkv, dh),
         "wo": (hq, dh, d), "bq": (hq, dh), "bk": (hkv, dh), "bv": (hkv, dh)}
    p = {k: r.standard_normal(s).astype(np.float32) * 0.3
         for k, s in p.items()}
    x = r.standard_normal((2, 5, d)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for a, b in zip(tattn.qkv_proj(tp, torch.from_numpy(x)),
                    jattn.qkv_proj(jp, jnp.asarray(x))):
        _close(a, b)
    o = r.standard_normal((2, 5, hq, dh)).astype(np.float32)
    _close(tattn.out_proj(tp, torch.from_numpy(o)),
           jattn.out_proj(jp, jnp.asarray(o)))
