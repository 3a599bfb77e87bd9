"""The port's kernel modules against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; that version is
held here against the JAX oracles (``kernels/*/ref.py``), the Pallas kernels
in interpret mode (as ``tests/test_kernels.py`` runs them) and the model
functions of ``repro/models/attention.py``, at fp32 atol 1e-5. The CUDA
kernels themselves are held against the plain versions by the tests marked
by the ``cuda`` fixture (skipped without a card) and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.kernels.paged_attention.kernel import \
    paged_attention_global as pallas_global  # noqa: E402
from repro.kernels.paged_attention.ref import \
    paged_attention_global_ref as jax_global_ref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import (flash_attention_fwd, launch_counts,  # noqa: E402
                                 paged_attention_global, reset_launch_counts)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention.ref import \
    paged_attention_global_ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

ATOL = 1e-5
B, HQ, HKV, TOTAL, P, PAGE, D = 5, 8, 2, 16, 4, 8, 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _paged_inputs(seed=0):
    """Shared pages (rows 0/1 map pages 0, 1), NULL entries past each
    length, a length-0 row, a full row, and an inactive all-NULL row of
    length 1 (what ``paged_append`` leaves in an empty decode slot)."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, HQ, D)).astype(np.float32)
    kp = r.standard_normal((TOTAL, PAGE, HKV, D)).astype(np.float32)
    vp = r.standard_normal((TOTAL, PAGE, HKV, D)).astype(np.float32)
    tbl = np.array([[0, 1, 2, TOTAL],
                    [0, 1, 5, TOTAL],
                    [TOTAL] * 4,
                    [7, 8, 9, 10],
                    [TOTAL] * 4], np.int32)
    lens = np.array([3 * PAGE - 5, 2 * PAGE + 3, 0, 4 * PAGE, 1], np.int32)
    return q, kp, vp, tbl, lens


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_paged_plain_matches_jax_oracle(softcap):
    q, kp, vp, tbl, lens = _paged_inputs()
    out = paged_attention_global(_t(q), _t(kp), _t(vp), _t(tbl), _t(lens),
                                 softcap=softcap).numpy()
    ref = np.asarray(jax_global_ref(*map(jnp.asarray, (q, kp, vp, tbl, lens)),
                                    softcap=softcap))
    live = [0, 1, 3, 4]            # the JAX oracle gives NaN at length 0
    np.testing.assert_allclose(out[live], ref[live], atol=ATOL)
    assert np.isnan(ref[2]).all() and (out[2] == 0).all()


@pytest.mark.parametrize("residency", ["smem", "hbm"])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_paged_plain_matches_pallas_interpret(residency, softcap):
    q, kp, vp, tbl, lens = _paged_inputs(1)
    out = paged_attention_global(_t(q), _t(kp), _t(vp), _t(tbl), _t(lens),
                                 softcap=softcap).numpy()
    pal = np.asarray(pallas_global(*map(jnp.asarray, (q, kp, vp, tbl, lens)),
                                   softcap=softcap, table_residency=residency,
                                   interpret=True))
    np.testing.assert_allclose(out[:4], pal[:4], atol=ATOL)
    # Row 4 (all NULL, length 1): the port reads a zero page; the Pallas
    # smem index map clamps NULL to page 0 and reads a live page's token.
    assert (out[4] == 0).all()
    if residency == "smem":
        assert not np.allclose(pal[4], 0)


def test_paged_decode_attention_matches_jax_model():
    q, kp, vp, tbl, lens = _paged_inputs(2)
    jkv = jattn.PagedKV(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
                        jnp.asarray(lens))
    tkv = tattn.PagedKV(_t(kp), _t(vp), _t(tbl), _t(lens))
    ref = np.asarray(jattn.paged_decode_attention(jnp.asarray(q)[:, None], jkv))
    out = tattn.paged_decode_attention(_t(q)[:, None], tkv).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_gather_and_append_match_jax_model():
    q, kp, vp, tbl, lens = _paged_inputs(3)
    lens = np.array([21, 19, 0, 31, 1], np.int32)
    r = np.random.default_rng(3)
    kn = r.standard_normal((B, 1, HKV, D)).astype(np.float32)
    vn = r.standard_normal((B, 1, HKV, D)).astype(np.float32)
    jkv = jattn.PagedKV(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
                        jnp.asarray(lens))
    tkv = tattn.PagedKV(_t(kp.copy()), _t(vp.copy()), _t(tbl), _t(lens))
    for a, b in zip(tattn.gather_global_pages(tkv),
                    jattn.gather_global_pages(jkv)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jn = jattn.paged_append(jkv, jnp.asarray(kn), jnp.asarray(vn))
    tn = tattn.paged_append(tkv, _t(kn), _t(vn))   # row 2: NULL, dropped
    np.testing.assert_array_equal(tn.k_pool.numpy(), np.asarray(jn.k_pool))
    np.testing.assert_array_equal(tn.v_pool.numpy(), np.asarray(jn.v_pool))
    np.testing.assert_array_equal(tn.length.numpy(), np.asarray(jn.length))


def test_prefix_context_attention_matches_jax_model():
    r = np.random.default_rng(4)
    _, kp, vp, tbl, _ = _paged_inputs(4)
    S = 6
    q = r.standard_normal((B, S, HQ, D)).astype(np.float32)
    ks = r.standard_normal((B, S, HKV, D)).astype(np.float32)
    vs = r.standard_normal((B, S, HKV, D)).astype(np.float32)
    pre = np.array([8, 16, 0, 24, 0], np.int32)
    suf = np.array([6, 3, 4, 6, 0], np.int32)
    jkv = jattn.PagedKV(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
                        jnp.asarray(pre))
    tkv = tattn.PagedKV(_t(kp), _t(vp), _t(tbl), _t(pre))
    ref = jattn.prefix_context_attention(
        *map(jnp.asarray, (q, ks, vs)), jkv, jnp.asarray(pre),
        jnp.asarray(suf), softcap=20.0)
    out = tattn.prefix_context_attention(_t(q), _t(ks), _t(vs), tkv, _t(pre),
                                         _t(suf), softcap=20.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


FLASH_CASES = [
    # B, Sq, Skv, Hq, Hkv, D, causal, window, softcap, q_offset, chunks
    (2, 16, 16, 4, 2, 16, True, None, None, 0, (8, 4)),
    (2, 16, 16, 4, 4, 16, False, None, None, 0, (16, 16)),
    (1, 24, 24, 6, 2, 8, True, None, 25.0, 0, (8, 12)),
    (2, 20, 20, 4, 1, 16, True, 5, None, 0, (10, 4)),
    (1, 12, 20, 4, 2, 16, True, 7, 15.0, 8, (4, 6)),
    (2, 8, 32, 2, 2, 16, False, None, None, 24, (16, 8)),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_jax_model(case):
    B_, Sq, Skv, Hq, Hkv, D_, causal, window, cap, qoff, (kvc, qc) = case
    r = np.random.default_rng(Sq + Skv)
    q = r.standard_normal((B_, Sq, Hq, D_)).astype(np.float32)
    k = r.standard_normal((B_, Skv, Hkv, D_)).astype(np.float32)
    v = r.standard_normal((B_, Skv, Hkv, D_)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=qoff)
    ref = jattn.flash_attention(*map(jnp.asarray, (q, k, v)), kv_chunk=kvc,
                                q_chunk=qc, **kw)
    out = flash_attention_fwd(_t(q), _t(k), _t(v), kv_chunk=kvc, q_chunk=qc,
                              **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("causal,softcap,gqa", [(True, None, 2),
                                                (False, None, 1),
                                                (True, 30.0, 4)])
def test_flash_plain_matches_dense_oracle(causal, softcap, gqa):
    r = np.random.default_rng(9)
    B_, S, Hkv, D_ = 2, 24, 2, 16
    q = r.standard_normal((B_, S, Hkv * gqa, D_)).astype(np.float32)
    k = r.standard_normal((B_, S, Hkv, D_)).astype(np.float32)
    v = r.standard_normal((B_, S, Hkv, D_)).astype(np.float32)
    kr, vr = np.repeat(k, gqa, axis=2), np.repeat(v, gqa, axis=2)
    ref = attention_ref(*(jnp.asarray(a).swapaxes(1, 2) for a in (q, kr, vr)),
                        causal=causal, softcap=softcap).swapaxes(1, 2)
    out = flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                              softcap=softcap, kv_chunk=8, q_chunk=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_wrappers_reject_bad_inputs():
    q, kp, vp, tbl, lens = map(_t, _paged_inputs())
    with pytest.raises(TypeError):
        paged_attention_global(q.double(), kp, vp, tbl, lens)
    with pytest.raises(TypeError):
        paged_attention_global(q, kp, vp, tbl.long(), lens)
    with pytest.raises(ValueError):
        paged_attention_global(q, kp, vp, tbl[:2], lens)
    with pytest.raises(ValueError):
        paged_attention_global(q, kp.transpose(1, 2), vp.transpose(1, 2),
                               tbl, lens)
    x = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError):
        flash_attention_fwd(x, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError):
        flash_attention_fwd(x.transpose(1, 2), x.transpose(1, 2),
                            x.transpose(1, 2))
    with pytest.raises(TypeError):
        flash_attention_fwd(x.half(), x.half(), x.half())


def test_cpu_path_launches_no_kernel():
    reset_launch_counts()
    q, kp, vp, tbl, lens = map(_t, _paged_inputs())
    paged_attention_global(q, kp, vp, tbl, lens)
    x = torch.zeros(1, 8, 4, 16)
    flash_attention_fwd(x, x, x)
    assert launch_counts() == {"paged_attention_global": 0,
                               "flash_attention_fwd": 0}


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_paged_kernel_matches_plain_on_card(cuda, dtype, tol):
    dt = getattr(torch, dtype)
    q, kp, vp, tbl, lens = (_t(a).to(cuda) for a in _paged_inputs(5))
    q, kp, vp = q.to(dt), kp.to(dt), vp.to(dt)
    before = paged_attention_global.launches
    out = paged_attention_global(q, kp, vp, tbl, lens, softcap=30.0)
    ref = paged_attention_global_ref(q, kp, vp, tbl, lens, softcap=30.0)
    torch.cuda.synchronize()
    assert paged_attention_global.launches == before + 1
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain_on_card(cuda, case):
    torch.backends.cuda.matmul.allow_tf32 = False
    B_, Sq, Skv, Hq, Hkv, D_, causal, window, cap, qoff, _ = case
    if D_ not in (16, 32, 64):
        pytest.skip(f"kernel head dims are 16/32/64, not {D_}")
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(B_, Sq, Hq, D_, generator=g, device=cuda)
    k = torch.randn(B_, Skv, Hkv, D_, generator=g, device=cuda)
    v = torch.randn(B_, Skv, Hkv, D_, generator=g, device=cuda)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=qoff)
    out = flash_attention_fwd(q, k, v, **kw)
    ref = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-4
