"""The port's paper kernels (gemm, gesummv, axpy, heat3d) against the JAX
package.

Inputs are made with numpy from a seed and handed to both packages. On the
CPU each wrapper runs its plain PyTorch version, held here against the
Pallas kernels in interpret mode (as ``tests/test_kernels.py`` runs them)
and the JAX references: gemm and gesummv at that file's tolerances, axpy in
bf16 and heat3d in fp32 and bf16 bit for bit. The Pallas heat3d does not
run under the installed JAX (no ``pl.Unblocked``), so heat3d is held
against ``heat3d_step_ref`` and the ``use_pallas=False`` path of its ops.
The CUDA kernels themselves are held against the plain versions by the
tests that take the ``cuda`` fixture (skipped without a card).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.axpy.kernel import axpy as pallas_axpy  # noqa: E402
from repro.kernels.axpy.ref import axpy_ref as jax_axpy_ref  # noqa: E402
from repro.kernels.gemm.kernel import gemm as pallas_gemm  # noqa: E402
from repro.kernels.gemm.ref import gemm_ref as jax_gemm_ref  # noqa: E402
from repro.kernels.gesummv.kernel import gesummv as pallas_gesummv  # noqa: E402
from repro.kernels.gesummv.ref import gesummv_ref as jax_gesummv_ref  # noqa: E402
from repro.kernels.heat3d.ops import heat3d as jax_heat3d  # noqa: E402
from repro.kernels.heat3d.ref import heat3d_step_ref as jax_heat3d_ref  # noqa: E402
from repro_torch.kernels import (axpy, gemm, gesummv, heat3d_step,  # noqa: E402
                                 launch_counts, reset_launch_counts)
from repro_torch.kernels.axpy.ops import axpy_op  # noqa: E402
from repro_torch.kernels.axpy.ref import axpy_ref  # noqa: E402
from repro_torch.kernels.gemm.ops import matmul  # noqa: E402
from repro_torch.kernels.gemm.ref import gemm_ref  # noqa: E402
from repro_torch.kernels.gesummv.ops import gesummv_op  # noqa: E402
from repro_torch.kernels.gesummv.ref import gesummv_ref  # noqa: E402
from repro_torch.kernels.heat3d.ops import heat3d  # noqa: E402
from repro_torch.kernels.heat3d.ref import heat3d_step_ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda")


def _pair(arr, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(arr).astype(jdt), torch.from_numpy(arr).to(tdt)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------- gemm

@pytest.mark.parametrize("m,n,k,bm,bn,bk", [
    (128, 128, 128, 128, 128, 128),
    (256, 512, 384, 64, 128, 128),
    (64, 64, 256, 32, 32, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_matches_jax(m, n, k, bm, bn, bk, dtype):
    ja, ta = _pair(_normal(0, m, k), dtype)
    jb, tb = _pair(_normal(1, k, n), dtype)
    out = matmul(ta, tb)
    assert out.dtype == ta.dtype and tuple(out.shape) == (m, n)
    tol = 2e-3 if dtype == "float32" else 1e-1
    for ref in (pallas_gemm(ja, jb, bm=bm, bn=bn, bk=bk), jax_gemm_ref(ja, jb)):
        np.testing.assert_allclose(_np(out), _np(ref), atol=tol * np.sqrt(k),
                                   rtol=tol)
    assert torch.equal(out, gemm_ref(ta, tb))


# ---------------------------------------------------------------- axpy

@pytest.mark.parametrize("n,block", [(1024, 1024), (32768, 4096), (4096, 512)])
def test_axpy_matches_pallas(n, block):
    jx, tx = _pair(_normal(2, n), "float32")
    jy, ty = _pair(_normal(3, n), "float32")
    out = axpy_op(2.5, tx, ty)
    ref = pallas_axpy(jnp.float32(2.5), jx, jy, block=block)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,a", [(4096, 0.1), (1000, 0.1), (4096, 2.5)])
def test_axpy_bf16_bit_equal(n, a):
    """The Pallas kernel rounds a to bf16, then the product, then the sum;
    so does the port."""
    jx, tx = _pair(_normal(4, n), "bfloat16")
    jy, ty = _pair(_normal(5, n), "bfloat16")
    out = axpy(a, tx, ty)
    assert out.dtype == torch.bfloat16
    for ref in (pallas_axpy(jnp.asarray(a), jx, jy), jax_axpy_ref(a, jx, jy)):
        np.testing.assert_array_equal(_np(out), _np(ref))


# ---------------------------------------------------------------- gesummv

@pytest.mark.parametrize("n,k,bm", [(512, 512, 128), (256, 384, 64)])
def test_gesummv_matches_jax(n, k, bm):
    ja, ta = _pair(_normal(6, n, k), "float32")
    jb, tb = _pair(_normal(7, n, k), "float32")
    jx, tx = _pair(_normal(8, k), "float32")
    out = gesummv_op(1.5, -0.5, ta, tb, tx)
    for ref in (pallas_gesummv(1.5, -0.5, ja, jb, jx, bm=bm),
                jax_gesummv_ref(1.5, -0.5, ja, jb, jx)):
        np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-4, atol=1e-4)


def test_gesummv_bf16_matches_jax_ref():
    """bf16 inputs, fp32 sums: the two sums differ only in order, so the
    results differ by at most one bf16 rounding of the output."""
    ja, ta = _pair(_normal(9, 256, 384), "bfloat16")
    jb, tb = _pair(_normal(10, 256, 384), "bfloat16")
    jx, tx = _pair(_normal(11, 384), "bfloat16")
    out = gesummv(1.5, -0.5, ta, tb, tx)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out),
                               _np(jax_gesummv_ref(1.5, -0.5, ja, jb, jx)),
                               rtol=2 ** -7, atol=1e-4)


# ---------------------------------------------------------------- heat3d

@pytest.mark.parametrize("shape", [(34, 34, 34), (18, 10, 12)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_heat3d_bit_equal_to_jax(shape, dtype):
    """Bit-equal to the JAX reference, one step and three. The jitted ops
    path is bit-equal in bf16; in fp32 XLA contracts ``c0 * center + c1 *
    neigh`` into one FMA, so it differs from its own eager reference, and
    from the port, by up to one fp32 rounding of a product per step (terms
    here stay under 4, whose rounding step is 2**-22)."""
    ju, tu = _pair(_normal(12, *shape), dtype)
    np.testing.assert_array_equal(_np(heat3d_step(tu)), _np(jax_heat3d_ref(ju)))
    out3 = heat3d(tu, steps=3)
    ref3 = ju
    for _ in range(3):
        ref3 = jax_heat3d_ref(ref3)
    np.testing.assert_array_equal(_np(out3), _np(ref3))
    jit3 = _np(jax_heat3d(ju, steps=3, use_pallas=False))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(out3), jit3)
    else:
        np.testing.assert_allclose(_np(out3), jit3, rtol=0, atol=3 * 2 ** -22)
    assert torch.equal(out3[0], tu[0]) and torch.equal(out3[:, :, -1], tu[:, :, -1])


def test_heat3d_small_volumes_and_zero_steps():
    u = torch.from_numpy(_normal(13, 2, 5, 5))
    assert torch.equal(heat3d_step(u), u)           # no interior
    out = heat3d(u, steps=0)
    assert torch.equal(out, u) and out.data_ptr() != u.data_ptr()
    v = torch.from_numpy(_normal(14, 6, 7, 8))
    assert torch.equal(heat3d_step(v, c0=0.5, c1=0.25),
                       heat3d_step_ref(v, c0=0.5, c1=0.25))


# ---------------------------------------------------------------- wrappers

def test_paper_wrappers_reject_bad_inputs():
    f = torch.zeros(8, 8)
    meta = torch.empty(8, 8, device="meta")
    with pytest.raises(TypeError):
        gemm(f, f.bfloat16())                       # mixed dtype
    with pytest.raises(ValueError):
        gemm(f, meta)                               # mixed device
    with pytest.raises(ValueError):
        gemm(f[0], f)                               # wrong rank
    with pytest.raises(ValueError):
        gemm(f.t(), f)                              # non-contiguous
    with pytest.raises(TypeError):
        gemm(f.half(), f.half())
    v = torch.zeros(8)
    with pytest.raises(TypeError):
        gesummv(1.0, 1.0, f, f, v.bfloat16())
    with pytest.raises(ValueError):
        gesummv(1.0, 1.0, f, meta, v)
    with pytest.raises(ValueError):
        gesummv(1.0, 1.0, f, f, f)
    with pytest.raises(ValueError):
        gesummv(1.0, 1.0, f.t(), f, v)
    with pytest.raises(TypeError):
        gesummv(torch.tensor(1.0), 1.0, f, f, v)
    with pytest.raises(TypeError):
        axpy(2.0, v, v.bfloat16())
    with pytest.raises(ValueError):
        axpy(2.0, v, torch.empty(8, device="meta"))
    with pytest.raises(ValueError):
        axpy(2.0, f, f)
    with pytest.raises(ValueError):
        axpy(2.0, torch.zeros(16)[::2], v)
    with pytest.raises(TypeError):
        axpy(torch.tensor(2.0), v, v)
    with pytest.raises(ValueError):
        heat3d_step(f)
    with pytest.raises(ValueError):
        heat3d_step(torch.zeros(4, 4, 4).transpose(0, 2))
    with pytest.raises(TypeError):
        heat3d_step(torch.zeros(4, 4, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        heat3d(torch.zeros(4, 4, 4), steps=-1)


def test_paper_cpu_path_launches_no_kernel():
    reset_launch_counts()
    f = torch.from_numpy(_normal(15, 16, 16))
    v = torch.from_numpy(_normal(16, 16))
    matmul(f, f)
    gesummv_op(1.0, 2.0, f, f, v)
    axpy_op(3.0, v, v)
    heat3d(torch.from_numpy(_normal(17, 5, 6, 7)), steps=2)
    assert launch_counts() == dict.fromkeys(launch_counts(), 0)
    assert set(launch_counts()) >= {"gemm", "gesummv", "axpy", "heat3d_step"}


# ---------------------------------------------------------------- on card

def _card_cases(dev):
    """(name, call of the kernel, call of the plain version, atol, rtol) at
    small shapes with ragged edges, fp32 and bf16."""
    out = []
    for dtype, tdt in ((d, DTYPES[d][1]) for d in DTYPES):
        t = lambda seed, *s: torch.from_numpy(_normal(seed, *s)).to(dev, tdt)
        exact = dtype == "float32"
        a, b = t(20, 130, 70), t(21, 70, 200)
        out.append(("gemm", dtype, lambda a=a, b=b: gemm(a, b),
                    lambda a=a, b=b: gemm_ref(a, b),
                    1e-4, 1e-5 if exact else 2 ** -7))
        A, B, x = t(22, 77, 300), t(23, 77, 300), t(24, 300)
        out.append(("gesummv", dtype,
                    lambda A=A, B=B, x=x: gesummv(1.5, -0.5, A, B, x),
                    lambda A=A, B=B, x=x: gesummv_ref(1.5, -0.5, A, B, x),
                    1e-4, 1e-5 if exact else 2 ** -7))
        x, y = t(25, 1003), t(26, 1003)
        out.append(("axpy", dtype, lambda x=x, y=y: axpy(0.1, x, y),
                    lambda x=x, y=y: axpy_ref(0.1, x, y), 0.0, 0.0))
        out.append(("axpy_unaligned", dtype,
                    lambda x=x, y=y: axpy(0.1, x[1:], y[1:]),
                    lambda x=x, y=y: axpy_ref(0.1, x[1:], y[1:]), 0.0, 0.0))
        u = t(27, 37, 19, 45)
        out.append(("heat3d_step", dtype, lambda u=u: heat3d_step(u),
                    lambda u=u: heat3d_step_ref(u), 0.0, 0.0))
    return out


def test_paper_kernels_match_plain_on_card(cuda):
    for name, dtype, kern, plain, atol, rtol in _card_cases(cuda):
        before = dict(launch_counts())
        out = kern()
        ref = plain()
        torch.cuda.synchronize()
        key = name.replace("_unaligned", "")
        assert launch_counts()[key] == before[key] + 1, name
        assert out.dtype == ref.dtype and out.shape == ref.shape, name
        err = (out.float() - ref.float()).abs()
        bound = atol + rtol * ref.float().abs()
        assert bool((err <= bound).all()), (name, dtype, err.max().item())


def test_heat3d_keeps_boundary_and_input_on_card(cuda):
    for tdt in (torch.float32, torch.bfloat16):
        u = torch.from_numpy(_normal(28, 20, 33, 40)).to(cuda, tdt)
        keep = u.clone()
        before = heat3d_step.launches
        out = heat3d(u, steps=5)
        torch.cuda.synchronize()
        assert heat3d_step.launches == before + 5
        assert out.data_ptr() != u.data_ptr() and torch.equal(u, keep)
        for face in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1],
                     np.s_[:, :, 0], np.s_[:, :, -1]):
            assert torch.equal(out[face], u[face])
        ref = u
        for _ in range(5):
            ref = heat3d_step_ref(ref)
        assert torch.equal(out, ref)
