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
from repro_torch.kernels.gemm.ops import kernel_for, matmul  # noqa: E402
from repro_torch.kernels.gemm.ref import gemm_ref  # noqa: E402
from repro_torch.kernels.gesummv.ops import gesummv_op  # noqa: E402
from repro_torch.kernels.gesummv.ref import gesummv_ref  # noqa: E402
from repro_torch.kernels.heat3d.ops import heat3d  # noqa: E402
from repro_torch.kernels.heat3d.ops import _empty_at_phase  # noqa: E402
from repro_torch.kernels.heat3d.ops import kernel_for as heat3d_kernel_for  # noqa: E402
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


def _ints(seed, *shape):
    """Integers in [-4, 4] as float32: their products and sums up to K =
    4096 are exact in fp32 whatever the order, and exact in bf16."""
    return np.random.default_rng(seed).integers(-4, 5, shape).astype(np.float32)


# ---------------------------------------------------------------- gemm

@pytest.mark.parametrize("m,n,k,bm,bn,bk", [
    (128, 128, 128, 128, 128, 128),
    (256, 512, 384, 64, 128, 128),
    (64, 64, 256, 32, 32, 64),
    (256, 256, 512, 128, 128, 128),
    (200, 264, 136, 200, 264, 136),
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


@pytest.mark.parametrize("dtype,m,n,k,aligned,kind", [
    (torch.bfloat16, 128, 128, 128, True, "wgmma"),
    (torch.bfloat16, 200, 264, 136, True, "wgmma"),
    (torch.bfloat16, 130, 200, 70, True, "mma"),
    (torch.bfloat16, 64, 12, 64, True, "mma"),
    (torch.bfloat16, 64, 64, 128, False, "mma"),
    (torch.float32, 200, 264, 136, True, "simt"),
    (torch.float32, 64, 64, 128, False, "simt"),
    (torch.float16, 128, 128, 128, True, TypeError),
])
def test_gemm_kernel_for(dtype, m, n, k, aligned, kind):
    """The card's kernel is chosen by dtype, shape and alignment alone:
    wgmma needs 16-byte row strides (K and N multiples of 8) and 16-byte
    aligned bases for its TMA loads; other bf16 inputs go to mma."""
    if isinstance(kind, type):
        with pytest.raises(kind):
            kernel_for(dtype, m, n, k, aligned)
    else:
        assert kernel_for(dtype, m, n, k, aligned) == kind


# ---------------------------------------------------------------- axpy

@pytest.mark.parametrize("n,block", [(1024, 1024), (32768, 4096), (4096, 512)])
def test_axpy_matches_pallas(n, block):
    jx, tx = _pair(_normal(2, n), "float32")
    jy, ty = _pair(_normal(3, n), "float32")
    out = axpy_op(2.5, tx, ty)
    ref = pallas_axpy(jnp.float32(2.5), jx, jy, block=block)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-4, atol=1e-5)


# Lengths around the kernel's chunking: 8 bf16 to a 16-byte chunk, 4
# chunks a thread, 256 threads a block (8192 elements a block), and a tail
# of 5 past the last chunk at 100005 (whose Pallas block is 6667).
AXPY_EDGE_LENGTHS = (1, 7, 8, 4 * 8 * 256 - 1, 4 * 8 * 256 + 1, 100_005)


@pytest.mark.parametrize("n,a", [(4096, 0.1), (1000, 0.1), (4096, 2.5)]
                         + [(n, 0.1) for n in AXPY_EDGE_LENGTHS])
def test_axpy_bf16_bit_equal(n, a):
    """The Pallas kernel rounds a to bf16, then the product, then the sum;
    so does the port."""
    jx, tx = _pair(_normal(4, n), "bfloat16")
    jy, ty = _pair(_normal(5, n), "bfloat16")
    out = axpy(a, tx, ty)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (n,)
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

@pytest.mark.parametrize("shape", [(34, 34, 34), (18, 10, 12), (5, 7, 511),
                                   (9, 6, 13)])
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


@pytest.mark.parametrize("dtype,nx,aligned,kind", [
    (torch.float32, 512, True, "rows16"),
    (torch.float32, 520, True, "rows16"),
    (torch.float32, 511, True, "shifted"),
    (torch.float32, 510, True, "shifted"),
    (torch.float32, 512, False, "shifted"),
    (torch.bfloat16, 512, True, "rows16"),
    (torch.bfloat16, 8, True, "rows16"),
    (torch.bfloat16, 508, True, "shifted"),
    (torch.bfloat16, 511, True, "shifted"),
    (torch.bfloat16, 512, False, "shifted"),
    (torch.float16, 512, True, TypeError),
])
def test_heat3d_kernel_for(dtype, nx, aligned, kind):
    """The card's instantiation is chosen by dtype, row width and alignment
    alone: "rows16" needs rows of a multiple of 16 bytes at 16-byte-aligned
    bases; every other volume takes "shifted"."""
    if isinstance(kind, type):
        with pytest.raises(kind):
            heat3d_kernel_for(dtype, nx, aligned)
    else:
        assert heat3d_kernel_for(dtype, nx, aligned) == kind


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_heat3d_output_starts_at_input_phase(dtype):
    """The card's output starts at the input's offset within 16 bytes (so
    input and output share one grid of 16-byte words): a new contiguous
    tensor of u's shape and dtype, at every offset of a view into a flat
    buffer."""
    shape = (3, 4, 7)
    n = shape[0] * shape[1] * shape[2]
    flat = torch.zeros(n + 16, dtype=dtype)
    for offset in range(16 // flat.element_size()):
        u = flat[offset:offset + n].view(shape)
        out = _empty_at_phase(u)
        assert out.shape == u.shape and out.dtype == dtype
        assert out.is_contiguous()
        assert out.data_ptr() % 16 == u.data_ptr() % 16
        assert out.untyped_storage().data_ptr() != flat.untyped_storage().data_ptr()


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

# (m, k, n, inputs) of the card's gemm cases: ragged edges on every kernel;
# bf16 N = 12 and K = 70 rows are not 16-byte strides (mma), the rest run
# wgmma: M, N and K off the 128 x 256 x 64 tiles, 187 tiles over at most
# 132 CTAs (persistent, a partial raster group, one 8-column B slab at the
# N edge), and K = 4096 on exact integers.
GEMM_CARD_SHAPES = ((130, 70, 200, _normal), (64, 64, 12, _normal),
                    (200, 136, 264, _normal), (1400, 136, 4104, _normal),
                    (1024, 4096, 2048, _ints))


def _card_cases(dev):
    """(name, dtype, call of the kernel, call of the plain version, atol,
    rtol) at small shapes with ragged edges, fp32 and bf16. A gemm case is
    named after the kernel that takes it: "gemm:<kernel_for>"."""
    out = []
    for dtype, tdt in ((d, DTYPES[d][1]) for d in DTYPES):
        t = lambda seed, *s, f=_normal: torch.from_numpy(f(seed, *s)).to(dev, tdt)
        exact = dtype == "float32"
        for i, (m, k, n, f) in enumerate(GEMM_CARD_SHAPES):
            a, b = t(20 + 2 * i, m, k, f=f), t(21 + 2 * i, k, n, f=f)
            out.append((f"gemm:{kernel_for(tdt, m, n, k)}", dtype,
                        lambda a=a, b=b: gemm(a, b),
                        lambda a=a, b=b: gemm_ref(a, b),
                        1e-4, 1e-5 if exact else 2 ** -7))
        A, B, x = t(40, 77, 300), t(41, 77, 300), t(42, 300)
        out.append(("gesummv", dtype,
                    lambda A=A, B=B, x=x: gesummv(1.5, -0.5, A, B, x),
                    lambda A=A, B=B, x=x: gesummv_ref(1.5, -0.5, A, B, x),
                    1e-4, 1e-5 if exact else 2 ** -7))
        for j, n in enumerate((1003,) + AXPY_EDGE_LENGTHS):
            x, y = t(43 + 2 * j, n + 1), t(44 + 2 * j, n + 1)
            out.append(("axpy", dtype,
                        lambda x=x, y=y, n=n: axpy(0.1, x[:n], y[:n]),
                        lambda x=x, y=y, n=n: axpy_ref(0.1, x[:n], y[:n]), 0.0, 0.0))
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
        wgmma_before = gemm.wgmma_launches
        out = kern()
        ref = plain()
        torch.cuda.synchronize()
        key = name.split(":")[0].replace("_unaligned", "")
        assert launch_counts()[key] == before[key] + 1, name
        assert gemm.wgmma_launches == wgmma_before + (name == "gemm:wgmma"), name
        assert out.dtype == ref.dtype and out.shape == ref.shape, name
        err = (out.float() - ref.float()).abs()
        bound = atol + rtol * ref.float().abs()
        assert bool((err <= bound).all()), (name, dtype, err.max().item())


def test_gemm_misaligned_bf16_runs_mma_on_card(cuda):
    """A view 8 bytes into its storage has the wgmma kernel's shape but not
    its alignment: it goes to the mma kernel, chosen before the launch."""
    m, k, n = 64, 128, 64
    flat = torch.from_numpy(_normal(60, m * k + 4)).to(cuda, torch.bfloat16)
    a = flat[4:].view(m, k)
    b = torch.from_numpy(_normal(61, k, n)).to(cuda, torch.bfloat16)
    assert kernel_for(a.dtype, m, n, k) == "wgmma" and a.data_ptr() % 16
    assert kernel_for(a.dtype, m, n, k, aligned=False) == "mma"
    before, wgmma_before = gemm.launches, gemm.wgmma_launches
    out = gemm(a, b)
    torch.cuda.synchronize()
    assert (gemm.launches, gemm.wgmma_launches) == (before + 1, wgmma_before)
    torch.testing.assert_close(out, gemm_ref(a, b), atol=1e-4, rtol=2 ** -7)
    torch.testing.assert_close(gemm(a.clone(), b), gemm_ref(a, b), atol=1e-4,
                               rtol=2 ** -7)


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


@pytest.mark.parametrize("dtype,shape,offset,kind", [
    ("float32", (70, 37, 300), 0, "rows16"),
    ("float32", (70, 37, 301), 0, "shifted"),
    ("float32", (66, 35, 301), 1, "shifted"),
    ("float32", (66, 35, 300), 2, "shifted"),
    ("float32", (3, 3, 3), 0, "shifted"),
    ("bfloat16", (70, 37, 600), 0, "rows16"),
    ("bfloat16", (70, 37, 601), 0, "shifted"),
    ("bfloat16", (66, 35, 601), 1, "shifted"),
    ("bfloat16", (66, 35, 600), 3, "shifted"),
    ("bfloat16", (3, 4, 5), 1, "shifted"),
])
def test_heat3d_instantiations_on_card(cuda, dtype, shape, offset, kind):
    """Each instantiation over 5 steps: several blocks in x, y and z with
    ragged edges, rows off 16-byte strides and volumes that start
    ``offset`` elements into their buffer; bit-equal to the plain steps,
    boundary kept, input not written, one launch a step."""
    tdt = DTYPES[dtype][1]
    n = shape[0] * shape[1] * shape[2]
    flat = torch.from_numpy(_normal(29, n + offset)).to(cuda, tdt)
    u = flat[offset:].view(shape)
    assert heat3d_kernel_for(tdt, shape[2], u.data_ptr() % 16 == 0) == kind
    keep = flat.clone()
    before = heat3d_step.launches
    out = heat3d(u, steps=5)
    torch.cuda.synchronize()
    assert heat3d_step.launches == before + 5
    assert torch.equal(flat, keep)
    assert out.data_ptr() % 16 == u.data_ptr() % 16
    for face in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1],
                 np.s_[:, :, 0], np.s_[:, :, -1]):
        assert torch.equal(out[face], u[face])
    ref = u
    for _ in range(5):
        ref = heat3d_step_ref(ref)
    assert torch.equal(out, ref)
