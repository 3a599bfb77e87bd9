"""The port's sort (``block_sort``, ``mergesort``) against the JAX package.

Inputs are made with numpy from fixed seeds and handed to both packages. On
the CPU the wrappers run their plain PyTorch versions, held here bit for bit
(their bit patterns compared) against the Pallas ``block_sort`` in interpret
mode and the JAX ``mergesort``, as ``tests/test_kernels.py`` runs them:
signed zeros and NaN included. The launch plan of the CUDA kernels is held
against the plain versions on the CPU, launch by launch with each launch's
plain version. The kernels themselves are held against the plain versions
by the tests that take the ``cuda`` fixture (skipped without a card).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.mergesort.kernel import block_sort as pallas_block_sort  # noqa: E402
from repro.kernels.mergesort.ops import mergesort as jax_mergesort  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.mergesort.ops import (  # noqa: E402
    TILE, block_sort, launch_counts_of, mergesort, network)
from repro_torch.kernels.mergesort.ref import (  # noqa: E402
    block_sort_ref, compare_exchange, maximum, mergesort_ref, minimum)

DTYPES = {"float32": (jnp.float32, torch.float32, np.int32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, np.int16),
          "int32": (jnp.int32, torch.int32, np.int32)}
SIZES = [(1, 1), (2, 2), (8, 2), (64, 64), (1024, 64), (4096, 256),
         (65536, 1024), (16, 64)]           # the last: block > n
KINDS = ("normal", "ties", "special", "nan")
CASES = [(d, k) for d in DTYPES for k in KINDS
         if not (d == "int32" and k == "nan")]
I32 = np.iinfo(np.int32)


@functools.lru_cache(maxsize=None)
def _pallas_block_sort(block: int):
    """The Pallas block_sort in interpret mode under ``jax.jit``, as the
    JAX ``mergesort`` runs it: traced once per shape and dtype, not on
    every call."""
    return jax.jit(functools.partial(pallas_block_sort, block=block,
                                     interpret=True))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The sorts here run thousands of small torch ops: one intra-op thread
    keeps them from contending with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda")


def _values(kind: str, n: int, dtype: str, seed: int) -> np.ndarray:
    """normal: normals (x1000 and rounded for int32); ties: integers in
    0..36 (as test_kernels.py); special: normals with +-0.0 and +-inf
    (int32: 0, -1 and its extremes) in a quarter of the places; nan:
    normals with one NaN."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return rng.integers(0, 37, n).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    if dtype == "int32":
        x = np.rint(x * 1000)
    if kind == "special":
        pool = ([0, -1, I32.min, I32.max] if dtype == "int32" else
                [0.0, -0.0, np.inf, -np.inf])
        at = rng.random(n) < 0.25
        x[at] = rng.choice(np.array(pool, np.float64), int(at.sum()))
    if kind == "nan":
        x[rng.integers(n)] = np.nan
    return x


def _pair(vals: np.ndarray, dtype: str):
    """The same elements as a JAX array and a torch tensor."""
    jdt, tdt, ity = DTYPES[dtype]
    if dtype == "int32":
        arr = vals.astype(np.int64).clip(I32.min, I32.max).astype(np.int32)
        return jnp.asarray(arr), torch.from_numpy(arr)
    ja = jnp.asarray(vals).astype(jdt)
    bits = np.asarray(ja).view(ity).copy()
    return ja, torch.from_numpy(bits).view(tdt)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.view(torch.int32).numpy()
    a = np.asarray(x)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _assert_bit_equal(out, ref):
    a, b = _bits(out), _bits(ref)
    assert a.shape == b.shape
    bad = np.flatnonzero(a != b)
    assert bad.size == 0, (f"{bad.size} elements differ, first at {bad[0]}: "
                           f"{a[bad[0]]:#x} vs {b[bad[0]]:#x}")


@pytest.mark.parametrize("n,block", SIZES)
@pytest.mark.parametrize("dtype,kind", CASES)
def test_block_sort_bit_equal_to_pallas(n, block, dtype, kind):
    ja, tx = _pair(_values(kind, n, dtype, n + block), dtype)
    keep = tx.clone()
    out = block_sort(tx, block=block)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    _assert_bit_equal(out, _pallas_block_sort(block)(ja))
    _assert_bit_equal(tx, keep)                     # input not written


@pytest.mark.parametrize("n,block", SIZES)
@pytest.mark.parametrize("dtype,kind", CASES)
def test_mergesort_bit_equal_to_jax(n, block, dtype, kind):
    ja, tx = _pair(_values(kind, n, dtype, 7 * n + block), dtype)
    keep = tx.clone()
    out = mergesort(tx, block=block)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    _assert_bit_equal(out, jax_mergesort(ja, block=block, interpret=True))
    _assert_bit_equal(tx, keep)
    if kind != "nan":                   # as values, -0 == +0: torch.sort
        assert torch.equal(out, torch.sort(tx).values)


def test_compare_exchange_orders_signed_zeros_as_jnp():
    for dtype in ("float32", "bfloat16"):
        ja, ta = _pair(np.array([0.0, -0.0], np.float32), dtype)
        jb, tb = _pair(np.array([-0.0, 0.0], np.float32), dtype)
        lo, hi = compare_exchange(ta, tb)
        _assert_bit_equal(lo, _pair(np.array([-0.0, -0.0], np.float32),
                                    dtype)[1])
        _assert_bit_equal(hi, _pair(np.array([0.0, 0.0], np.float32),
                                    dtype)[1])
        _assert_bit_equal(lo, jnp.minimum(ja, jb))
        _assert_bit_equal(hi, jnp.maximum(ja, jb))
    # torch.minimum / torch.maximum lose the -0 here, which is why the
    # helper is written out on the bits
    assert not torch.signbit(torch.minimum(torch.tensor(0.0),
                                           torch.tensor(-0.0)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_minimum_maximum_bit_equal_to_jnp(dtype):
    """Every ordered pair of specials, NaNs of other signs and payloads
    among them: which NaN comes out is jnp's choice too. (Subnormals are
    left out: XLA's CPU code reads them as zero, the port does not; see
    ``test_subnormals_keep_their_bits``.)"""
    nans = np.array([0x7FC00000, 0xFFC00000, 0x7FC00001, 0xFFD00000],
                    np.uint32).view(np.float32)
    vals = np.concatenate([nans, np.array(
        [0.0, -0.0, np.inf, -np.inf, 1.0, -1.0, 2.5, -3e38], np.float32)])
    a = np.repeat(vals, vals.size)
    b = np.tile(vals, vals.size)
    (ja, ta), (jb, tb) = _pair(a, dtype), _pair(b, dtype)
    _assert_bit_equal(minimum(ta, tb), jnp.minimum(ja, jb))
    _assert_bit_equal(maximum(ta, tb), jnp.maximum(ja, jb))


def test_subnormals_keep_their_bits():
    """The one difference from the JAX sort that the port keeps: it sorts
    subnormals as values (JAX on the CPU returns them as +-0)."""
    tiny = np.array([1e-40, -1e-40, 0.0, -0.0, 1.0, -2e-39, 3e-41, -1.0],
                    np.float32)
    out = mergesort(torch.from_numpy(tiny), block=2)
    _assert_bit_equal(out, torch.from_numpy(np.array(
        [-1.0, -2e-39, -1e-40, -0.0, 0.0, 3e-41, 1e-40, 1.0], np.float32)))


def test_int32_keeps_its_dtype_and_extremes():
    vals = np.array([I32.max, 3, I32.min, -1, 0, 3, I32.min, 7], np.int64)
    ja, tx = _pair(vals.astype(np.float64), "int32")
    out = mergesort(tx, block=2)
    assert out.dtype == torch.int32
    assert out.tolist() == sorted(vals.tolist())
    _assert_bit_equal(out, jax_mergesort(ja, block=2, interpret=True))


def test_block_sort_takes_n_a_multiple_of_block():
    """Pallas block_sort asks only that block divide n."""
    for n, block in ((24, 8), (96, 32), (6, 2)):
        ja, tx = _pair(_values("special", n, "float32", n), "float32")
        _assert_bit_equal(block_sort(tx, block=block),
                          pallas_block_sort(ja, block=block, interpret=True))


@pytest.mark.parametrize("tile", [2, 4, 16, 64])
@pytest.mark.parametrize("n,block", [(2, 1), (64, 1), (256, 4), (256, 64),
                                     (512, 256), (1024, 1024)])
def test_launch_plan_matches_plain_on_cpu(n, block, tile):
    """The kernels' launches, each run as its plain version, give the plain
    sort bit for bit, at tiles below, at and above the block."""
    for dtype in ("float32", "bfloat16"):
        _, tx = _pair(_values("special", n, dtype, n + tile), dtype)
        tx[n // 3] = float("nan")
        tile_n = min(tile, n)
        _assert_bit_equal(network(tx, block, tile_n, ladder=False),
                          block_sort_ref(tx, block))
        _assert_bit_equal(network(tx, block, tile_n, ladder=True),
                          mergesort_ref(tx, block))


def test_launch_counts_of_the_main_path():
    # n = 2^26, blocks of 1024, tiles of 8192: one block sort; levels
    # 2^11..2^13 fit a tile; level 2^(13+m) has m global stages
    assert TILE == 8192
    assert launch_counts_of(1 << 26, 1024) == {
        "block_sort": 1, "merge_stage": sum(range(1, 14)), "merge_tile": 16}
    assert launch_counts_of(65536, 1024) == {
        "block_sort": 1, "merge_stage": 6, "merge_tile": 6}
    assert launch_counts_of(1 << 16, 1 << 15, ladder=False) == {
        "block_sort": 1, "merge_stage": 1 + 2, "merge_tile": 2}
    assert launch_counts_of(1, 1) == {
        "block_sort": 0, "merge_stage": 0, "merge_tile": 0}


def test_wrappers_reject_bad_inputs():
    v = torch.zeros(16)
    for fn in (block_sort, mergesort):
        with pytest.raises(ValueError):
            fn(v, block=3)                          # block not a power of two
        with pytest.raises(ValueError):
            fn(v, block=0)
        with pytest.raises(ValueError):
            fn(torch.zeros(4, 4))                   # 2-D
        with pytest.raises(ValueError):
            fn(torch.zeros(32)[::2])                # non-contiguous
        with pytest.raises(TypeError):
            fn(v.double())
        with pytest.raises(TypeError):
            fn(v.to(torch.int64))
        with pytest.raises(ValueError):
            fn(torch.zeros(12), block=16)           # min(block, n) = 12
    with pytest.raises(ValueError):
        mergesort(torch.zeros(24), block=8)         # n not a power of two
    with pytest.raises(ValueError):
        block_sort(torch.zeros(24), block=16)       # block does not divide n
    with pytest.raises(ValueError):
        mergesort(torch.zeros(0))


def test_cpu_path_launches_no_kernel():
    reset_launch_counts()
    _, tx = _pair(_values("normal", 4096, "float32", 3), "float32")
    block_sort(tx, block=64)
    mergesort(tx, block=64)
    network(tx, 64, 256, ladder=True)
    assert launch_counts() == dict.fromkeys(launch_counts(), 0)
    assert {"block_sort", "merge_stage", "merge_tile"} <= set(launch_counts())


# ---------------------------------------------------------------- on card

def _card_inputs(dev):
    """(label, tensor, block) on the card: every dtype with ties, +-0 and
    +-inf, a NaN, n = 1 and 2, blocks below, at and above the tile
    (2^15 >= 2^15), and the paper's size."""
    out = []
    for dtype in DTYPES:
        for n, block in ((1, 1), (2, 2), (8, 2), (4096, 64), (1 << 15, 1024),
                         (1 << 16, 1 << 13), (1 << 17, 1 << 15),
                         (1 << 16, 1024)):
            kinds = ("special", "ties") + (() if dtype == "int32" else ("nan",))
            for kind in kinds:
                _, tx = _pair(_values(kind, n, dtype, n ^ block), dtype)
                out.append((f"{dtype} {kind} n={n} block={block}",
                            tx.to(dev), block))
    return out


def test_mergesort_matches_plain_on_card(cuda):
    for label, x, block in _card_inputs(cuda):
        keep = x.clone()
        for fn, ref, ladder in ((mergesort, mergesort_ref, True),
                                (block_sort, block_sort_ref, False)):
            torch.cuda.synchronize()
            reset_launch_counts()
            out = fn(x, block=block)
            torch.cuda.synchronize()
            got = {k: v for k, v in launch_counts().items() if v}
            want = {k: v for k, v in launch_counts_of(
                x.numel(), block, ladder=ladder).items() if v}
            assert got == want, (label, fn.__name__, got, want)
            assert out.data_ptr() != x.data_ptr()
            _assert_bit_equal(out, ref(x, min(block, x.numel())))
        assert torch.equal(x.view(torch.uint8), keep.view(torch.uint8)), label


def test_block_sort_n_a_multiple_of_block_on_card(cuda):
    for n, block in ((24, 8), (3 * 8192, 8192), (5 * 16384, 16384)):
        _, tx = _pair(_values("special", n, "float32", n), "float32")
        tx = tx.to(cuda)
        _assert_bit_equal(block_sort(tx, block=block), block_sort_ref(tx, block))
