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
    R, SMALL_TILE, TILE, block_sort, launch_counts_of, mergesort, network,
    plan, tile_of)
from repro_torch.kernels.mergesort.ref import (  # noqa: E402
    block_sort_ref, compare_exchange, key_maximum, key_minimum, maximum,
    mergesort_ref, minimum)

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


@pytest.mark.parametrize("r", sorted({1, 2, 3, R}))
@pytest.mark.parametrize("tile", [2, 4, 16, 64])
@pytest.mark.parametrize("n,block", [(2, 1), (64, 1), (256, 4), (256, 64),
                                     (512, 256), (1024, 1024)])
def test_launch_plan_matches_plain_on_cpu(n, block, tile, r):
    """The kernels' launches, each run as its plain version, give the plain
    sort bit for bit, at tiles below, at and above the block, with passes
    of up to r fused stages."""
    for dtype in ("float32", "bfloat16"):
        _, tx = _pair(_values("special", n, dtype, n + tile), dtype)
        tx[n // 3] = float("nan")
        tile_n = min(tile, n)
        _assert_bit_equal(network(tx, block, tile_n, ladder=False, r=r),
                          block_sort_ref(tx, block))
        _assert_bit_equal(network(tx, block, tile_n, ladder=True, r=r),
                          mergesort_ref(tx, block))


@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_plan_fuses_each_levels_global_stages_into_passes(r):
    """Every stage at a stride >= tile runs in exactly one pass of at most
    r stages, the flip in a ladder level's first pass only."""
    n, block, tile = 1 << 26, 1024, TILE
    done = []
    for step in plan(n, block, tile, True, r):
        if step[0] != "merge_stage":
            continue
        _, k, j_hi, j_lo, flip = step
        assert tile <= j_lo <= j_hi < k and (j_hi // j_lo).bit_length() <= r
        assert flip == (j_hi == k // 2 and k > block)
        j = j_hi
        while j >= j_lo:
            done.append((k, j))
            j //= 2
    lt = TILE.bit_length() - 1
    want = [(1 << lk, 1 << lj) for lk in range(lt + 1, 27)
            for lj in range(lk - 1, lt - 1, -1)]
    assert done == want


def test_launch_counts_of_the_main_path():
    # n = 2^26, blocks of 1024, tiles of 16384, passes of 4 stages: one
    # block sort runs levels 2^1..2^14 (the ladder's 2^11..2^14 too);
    # level 2^(14+m) has m global stages in ceil(m/4) passes and a tile
    assert TILE == 16384 and R == 4
    assert launch_counts_of(1 << 26, 1024) == {
        "block_sort": 1, "merge_stage": sum(-(-m // 4) for m in range(1, 13)),
        "merge_tile": 12}
    assert launch_counts_of(1 << 26, 1024)["merge_stage"] == 24
    assert launch_counts_of(65536, 1024) == {
        "block_sort": 1, "merge_stage": 2, "merge_tile": 2}
    assert launch_counts_of(1 << 16, 1 << 15, ladder=False) == {
        "block_sort": 1, "merge_stage": 1, "merge_tile": 1}
    assert launch_counts_of(1 << 18, 1 << 18, ladder=False) == {
        "block_sort": 1, "merge_stage": 4, "merge_tile": 4}
    assert launch_counts_of(1, 1) == {
        "block_sort": 0, "merge_stage": 0, "merge_tile": 0}
    passes = {r: sum(s[0] == "merge_stage" for s in plan(
        1 << 26, 1024, TILE, True, r)) for r in (1, 2, 3, 4)}
    assert passes == {1: 78, 2: 42, 3: 30, 4: 24}


def test_tile_of_takes_the_full_tile_or_a_small_one():
    """The kernels take a tile of TILE or a power of two up to SMALL_TILE
    (the largest that divides n)."""
    assert SMALL_TILE == 512
    assert tile_of(1 << 26) == tile_of(65536) == tile_of(5 * TILE) == TILE
    assert tile_of(3 * 8192) == tile_of(8192) == SMALL_TILE
    assert tile_of(24) == 8 and tile_of(2) == 2 and tile_of(1) == 1


def _no_nan_specials(dtype: str) -> np.ndarray:
    """+-0, +-inf, the smallest and largest subnormals and normals, the
    largest finite value, +-1 and some normals, as the dtype's bits; for
    int32 its extremes and their neighbours, 0 and +-1."""
    if dtype == "int32":
        return np.array([I32.min, I32.min + 1, -1, 0, 1, I32.max - 1,
                         I32.max, 123456789, -987654321], np.int32)
    if dtype == "float32":
        bits = [0x0, 0x1, 0x7FFFFF, 0x800000, 0x7F7FFFFF, 0x7F800000,
                0x3F800000, 0x12345678, 0x4B000001]
        a = np.array(bits + [b | 0x80000000 for b in bits], np.uint32)
        return a.view(np.int32)
    bits = [0x0, 0x1, 0x7F, 0x80, 0x7F7F, 0x7F80, 0x3F80, 0x1234, 0x4B01]
    a = np.array(bits + [b | 0x8000 for b in bits], np.uint16)
    return a.view(np.int16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_key_compare_equals_exact_without_nan(dtype):
    """The kernels' fast compare (unsigned min/max of a key) against
    ``minimum`` / ``maximum`` bit for bit: every ordered pair of the
    specials, and for bf16 every non-NaN bit pattern against each special."""
    _, tdt, ity = DTYPES[dtype]
    sp = _no_nan_specials(dtype)
    a, b = np.repeat(sp, sp.size), np.tile(sp, sp.size)
    if dtype == "bfloat16":
        every = np.arange(-(1 << 15), 1 << 15).astype(np.int16)
        every = every[(every.view(np.uint16) & 0x7FFF) <= 0x7F80]
        a = np.concatenate([a, np.repeat(every, sp.size),
                            np.tile(sp, every.size)])
        b = np.concatenate([b, np.tile(sp, every.size),
                            np.repeat(every, sp.size)])
    ta = torch.from_numpy(a.astype(ity)).view(tdt)
    tb = torch.from_numpy(b.astype(ity)).view(tdt)
    if dtype != "int32":
        assert not (torch.isnan(ta).any() or torch.isnan(tb).any())
    _assert_bit_equal(key_minimum(ta, tb), minimum(ta, tb))
    _assert_bit_equal(key_maximum(ta, tb), maximum(ta, tb))


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
    +-inf, a NaN, n = 1 and 2, tiles below TILE, blocks below, at and above
    the tile (2^15 and 2^17 > 2^14), the paper's size; and n = 2^20 with a
    NaN in three of its 64 tiles, so that tiles and passes take both
    compares in one sort."""
    out = []
    for dtype in ("float32", "bfloat16"):
        n = 1 << 20
        _, tx = _pair(_values("special", n, dtype, n), dtype)
        tx[[5, 7 * TILE + 123, n - TILE // 2]] = float("nan")
        out.append((f"{dtype} nan in 3 tiles n={n}", tx.to(dev), 1024))
    for dtype in DTYPES:
        for n, block in ((1, 1), (2, 2), (8, 2), (4096, 64), (1 << 15, 1024),
                         (1 << 16, 1 << 13), (1 << 17, 1 << 15),
                         (1 << 18, 1 << 17),
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


def test_unaligned_input_on_card(cuda):
    """A view that does not start on a 16-byte boundary is sorted from an
    aligned copy: the kernels read 16-byte vectors."""
    _, tx = _pair(_values("special", 4097, "float32", 9), "float32")
    x = tx.to(cuda)[1:]
    assert x.data_ptr() % 16
    _assert_bit_equal(mergesort(x, block=64), mergesort_ref(x, 64))
    _assert_bit_equal(block_sort(x, block=64), block_sort_ref(x, 64))


def test_block_sort_n_a_multiple_of_block_on_card(cuda):
    for n, block in ((24, 8), (3 * 8192, 8192), (5 * 16384, 16384)):
        _, tx = _pair(_values("special", n, "float32", n), "float32")
        tx = tx.to(cuda)
        _assert_bit_equal(block_sort(tx, block=block), block_sort_ref(tx, block))
