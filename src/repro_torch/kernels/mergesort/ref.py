"""Plain PyTorch versions of the sort kernels.

``block_sort_ref`` and ``mergesort_ref`` run the network of
``repro/kernels/mergesort/kernel.py::_bitonic_block`` and of
``repro/kernels/mergesort/ops.py::mergesort`` step by step: the same pairs,
in the same order of levels and stages. They are the plain versions the
kernels are held against, bit for bit.

Every compare-exchange goes through ``minimum`` and ``maximum``, which keep
the semantics of ``jnp.minimum`` / ``jnp.maximum`` as XLA computes them on
an x86 CPU (LLVM's ``minimum``/``maximum`` lowering):

- a NaN in either input gives a NaN, its bits kept. Where both are NaN, the
  one that comes out is the "first" operand: for ``minimum`` that is ``b``
  if ``a``'s sign bit is set, else ``a``; for ``maximum`` the other way
  round. With one NaN bit pattern in the data that choice never shows;
- -0.0 sorts before +0.0, in both argument orders;
- integers compare as integers.

``torch.minimum`` / ``torch.maximum`` return their first argument for
(+0, -0) and so lose the -0; the comparisons here are written out on the
float's bits instead. So the sort differs from ``torch.sort`` as the JAX
one differs from ``jnp.sort``: -0 before +0, and a NaN spreads through the
network instead of sorting to the end.

One difference from the JAX function is kept: XLA's CPU code treats a
subnormal input of ``jnp.minimum`` / ``jnp.maximum`` as zero and returns
+-0 for it, so the JAX sort of an array with subnormals is not a
permutation of it. The port compares subnormals as the values they are and
keeps their bits.

``sort_ref`` is ``torch.sort``, the counterpart of
``repro/kernels/mergesort/ref.py::sort_ref``: the library yardstick, not a
plain version of the kernels.
"""
from __future__ import annotations

from typing import Tuple

import torch

# dtype -> (integer dtype of its bits, mask of the magnitude bits, the bits
# of +inf). The magnitude mask is None for a type that has no NaN.
_BITS = {torch.float32: (torch.int32, 0x7FFFFFFF, 0x7F800000),
         torch.bfloat16: (torch.int16, 0x7FFF, 0x7F80),
         torch.int32: (torch.int32, None, None)}


def _isnan_and_key(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(NaN mask or None, signed integer key) of x. For floats the key is
    the sign-magnitude bits turned two's complement, so that it orders
    every non-NaN value as the value does and -0.0 just below +0.0."""
    ity, mag, inf = _BITS[x.dtype]
    if mag is None:
        return None, x
    s = x.view(ity)
    return (s & mag) > inf, torch.where(s < 0, s ^ mag, s)


def _pick(a: torch.Tensor, b: torch.Tensor, want_min: bool) -> torch.Tensor:
    """``minimum(a, b)`` or ``maximum(a, b)``: the first operand if it is
    NaN, else the second if that is, else the smaller (larger) by key. The
    first operand is ``a`` unless ``a``'s sign bit is set (minimum) or
    clear (maximum)."""
    na, ka = _isnan_and_key(a)
    nb, kb = _isnan_and_key(b)
    take_b = (kb < ka) if want_min else (kb >= ka)
    if na is None:
        return torch.where(take_b, b, a)
    b_first = (a.view(_BITS[a.dtype][0]) < 0) == want_min
    n_first = torch.where(b_first, nb, na)
    n_second = torch.where(b_first, na, nb)
    take_b = torch.where(n_first, b_first,
                         torch.where(n_second, ~b_first, take_b))
    return torch.where(take_b, b, a)


def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.minimum(a, b)``, bit for bit (subnormals aside)."""
    return _pick(a, b, True)


def maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(a, b)``, bit for bit (subnormals aside)."""
    return _pick(a, b, False)


def to_key(x: torch.Tensor) -> torch.Tensor:
    """The unsigned key the kernels compare where a unit of work holds no
    NaN, as int64: the float's bits with the sign bit set where it was
    clear and all bits flipped where it was set (-0.0 just below +0.0);
    an int32's bits with the sign bit flipped. A bijection on the bits."""
    ity, mag, _ = _BITS[x.dtype]
    width = 8 * x.element_size()
    u = x.view(ity).to(torch.int64) & ((1 << width) - 1)
    top = 1 << (width - 1)
    if mag is None:
        return u ^ top
    return torch.where(u & top != 0, u ^ ((1 << width) - 1), u | top)


def from_key(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of ``to_key``."""
    ity, mag, _ = _BITS[dtype]
    width = 8 * torch.empty((), dtype=dtype).element_size()
    top = 1 << (width - 1)
    u = (k ^ top if mag is None else
         torch.where(k & top != 0, k ^ top, k ^ ((1 << width) - 1)))
    u = torch.where(u >= top, u - (1 << width), u)
    return u.to(ity).view(dtype)


def key_minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernels' fast compare: the smaller key. Equal to ``minimum``
    bit for bit where neither input is NaN."""
    return from_key(torch.minimum(to_key(a), to_key(b)), a.dtype)


def key_maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The larger key; equal to ``maximum`` where neither input is NaN."""
    return from_key(torch.maximum(to_key(a), to_key(b)), a.dtype)


def compare_exchange(a: torch.Tensor, b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(minimum(a, b), maximum(a, b)), elementwise."""
    return minimum(a, b), maximum(a, b)


def _xor_stage(x: torch.Tensor, idx: torch.Tensor, j: int,
               up: torch.Tensor) -> torch.Tensor:
    """One compare-exchange stage at stride j (``kernel.py:27-37``):
    element i meets element i ^ j and keeps the min where ``up`` says
    ascending and i is the lower of the two (or descending and i the
    upper), else the max."""
    partner = idx ^ j
    lo, hi = compare_exchange(x, x[partner])
    keep_min = up == (idx < partner)
    return torch.where(keep_min, lo, hi)


def flip_odd_halves(x: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse the second half of every k-block (``ops.py:43-48``)."""
    xb = x.view(-1, 2, k // 2)
    return torch.cat([xb[:, :1], xb[:, 1:].flip(-1)], dim=1).reshape(-1)


def stages(x: torch.Tensor, k: int, block: int, j_hi: int, j_lo: int = 1,
           flip: bool = False) -> torch.Tensor:
    """Stages j = j_hi, j_hi/2, .., j_lo of level k of the network, on the
    whole of x; with ``flip``, the level's odd half-blocks are reversed
    first. Element i sorts ascending where ``(i % block) & k`` is 0: the
    alternating directions of ``_bitonic_block`` for k <= block, where i is
    the index inside the block, and all ascending above it, as the ladder
    of ``mergesort`` is."""
    if flip:
        x = flip_odd_halves(x, k)
    idx = torch.arange(x.numel(), device=x.device)
    up = (idx & (block - 1) & k) == 0
    j = j_hi
    while j >= j_lo:
        x = _xor_stage(x, idx, j, up)
        j //= 2
    return x


def block_sort_ref(x: torch.Tensor, block: int) -> torch.Tensor:
    """x: (n,), n a multiple of ``block``, a power of two. Each block sorted
    ascending by the network of ``_bitonic_block`` (``kernel.py:21-39``):
    levels k = 2..block, stages j = k/2..1. Returns a new tensor."""
    x = x.clone()
    k = 2
    while k <= block:
        x = stages(x, k, block, k // 2)
        k *= 2
    return x


def mergesort_ref(x: torch.Tensor, block: int) -> torch.Tensor:
    """x: (n,), n a power of two; ``block`` already min(block, n). The
    block sort, then the ladder of ``mergesort`` (``ops.py:38-54``): at
    each level k = 2*block..n, flip the odd half-blocks, then the
    all-ascending ``_global_stage`` (``ops.py:16-25``) from j = k/2 down
    to 1. Returns a new tensor."""
    x = block_sort_ref(x, block)
    k = 2 * block
    while k <= x.numel():
        x = stages(x, k, block, k // 2, flip=True)
        k *= 2
    return x


def sort_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x).values
