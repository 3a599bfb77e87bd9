"""Wrappers of the sort CUDA kernels (``csrc/mergesort.cu``).

``block_sort`` and ``mergesort`` take the plain versions for tensors on the
CPU and launch the kernels for tensors on a CUDA device; they never fall
back from one to the other. ``mergesort`` is the entry point of
``repro/kernels/mergesort/ops.py``; ``interpret`` and ``use_pallas`` are
TPU knobs and have no counterpart here. Both return a new tensor and never
write their input.

On the card the network of the plain versions runs as three kernels, with
the same pairs in the same order of levels and stages (``plan`` lists the
launches):

- ``block_sort`` (its ``.launches``): one CTA per tile (``tile_of``: TILE
  elements, or a small tile where TILE does not divide n) runs every level
  that fits a tile, 2..min(tile, block) for the block sort and, in a full
  sort, also the ladder's levels up to the tile;
- ``merge_stage``: one pass over the whole array that runs up to ``R``
  consecutive stages j_hi..j_lo >= tile of one level in registers; a
  ladder level's first pass also does the level's flip;
- ``merge_tile``: the stages j < tile of one level above the tile, a tile
  per CTA.

Each unit of work (a tile, a pass's thread) compares on unsigned keys
where its elements hold no NaN and exactly where they do, so the output is
the same bits either way. ``merge_stage`` and ``merge_tile`` work in place
on the sort's own output and count their launches too.
"""
from __future__ import annotations

import ctypes
from typing import Iterator, Tuple

import torch

from repro_torch.kernels.mergesort.ref import (block_sort_ref, mergesort_ref,
                                               stages)

TILE = 16384      # elements a CTA sorts (kMaxTile in .cu)
SMALL_TILE = 512  # the largest other tile (kSmallTile in .cu)
R = 4             # stages a merge_stage pass fuses (kMaxStages in .cu)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_fns = {}


def _launch_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        from repro_torch.kernels.build import load
        fn = getattr(load("mergesort"), f"mergesort_{name}_launch")
        ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        fn.argtypes = {"block_sort": [p, p, i, ll, i, i, ll, p],
                       "merge_stage": [p, i, ll, ll, ll, ll, ll, i, p],
                       "merge_tile": [p, i, ll, i, ll, ll, p]}[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _is_pow2(v: int) -> bool:
    return v >= 1 and v & (v - 1) == 0


def _check(x, block: int, *, pow2_n: bool) -> int:
    """Validate as the JAX functions assert, raising instead. Returns
    min(block, n)."""
    if not isinstance(x, torch.Tensor) or x.dim() != 1:
        raise ValueError(f"x must be a 1-D tensor; got "
                         f"{tuple(getattr(x, 'shape', ()))}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32, bfloat16 or int32; got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    n = x.numel()
    if isinstance(block, bool) or not isinstance(block, int) or block < 1:
        raise ValueError(f"block={block!r} must be a positive int")
    block = min(block, n)
    if pow2_n and not _is_pow2(n):
        raise ValueError(f"n={n} must be a power of two")
    if not _is_pow2(block) or n % block:
        raise ValueError(f"block={block} (min(block, n)) must be a power of "
                         f"two that divides n={n}")
    return block


def tile_of(n: int) -> int:
    """The tile a CTA holds: TILE where it divides n, else the largest
    power of two up to SMALL_TILE that does."""
    return TILE if n % TILE == 0 else min(SMALL_TILE, n & -n)


def plan(n: int, block: int, tile: int, ladder: bool, r: int = R
         ) -> Iterator[Tuple]:
    """The kernel launches of the sort of n elements, in order:
    ("block_sort", kmax) for the levels 2..kmax that fit a tile,
    ("merge_stage", k, j_hi, j_lo, flip) for up to ``r`` stages of level k
    at strides >= tile, and ("merge_tile", k) for the rest of level k.
    Levels above ``block`` are the ladder's, whose first stage is flipped.
    Without ``ladder``, the block sort alone."""
    top = n if ladder else block
    if min(tile, top) >= 2:
        yield ("block_sort", min(tile, top))
    for k in _pow2_range(2 * tile, top):
        j_hi, flip = k // 2, k > block
        while j_hi >= tile:
            j_lo = max(tile, j_hi >> (r - 1))
            yield ("merge_stage", k, j_hi, j_lo, flip)
            j_hi, flip = j_lo // 2, False
        yield ("merge_tile", k)


def _pow2_range(lo: int, hi: int) -> Iterator[int]:
    k = lo
    while k <= hi:
        yield k
        k *= 2


def launch_counts_of(n: int, block: int = 1024, *, ladder: bool = True
                     ) -> dict:
    """{kernel: launches} of one ``mergesort`` (or, without ``ladder``, one
    ``block_sort``) of n elements on the card."""
    block = min(block, n)
    counts = dict.fromkeys(("block_sort", "merge_stage", "merge_tile"), 0)
    for step in plan(n, block, tile_of(n), ladder):
        counts[step[0]] += 1
    return counts


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_if(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _sort_tiles(x, out, block: int, tile: int, kmax: int) -> None:
    """Levels 2..kmax of the network (kmax <= tile; the levels above
    ``block`` flipped), each tile of ``tile`` elements of x sorted into
    out: the ``block_sort`` kernel."""
    if x.device.type == "cpu":
        for k in _pow2_range(2, kmax):
            x = stages(x, k, block, k // 2, flip=k > block)
        out.copy_(x)
        return
    _raise_if(_launch_fn("block_sort")(
        x.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], x.numel(), tile,
        kmax, block, _stream(x)), "block_sort")
    block_sort.launches += 1


def merge_stage(x: torch.Tensor, *, k: int, j_hi: int, j_lo: int, block: int,
                flip: bool = False) -> None:
    """Stages j = j_hi, j_hi/2, .., j_lo of level k, over all of x, in
    place (see ``ref.stages``); with ``flip`` (j_hi == k/2) the level's odd
    half-blocks are read reversed first. On the card, one launch of the
    ``merge_stage`` kernel: one pass of at most 4 stages, j_lo at least two
    16-byte vectors, x 16-byte aligned."""
    if x.device.type == "cpu":
        x.copy_(stages(x, k, block, j_hi, j_lo, flip))
        return
    _raise_if(_launch_fn("merge_stage")(
        x.data_ptr(), _DTYPES[x.dtype], x.numel(), k, j_hi, j_lo, block,
        int(flip), _stream(x)), "merge_stage")
    merge_stage.launches += 1


def merge_tile(x: torch.Tensor, *, k: int, block: int, tile: int) -> None:
    """Stages j = tile/2..1 of level k > tile, in place, each tile of
    ``tile`` elements on its own. On the card, one launch of the
    ``merge_tile`` kernel."""
    if x.device.type == "cpu":
        x.copy_(stages(x, k, block, tile // 2, 1))
        return
    _raise_if(_launch_fn("merge_tile")(
        x.data_ptr(), _DTYPES[x.dtype], x.numel(), tile, k, block,
        _stream(x)), "merge_tile")
    merge_tile.launches += 1


def network(x: torch.Tensor, block: int, tile: int, ladder: bool,
            r: int = R) -> torch.Tensor:
    """The sort as the kernels run it, launch by launch (``plan``), into a
    new tensor. On the CPU each launch is its kernel's plain version, which
    holds the plan against ``block_sort_ref`` / ``mergesort_ref``."""
    steps = list(plan(x.numel(), block, tile, ladder, r))
    if x.device.type == "cuda" and x.data_ptr() % 16:
        x = x.clone()                   # the kernels read 16-byte vectors
    # the block sort writes all of out; without it the merges start from x
    out = (torch.empty_like(x) if steps and steps[0][0] == "block_sort"
           else x.clone())
    for step in steps:
        if step[0] == "block_sort":
            _sort_tiles(x, out, block, tile, step[1])
        elif step[0] == "merge_stage":
            _, k, j_hi, j_lo, flip = step
            merge_stage(out, k=k, j_hi=j_hi, j_lo=j_lo, block=block,
                        flip=flip)
        else:
            merge_tile(out, k=step[1], block=block, tile=tile)
    return out


def block_sort(x: torch.Tensor, *, block: int = 1024) -> torch.Tensor:
    """Sort each block of ``block`` elements of the (n,) tensor x ascending
    (``block`` is first min(block, n); n a multiple of it, a power of two),
    float32, bfloat16 or int32, as ``repro/kernels/mergesort/kernel.py::
    block_sort`` does: -0.0 before +0.0, and a NaN spreads through its
    block. Returns a new tensor. A block of one element is a copy, with no
    launch."""
    block = _check(x, block, pow2_n=False)
    if x.device.type == "cpu":
        return block_sort_ref(x, block)
    return network(x, block, tile_of(x.numel()), ladder=False)


block_sort.launches = 0
merge_stage.launches = 0
merge_tile.launches = 0


def mergesort(x: torch.Tensor, *, block: int = 1024) -> torch.Tensor:
    """Ascending sort of the (n,) tensor x, n a power of two, float32,
    bfloat16 or int32: the block sort, then the bitonic merge ladder, as
    ``repro/kernels/mergesort/ops.py::mergesort`` runs them (-0.0 before
    +0.0; a NaN spreads, see ``ref``). Returns a new tensor."""
    block = _check(x, block, pow2_n=True)
    if x.device.type == "cpu":
        return mergesort_ref(x, block)
    return network(x, block, tile_of(x.numel()), ladder=True)
