"""Wrappers of the sort CUDA kernels (``csrc/mergesort.cu``).

``block_sort`` and ``mergesort`` take the plain versions for tensors on the
CPU and launch the kernels for tensors on a CUDA device; they never fall
back from one to the other. ``mergesort`` is the entry point of
``repro/kernels/mergesort/ops.py``; ``interpret`` and ``use_pallas`` are
TPU knobs and have no counterpart here. Both return a new tensor and never
write their input.

On the card the network of the plain versions runs as three kernels, with
the same pairs in the same order of levels and stages:

- ``block_sort`` (its ``.launches``): one CTA per tile of ``TILE``
  elements in shared memory runs levels 2..min(block, TILE);
- ``merge_stage``: one stage at a stride j >= TILE over the whole array;
  the first stage of a ladder level reads its upper half mirrored, which
  is the level's flip;
- ``merge_tile``: the stages j < TILE of one level, a tile per CTA.

Levels above the tile (of the block sort where block > TILE, and of the
ladder) are ``merge_stage`` launches down to j = TILE, then one
``merge_tile``. ``merge_stage`` and ``merge_tile`` work in place on the
sort's own output and count their launches too.
"""
from __future__ import annotations

import ctypes
from typing import Iterator, Tuple

import torch

from repro_torch.kernels.mergesort.ref import (block_sort_ref, mergesort_ref,
                                               stages)

TILE = 8192       # elements a CTA sorts in shared memory (kMaxTile in .cu)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_fns = {}


def _launch_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        from repro_torch.kernels.build import load
        fn = getattr(load("mergesort"), f"mergesort_{name}_launch")
        ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        fn.argtypes = {"block_sort": [p, p, i, ll, i, i, ll, p],
                       "merge_stage": [p, i, ll, ll, ll, ll, i, p],
                       "merge_tile": [p, i, ll, i, ll, ll, i, p]}[name]
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
    """The tile a CTA holds: TILE, or the largest power of two dividing n
    where that is smaller."""
    return min(TILE, n & -n)


def plan(n: int, block: int, tile: int, ladder: bool
         ) -> Iterator[Tuple]:
    """The kernel launches of the sort of n elements: ("block_sort", kmax),
    ("merge_stage", k, j, flip) and ("merge_tile", k, flip), in order.
    Without ``ladder``, the block sort alone."""
    if min(block, tile) >= 2:
        yield ("block_sort", min(block, tile))
    levels = [(k, False) for k in _pow2_range(2 * tile, block)]
    if ladder:
        levels += [(k, True) for k in _pow2_range(2 * block, n)]
    for k, flip in levels:
        j = k // 2
        while j >= tile:
            yield ("merge_stage", k, j, flip and j == k // 2)
            j //= 2
        yield ("merge_tile", k, flip and j == k // 2)


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
    """Levels 2..kmax of the block sort, each tile of ``tile`` elements of x
    sorted into out: the ``block_sort`` kernel."""
    if x.device.type == "cpu":
        for k in _pow2_range(2, kmax):
            x = stages(x, k, block, k // 2)
        out.copy_(x)
        return
    _raise_if(_launch_fn("block_sort")(
        x.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], x.numel(), tile,
        kmax, block, _stream(x)), "block_sort")
    block_sort.launches += 1


def merge_stage(x: torch.Tensor, *, k: int, j: int, block: int,
                flip: bool = False) -> None:
    """Stage j of level k of the network, over all of x, in place (see
    ``ref.stages``); with ``flip`` (j == k/2) the level's odd half-blocks
    are read reversed. On the card, one launch of the ``merge_stage``
    kernel."""
    if x.device.type == "cpu":
        x.copy_(stages(x, k, block, j, j, flip))
        return
    _raise_if(_launch_fn("merge_stage")(
        x.data_ptr(), _DTYPES[x.dtype], x.numel(), k, j, block, int(flip),
        _stream(x)), "merge_stage")
    merge_stage.launches += 1


def merge_tile(x: torch.Tensor, *, k: int, block: int, tile: int,
               flip: bool = False) -> None:
    """Stages j = min(k, tile)/2..1 of level k, in place, each tile of
    ``tile`` elements on its own; with ``flip`` (k <= tile) the level's odd
    half-blocks are read reversed. On the card, one launch of the
    ``merge_tile`` kernel."""
    if x.device.type == "cpu":
        x.copy_(stages(x, k, block, min(k, tile) // 2, 1, flip))
        return
    _raise_if(_launch_fn("merge_tile")(
        x.data_ptr(), _DTYPES[x.dtype], x.numel(), tile, k, block, int(flip),
        _stream(x)), "merge_tile")
    merge_tile.launches += 1


def network(x: torch.Tensor, block: int, tile: int, ladder: bool
            ) -> torch.Tensor:
    """The sort as the kernels run it, launch by launch (``plan``), into a
    new tensor. On the CPU each launch is its kernel's plain version, which
    holds the plan against ``block_sort_ref`` / ``mergesort_ref``."""
    steps = list(plan(x.numel(), block, tile, ladder))
    # the block sort writes all of out; without it the merges start from x
    out = (torch.empty_like(x) if steps and steps[0][0] == "block_sort"
           else x.clone())
    for step in steps:
        if step[0] == "block_sort":
            _sort_tiles(x, out, block, tile, step[1])
        elif step[0] == "merge_stage":
            _, k, j, flip = step
            merge_stage(out, k=k, j=j, block=block, flip=flip)
        else:
            _, k, flip = step
            merge_tile(out, k=k, block=block, tile=tile, flip=flip)
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
