"""Mesh information threaded through the model (port of
``repro/models/dist.py``) over a ``torch.distributed`` DeviceMesh, and the
collectives a rank's program issues itself.

``MeshInfo`` answers what the reference's does: whether a mesh is active,
its axis names and sizes, and the axes a batch and a token group shard
over. ``shard(x, mi, spec)`` is the reference's sharding constraint on an
activation. In the reference's one global program the constraint tells
the compiler how to lay out a whole array; here each rank runs its own
program on its own block of the activations already (a train step's
rows, a sequence-parallel decode's pages), and a constraint never
changes a value, so ``shard`` returns ``x``.

``axis_group`` and ``axis_rank`` give the process group and this rank's
coordinate along one axis. The collectives below are what the
reference's compiler inserts for FSDP x TP training, written out, each
a ``torch.autograd.Function`` where a gradient passes through it:

  gather_param(t, sh, mi, gather, summed)
      a parameter's block gathered over ``gather`` at use; its gradient
      reduce-scattered back over the gathered axes in ``summed`` (the
      ranks saw different rows), sliced over the others (the ranks
      computed the same gradient), all-reduced over the axes of
      ``summed`` the block is whole on (FSDP's gather and its backward)
  reduce_from(x, mi, axes)   all-reduce forward, identity backward
                             (Megatron's g: a row-parallel product's sum)
  copy_to(x, mi, axes)       identity forward, all-reduce backward
                             (Megatron's f: a column-parallel input)
  gather_from(x, dim, mi, axis)
                             all-gather forward, reduce-scatter backward
                             (a column-parallel product every rank reads
                             whole, each its own columns of it)
  shard_map(f, mi, in_specs, out_specs)
                             the reference's ``shard_map`` in a rank's
                             program: each input cut to the rank's
                             block, ``f``, each output gathered whole

The collectives are ``all_gather``, ``reduce_scatter`` (lists of blocks)
and ``all_reduce``: names that torch 2.11 and 2.13 both have, whose gloo
versions take CPU and CUDA tensors (gloo's reduce-scatter of CUDA
tensors checked on an H100 under torch 2.11: chip_smoke.py phase 8).

Nothing here touches a device or a process group when imported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable, Iterable, Optional, Tuple

import torch

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh


@dataclass(frozen=True)
class MeshInfo:
    mesh: Optional["DeviceMesh"] = None

    @property
    def active(self) -> bool:
        return self.mesh is not None

    @property
    def multi_pod(self) -> bool:
        return self.active and "pod" in self.mesh.mesh_dim_names

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names) if self.active else ()

    def size(self, axis: str) -> int:
        if not self.active:
            return 1
        if axis not in self.mesh.mesh_dim_names:
            raise KeyError(axis)       # as the reference's mesh.shape[axis]
        return self.mesh.size(self.mesh.mesh_dim_names.index(axis))

    @property
    def batch_axes(self):
        return ("pod", "data") if self.multi_pod else ("data",)

    @property
    def all_axes(self):
        return tuple(self.mesh.mesh_dim_names) if self.active else ()


NO_MESH = MeshInfo(None)


def shard(x, mi: MeshInfo, spec: Any):
    """The reference's ``with_sharding_constraint`` of ``x`` to ``spec`` (a
    tuple of logical axis names): ``x``, with a mesh or without. A rank's
    program holds its own block of an activation already (or the whole
    tensor, where every rank computes it), and a constraint never changes
    a value."""
    return x


def _need_mesh(mi: MeshInfo, axis: str) -> "DeviceMesh":
    if not mi.active:
        raise ValueError(f"axis {axis!r} needs a mesh; got NO_MESH")
    if axis not in mi.mesh.mesh_dim_names:
        raise KeyError(axis)
    return mi.mesh


def axis_group(mi: MeshInfo, axis: str):
    """The process group of this rank's ranks along ``axis``."""
    return _need_mesh(mi, axis).get_group(axis)


def axis_rank(mi: MeshInfo, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 .. size(axis) - 1)."""
    return _need_mesh(mi, axis).get_local_rank(axis)


# ---------------------------------------------------------------- collectives

def _dist():
    import torch.distributed as dist
    return dist


def _axes(mi: MeshInfo, axes) -> Tuple[str, ...]:
    """``axes`` (one name or several) without those of size 1."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in axes if mi.size(a) > 1)


def all_reduce(t: torch.Tensor, mi: MeshInfo, axes, op: str = "sum"
               ) -> torch.Tensor:
    """``t`` reduced (``op``: sum, max or min) over ``axes``, one axis
    after another, into a new tensor."""
    dist = _dist()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}[op]
    t = t.clone(memory_format=torch.contiguous_format)
    for a in _axes(mi, axes):
        dist.all_reduce(t, op=red, group=axis_group(mi, a))
    return t


def all_gather(t: torch.Tensor, dim: int, mi: MeshInfo, axis: str
               ) -> torch.Tensor:
    """The blocks of ``axis``'s ranks concatenated along ``dim``, in the
    axis's order."""
    n = mi.size(axis)
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    _dist().all_gather(parts, t, group=axis_group(mi, axis))
    return torch.cat(parts, dim)


def _block(t: torch.Tensor, dim: int, mi: MeshInfo, axis: str
           ) -> torch.Tensor:
    return t.chunk(mi.size(axis), dim)[axis_rank(mi, axis)].contiguous()


def reduce_scatter(t: torch.Tensor, dim: int, mi: MeshInfo, axis: str
                   ) -> torch.Tensor:
    """``t`` summed over ``axis``'s ranks, this rank's block along
    ``dim``."""
    n = mi.size(axis)
    if n == 1:
        return t
    chunks = [c.contiguous() for c in t.chunk(n, dim)]
    out = torch.empty_like(chunks[0])
    _dist().reduce_scatter(out, chunks, group=axis_group(mi, axis))
    return out


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mi, gathered, summed, whole):
        ctx.mi, ctx.gathered, ctx.summed, ctx.whole = (mi, gathered, summed,
                                                       whole)
        for dim, axis in gathered:
            t = all_gather(t, dim, mi, axis)
        return t

    @staticmethod
    def backward(ctx, g):
        mi = ctx.mi
        for dim, axis in reversed(ctx.gathered):
            g = (reduce_scatter(g, dim, mi, axis) if axis in ctx.summed
                 else _block(g, dim, mi, axis))
        if ctx.whole:
            g = all_reduce(g, mi, ctx.whole)
        return g, None, None, None, None


def gather_param(t: torch.Tensor, sh, mi: MeshInfo, gather: Iterable[str],
                 summed: Iterable[str]) -> torch.Tensor:
    """A parameter's block ``t`` (placed by the Sharding ``sh``) gathered
    whole over the axes of ``gather`` it is split on. Backward: the
    gradient summed over the axes of ``summed`` (the axes whose ranks
    computed on different data) and this rank's block taken again over
    the gathered axes. A block split over an axis of ``summed`` that is
    not gathered would need another block's sum, and raises."""
    gather, summed = set(_axes(mi, gather)), set(_axes(mi, summed))
    gathered = tuple((i, a) for i in range(t.dim()) for a in sh.axes(i)
                     if a in gather)
    if any(len(sh.axes(i)) > 1 for i, _ in gathered):
        raise NotImplementedError("a parameter dimension split over two "
                                  "axes is not gathered")
    split = set(sh.split)
    if (summed & split) - gather:
        raise ValueError(f"a block split over {sorted(summed & split)} "
                         f"must be gathered there to sum its gradient")
    whole = tuple(sorted(summed - split))
    if not gathered and not whole:
        return t
    return _GatherParam.apply(t, mi, gathered, summed, whole)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mi, axes):
        return all_reduce(x, mi, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mi, axes):
        ctx.mi, ctx.axes = mi, axes
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mi, ctx.axes), None, None


def reduce_from(x: torch.Tensor, mi: MeshInfo, axes) -> torch.Tensor:
    """Megatron's g: the sum of ``x`` over ``axes`` (a row-parallel
    product's partial sums, a loss's per-rank shares); the gradient passes
    unchanged."""
    axes = _axes(mi, axes)
    return _ReduceFrom.apply(x, mi, axes) if axes else x


def copy_to(x: torch.Tensor, mi: MeshInfo, axes) -> torch.Tensor:
    """Megatron's f: ``x`` unchanged; its gradient summed over ``axes``
    (an input every rank of ``axes`` uses for its own share of a
    product)."""
    axes = _axes(mi, axes)
    return _CopyTo.apply(x, mi, axes) if axes else x


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mi, axis):
        ctx.dim, ctx.mi, ctx.axis = dim, mi, axis
        return all_gather(x, dim, mi, axis)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.mi, ctx.axis), None, None, None


def gather_from(x: torch.Tensor, dim: int, mi: MeshInfo, axis: str
                ) -> torch.Tensor:
    """The blocks of ``x`` on ``axis``'s ranks concatenated along ``dim``
    (``dim`` counted from the front); each rank may read other columns of
    the result, so the gradient of its block is the sum of every rank's
    gradient there (a reduce-scatter)."""
    return _GatherFrom.apply(x, dim, mi, axis) if mi.size(axis) > 1 else x


def gather_whole(t: torch.Tensor, sh, mi: MeshInfo) -> torch.Tensor:
    """The whole leaf of which ``t`` is this rank's block, placed by the
    Sharding ``sh``: gathered over each dimension's axes, the innermost
    first."""
    for i in range(t.dim()):
        for a in reversed(sh.axes(i)):
            t = all_gather(t, i, mi, a)
    return t


def shard_map(f: Callable, mi: MeshInfo, in_specs, out_specs) -> Callable:
    """The reference's ``shard_map(f, mesh, in_specs, out_specs)`` in a
    rank's program: every rank calls the result with the whole inputs;
    each input is cut to the rank's block by its spec (one entry a
    dimension, each None, a mesh axis or a tuple of axes, as the
    reference's PartitionSpec), ``f`` runs on the blocks, and each output
    is gathered whole by its spec. One spec (a tuple) stands for every
    input or output; a list gives one spec each (the reference's tuple of
    PartitionSpecs)."""
    from repro_torch.models.params import placed

    def specs_for(specs, n):
        return specs if isinstance(specs, list) else [specs] * n

    def gather(t, spec):
        return gather_whole(t, placed(spec, mi), mi)

    def run(*args):
        ins = specs_for(in_specs, len(args))
        blocks = [placed(s, mi).cut(x).contiguous()
                  for x, s in zip(args, ins)]
        out = f(*blocks)
        if isinstance(out, tuple):
            return tuple(gather(o, s) for o, s in
                         zip(out, specs_for(out_specs, len(out))))
        return gather(out, out_specs)

    return run
