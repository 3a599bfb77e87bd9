"""Mesh information threaded through the model (port of
``repro/models/dist.py``) over a ``torch.distributed`` DeviceMesh.

``MeshInfo`` answers what the reference's does: whether a mesh is active,
its axis names and sizes, and the axes a batch and a token group shard
over. ``shard(x, mi, spec)`` is the reference's sharding constraint. Here
every rank holds whole, replicated tensors (the serving path's weights,
activations and host state are the same on every rank; only the
sequence-parallel decode's KV pages are a rank's own, held as a local
shard by ``models/model.py::init_cache``), and a sharding constraint never
changes a value, so ``shard`` returns ``x``. Sharding the parameters
(FSDP x TP) comes with the training side of the multi-device path.

``axis_group`` and ``axis_rank`` give the process group and this rank's
coordinate along one axis, for the collectives the model issues itself
(the sequence-parallel decode's merge over ``data``).

Nothing here touches a device or a process group when imported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Optional, Tuple

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
    tuple of logical axis names): every rank holds ``x`` whole, so it is
    ``x``, with a mesh or without."""
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
