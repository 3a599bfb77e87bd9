"""Mesh construction (port of ``repro/launch/mesh.py``) over
``torch.distributed``: one process a rank, and a ``DeviceMesh`` over them.

Functions, not module-level constants: importing this module touches no
device and no process group. A rank first joins the process group
(``init_distributed``: its rank, the world size and the group's address,
which nothing on a machine hands a program), then builds the mesh; every
``make_*`` below needs the group joined and a world size equal to the
mesh's.

The backend follows the device the caller asks for, never a probe: NCCL
for CUDA ranks, gloo for CPU ranks. A caller may name another (gloo for
several ranks on one card, which NCCL refuses).

``mesh_context`` stands where the reference sets JAX's ambient mesh:
PyTorch has none, so it is a context that does nothing.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import MeshConfig


def init_distributed(rank: int, world_size: int, init_method: str,
                     device="cuda", backend: Optional[str] = None) -> None:
    """Join the default process group as ``rank`` of ``world_size`` at
    ``init_method`` (``tcp://localhost:<port>``), on ``device`` (a CUDA
    rank's device is made current first, so the communicator and the
    mesh use it), over ``backend``: by default NCCL for a CUDA device,
    gloo for the CPU."""
    import torch.distributed as dist
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but no CUDA device "
                               "is available; pass device='cpu'")
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend,
                            init_method=init_method, rank=rank,
                            world_size=world_size)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device="cuda"):
    """A ``DeviceMesh`` of ``shape`` with ``axes`` over the joined ranks, in
    rank order (the last axis fastest), of ``device``'s type."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("join the process group first (init_distributed)")
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                         f"the world has {dist.get_world_size()}")
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def mesh_context(mesh):
    """The reference's ``jax.set_mesh(mesh)``: no ambient mesh here."""
    return contextlib.nullcontext(mesh)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_mesh_from_config(mc: MeshConfig, device="cuda"):
    return make_mesh(mc.shape, mc.axes, device)


def make_host_mesh(data: Optional[int] = None, model: int = 1,
                   device="cuda"):
    """Small ``("data", "model")`` mesh over every joined rank (CPU tests,
    examples)."""
    import torch.distributed as dist
    n = dist.get_world_size()
    if data is None:
        data = n // model
    return make_mesh((data, model), ("data", "model"), device)


class _AbstractMesh:
    """What ``MeshInfo`` and ``Sharding`` read of a ``DeviceMesh``: the
    axes, their sizes and one rank's coordinate on each. No process group:
    a collective over it fails."""

    def __init__(self, shape, axes, coords):
        self.shape = tuple(shape)
        self.mesh_dim_names = tuple(axes)
        self._coords = dict(zip(axes, coords))

    def size(self, dim: int) -> int:
        return self.shape[dim]

    def get_local_rank(self, axis: str) -> int:
        return self._coords[axis]

    def get_group(self, axis: str):
        raise RuntimeError("an abstract mesh has no process groups")


def abstract_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
                  coords: Optional[Tuple[int, ...]] = None) -> _AbstractMesh:
    """A mesh of ``shape`` over ``axes`` that no process has joined, seen
    from the rank at ``coords`` (default the first): for placements and
    local shapes alone (``input_specs`` on the production meshes' 256 or
    512 ranks, the dry run), as the reference lowers on placeholder
    devices."""
    coords = tuple(coords) if coords is not None else (0,) * len(shape)
    if len(shape) != len(axes) or len(coords) != len(shape) or any(
            not 0 <= c < n for c, n in zip(coords, shape)):
        raise ValueError(f"shape {shape}, axes {axes} and coords {coords} "
                         f"do not match")
    return _AbstractMesh(shape, axes, coords)
