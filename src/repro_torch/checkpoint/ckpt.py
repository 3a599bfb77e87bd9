"""Atomic, optionally asynchronous checkpoints with elastic restore (port
of ``repro/checkpoint/ckpt.py``, one host).

Layout per step, the reference's:  <dir>/step_<n>.tmp/ -> atomic rename ->
<dir>/step_<n>/
  manifest.json    step, leaf count, tree structure, shapes, dtypes
  leaf_<i>.npy     one file per leaf, in ``jax.tree.flatten``'s order
                   (``repro_torch.tree``)

numpy has no bfloat16 of its own. The reference's ``np.save`` of a bf16
leaf writes its raw 16-bit words (a 2-byte void dtype) and names
``bfloat16`` in the manifest; this module writes bf16 leaves the same way
and, where the manifest says ``bfloat16``, reads the words back as
``torch.bfloat16`` with no numeric conversion. So a checkpoint of a tree
the two packages share (the same dicts, lists and NamedTuples) restores
bit for bit in either.

On a mesh (``shardings=``, a tree of ``models.params.Sharding`` beside
the state, and ``mi``) every rank holds its blocks: ``save`` gathers each
leaf whole in turn, copies it to the host and, on rank 0 alone, writes
the same layout (one file a whole leaf); then every rank waits at a
barrier for the commit. ``restore(..., shardings=)`` reads each leaf's
file mapped and copies out only this rank's block, so a job saved on one
mesh shape resumes on another, or on one device (no shardings).
"""
from __future__ import annotations

import json
import pathlib
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.dist import NO_MESH, MeshInfo, gather_whole
from repro_torch.tree import flatten, leaves, unflatten

_BF16_WORDS = np.dtype("V2")


def _to_host(t: torch.Tensor) -> np.ndarray:
    # Always a copy: for a tensor already on the CPU, ``.cpu().numpy()``
    # would share its memory, and the next step's in-place update (AdamW's
    # master and moments) could reach an asynchronous write in flight.
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_WORDS)
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return "bfloat16" if t.dtype == torch.bfloat16 else str(
        np.dtype(str(t.dtype).removeprefix("torch.")))


class MeshSave:
    """A save on a mesh: ``result()`` waits for rank 0's write (where it
    runs in an executor), then for every rank at a barrier, so no rank
    reads the directory before the commit. Every rank calls it."""

    def __init__(self, write: Optional[Future]):
        self._write = write

    def result(self):
        out = self._write.result() if self._write is not None else None
        import torch.distributed as dist
        dist.barrier()
        return out


def save(ckpt_dir: str, step: int, state: Any, *, keep: int = 3,
         executor: Optional[ThreadPoolExecutor] = None, shardings: Any = None,
         mi: MeshInfo = NO_MESH) -> Future | MeshSave | None:
    """Write a checkpoint; asynchronous when an executor is given (the copy
    to the host happens here, synchronously, so the caller may change the
    state in place as soon as this returns; the file writes in the
    executor's thread). On a mesh (``shardings`` and ``mi``) every rank
    calls it with its blocks: each leaf is gathered whole, one at a time,
    rank 0 keeps the host copies and writes them, and every rank waits
    for the commit: here without an executor, else in the returned
    :class:`MeshSave`'s ``result()``, which every rank must call."""
    flat, treedef = flatten(state)
    dtypes = [_dtype_name(t) for t in flat]
    if mi.active:
        import torch.distributed as dist
        rank0 = dist.get_rank() == 0
        host_leaves = []
        for t, sh in zip(flat, leaves(shardings)):
            whole = gather_whole(t, sh, mi)
            host_leaves.append(_to_host(whole) if rank0 else None)
            del whole
    else:
        host_leaves = [_to_host(t) for t in flat]
    treedef_repr = repr(treedef)

    def _write():
        d = pathlib.Path(ckpt_dir)
        d.mkdir(parents=True, exist_ok=True)
        tmp = d / f"step_{step}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        for i, arr in enumerate(host_leaves):
            np.save(tmp / f"leaf_{i}.npy", arr)
        manifest = {
            "step": step,
            "n_leaves": len(host_leaves),
            "treedef": treedef_repr,
            "shapes": [list(a.shape) for a in host_leaves],
            "dtypes": dtypes,
            "time": time.time(),
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = d / f"step_{step}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)               # atomic commit
        _cleanup(d, keep)
        return str(final)

    if mi.active:
        if executor is not None:
            return MeshSave(executor.submit(_write) if rank0 else None)
        if rank0:
            _write()
        MeshSave(None).result()
        return None
    if executor is not None:
        return executor.submit(_write)
    _write()
    return None


def _cleanup(d: pathlib.Path, keep: int):
    steps = sorted((int(p.name.split("_")[1]), p) for p in d.glob("step_*")
                   if not p.name.endswith(".tmp"))
    for _, p in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    d = pathlib.Path(ckpt_dir)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.glob("step_*")
             if not p.name.endswith(".tmp") and (p / "manifest.json").exists()]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, target: Any,
            shardings: Any = None) -> Any:
    """Load a checkpoint into the structure of ``target`` (a tree of
    tensors): each leaf takes its target's dtype and device. With
    ``shardings`` (a tree of Shardings beside ``target``, whose leaves are
    then this rank's blocks) each leaf's block is cut from its file, read
    mapped: the elastic restore onto whatever mesh the job runs."""
    d = pathlib.Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat, treedef = flatten(target)
    if manifest["n_leaves"] != len(flat):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"target {len(flat)}")
    placed = (leaves(shardings) if shardings is not None
              else [None] * len(flat))
    out = []
    for i, (tgt, dtype, sh) in enumerate(zip(flat, manifest["dtypes"],
                                             placed)):
        arr = np.load(d / f"leaf_{i}.npy", mmap_mode="r")
        want = tuple(arr.shape) if sh is None else sh.local_shape(arr.shape)
        if want != tuple(tgt.shape):
            raise ValueError(f"leaf {i}: ckpt {arr.shape} (here "
                             f"{want}) vs target {tuple(tgt.shape)}")
        arr = np.array(arr if sh is None else sh.cut(arr))   # a copy
        if dtype == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        out.append(t.to(device=tgt.device, dtype=tgt.dtype))
    return unflatten(treedef, out)
