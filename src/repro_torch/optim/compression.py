"""Int8 gradient compression with error feedback (port of
``repro/optim/compression.py``): ``ef_compress`` quantizes and dequantizes
each gradient leaf to int8 with a per-leaf scale, carrying the residual in
an error-feedback buffer so the bias vanishes over steps. ``torch.round``
rounds half to even as ``jnp.round`` does, so equal inputs quantize to
equal values. On a mesh a leaf's scale is its whole leaf's: the largest
|g| reduced with MAX over the axes the leaf is split on.
``compressed_psum(x, mi, axis)`` is the reference's int8 all-reduce: the
scale agreed by an all-reduce with MAX, the int8 payloads summed in
int32. Nothing in the train step calls it, as in the reference.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models.dist import NO_MESH, MeshInfo, all_reduce
from repro_torch.tree import flatten, leaves, tree_map, unflatten


def _quant_leaf(g: torch.Tensor, mi: MeshInfo = NO_MESH, axes=()
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    gmax = torch.max(torch.abs(g))
    if axes:
        gmax = all_reduce(gmax, mi, axes, op="max")
    scale = torch.clamp(gmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress(grads: Any, ef: Any, mi: MeshInfo = NO_MESH,
                shards=None) -> Tuple[Any, Any]:
    """Error-feedback int8 quantization. grads/ef: trees of one structure
    (on a mesh this rank's blocks, placed by the Shardings ``shards``);
    returns (dequantized fp32 grads, new error-feedback buffers)."""
    out_g, out_e = [], []
    g_leaves, treedef = flatten(grads)
    placed = leaves(shards) if mi.active else [None] * len(g_leaves)
    for g, e, sh in zip(g_leaves, flatten(ef)[0], placed):
        g = g.to(torch.float32) + e
        axes = sh.split if sh is not None else ()
        deq = _dequant_leaf(*_quant_leaf(g, mi, axes))
        out_g.append(deq)
        out_e.append(g - deq)
    return unflatten(treedef, out_g), unflatten(treedef, out_e)


def init_ef(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def compressed_psum(x: torch.Tensor, mi: MeshInfo, axis: str) -> torch.Tensor:
    """Int8-quantized sum of ``x`` over ``axis``'s ranks: the scale is the
    largest |x| of any rank (an all-reduce with MAX) over 127, floored at
    1e-12; each rank's payload rounds half to even to int8; the payloads
    sum in int32; one fp32 product by the scale."""
    scale = all_reduce(torch.max(torch.abs(x)), mi, axis, op="max") / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    total = all_reduce(q.to(torch.int32), mi, axis)
    return total.to(torch.float32) * scale
