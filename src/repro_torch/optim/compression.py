"""Int8 gradient compression with error feedback (port of
``repro/optim/compression.py``): ``ef_compress`` quantizes and dequantizes
each gradient leaf to int8 with a per-leaf scale, carrying the residual in
an error-feedback buffer so the bias vanishes over steps. ``torch.round``
rounds half to even as ``jnp.round`` does, so equal inputs quantize to
equal values. ``compressed_psum`` (an int8 reduce across devices) waits for
the multi-device slice.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import flatten, tree_map, unflatten


def _quant_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress(grads: Any, ef: Any) -> Tuple[Any, Any]:
    """Error-feedback int8 quantization. grads/ef: trees of one structure;
    returns (dequantized fp32 grads, new error-feedback buffers)."""
    out_g, out_e = [], []
    g_leaves, treedef = flatten(grads)
    for g, e in zip(g_leaves, flatten(ef)[0]):
        g = g.to(torch.float32) + e
        deq = _dequant_leaf(*_quant_leaf(g))
        out_g.append(deq)
        out_e.append(g - deq)
    return unflatten(treedef, out_g), unflatten(treedef, out_e)


def init_ef(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)
