"""Shared layers (port of ``repro/models/layers.py``, dense subset):
norm, GLU MLP, rotary embedding, embedding and tied head."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 statistics, cast back to x's dtype, then scaled by ``w``."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


_ACTS = {"silu": F.silu, "gelu": lambda t: F.gelu(t, approximate="tanh"),
         "relu": F.relu}


def glu_mlp(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    h = _ACTS[act](x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions broadcastable to (..., S). Angles in
    fp32; the rotation is computed in the promoted dtype and cast back."""
    d = x.shape[-1]
    d2 = d // 2
    freqs = theta ** (-torch.arange(0, d2, dtype=torch.float32,
                                    device=x.device) / d2)
    ang = positions[..., None].float() * freqs                 # (..., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :d2], x[..., d2:2 * d2]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if 2 * d2 != d:
        out = torch.cat([out, x[..., 2 * d2:]], dim=-1)
    return out.to(x.dtype)


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def logits_fn(p: dict, x: torch.Tensor, softcap: Optional[float]) -> torch.Tensor:
    head = p["head"] if "head" in p else p["table"].T
    logits = x @ head
    if softcap is not None:
        logits = softcap * torch.tanh(logits.float() / softcap)
    return logits
