"""Shared layers (port of ``repro/models/layers.py``): norm, GLU MLP, the
2-layer MLP, rotary embedding, embedding and tied head, and the chunked
cross-entropy of training."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


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


def mlp2(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """The 2-layer MLP (seamless's relu FFN): no gate, no bias."""
    return _ACTS[act](x @ p["w1"]) @ p["w2"]


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


def chunked_xent(embed_params: dict, x: torch.Tensor, labels: torch.Tensor,
                 softcap: Optional[float], n_chunks: int = 8,
                 count: Optional[int] = None) -> torch.Tensor:
    """Mean cross-entropy without the full (B, S, V) logits: the sequence
    in ``n_chunks`` chunks (the largest count <= n_chunks that divides S),
    each chunk's (B, S/n, V) logits in fp32 recomputed on backward
    (non-reentrant ``checkpoint``, the reference's ``jax.checkpoint`` of
    its scan step) and summed in chunk order into one fp32 total, divided
    by ``count`` (default B * S; a rank's share of a global batch's mean
    divides by the global count)."""
    B, S, _ = x.shape
    while S % n_chunks:
        n_chunks -= 1
    C = S // n_chunks

    def step(xi, li):
        logits = logits_fn(embed_params, xi, softcap).float()
        gold = torch.gather(logits, -1, li[..., None])[..., 0]
        return torch.sum(torch.logsumexp(logits, dim=-1) - gold)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(n_chunks):
        sl = slice(j * C, (j + 1) * C)
        total = total + checkpoint(step, x[:, sl], labels[:, sl].long(),
                                   use_reentrant=False)
    return total / (count or B * S)
