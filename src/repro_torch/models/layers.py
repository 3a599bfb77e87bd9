"""Shared layers (port of ``repro/models/layers.py``): norm, GLU MLP, the
2-layer MLP, rotary embedding, embedding and tied head, and the chunked
cross-entropy of training.

On a mesh whose ``model`` axis splits the vocab (the reference's table
``P("tp", "fsdp")`` and head ``P("fsdp", "tp")``), a rank holds vocab rows
``[v0, v0 + V/m)`` of both and never the whole: ``vocab_parallel_embed``
looks its tokens up in its block and sums the ranks' rows
(``reduce_from``), ``vocab_parallel_xent`` computes its block's logits
and takes the logsumexp and the gold logit over the ranks with one
all-reduce MAX and one SUM a chunk (what the reference's partitioner
does with ``chunked_xent`` on those specs)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.dist import (MeshInfo, all_reduce, axis_rank,
                                     copy_to, reduce_from)


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


def _chunked(step, x: torch.Tensor, labels: torch.Tensor, n_chunks: int,
             count: Optional[int]) -> torch.Tensor:
    """``step(x_chunk, labels_chunk)`` over the sequence in ``n_chunks``
    chunks (the largest count <= n_chunks that divides S), each recomputed
    on backward (non-reentrant ``checkpoint``, the reference's
    ``jax.checkpoint`` of its scan step), summed in chunk order into one
    fp32 total, divided by ``count`` (default B * S)."""
    B, S, _ = x.shape
    while S % n_chunks:
        n_chunks -= 1
    C = S // n_chunks
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(n_chunks):
        sl = slice(j * C, (j + 1) * C)
        total = total + checkpoint(step, x[:, sl], labels[:, sl].long(),
                                   use_reentrant=False)
    return total / (count or B * S)


def chunked_xent(embed_params: dict, x: torch.Tensor, labels: torch.Tensor,
                 softcap: Optional[float], n_chunks: int = 8,
                 count: Optional[int] = None) -> torch.Tensor:
    """Mean cross-entropy without the full (B, S, V) logits: each chunk's
    (B, S/n, V) logits in fp32 (``_chunked``); ``count`` defaults to B *
    S (a rank's share of a global batch's mean divides by the global
    count)."""
    def step(xi, li):
        logits = logits_fn(embed_params, xi, softcap).float()
        gold = torch.gather(logits, -1, li[..., None])[..., 0]
        return torch.sum(torch.logsumexp(logits, dim=-1) - gold)

    return _chunked(step, x, labels, n_chunks, count)


# ---------------------------------------------------------------- vocab-parallel

def vocab_start(n_local: int, mi: MeshInfo) -> int:
    """The first vocab row of this rank's block of ``n_local`` rows."""
    return axis_rank(mi, "model") * n_local


def vocab_parallel_embed(p: dict, tokens: torch.Tensor, mi: MeshInfo
                         ) -> torch.Tensor:
    """``embed`` with ``p["table"]`` this rank's vocab block: the rows of
    the tokens the block holds, zero rows for the others, summed over
    ``model`` (each token's row comes from one rank, so the sum is exact);
    the gradient reaches the block's rows alone."""
    n = p["table"].shape[0]
    local = tokens - vocab_start(n, mi)
    inside = (local >= 0) & (local < n)
    rows = p["table"][torch.where(inside, local, 0)]
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return reduce_from(rows, mi, "model")


def vocab_parallel_argmax(logits: torch.Tensor, mi: MeshInfo
                          ) -> torch.Tensor:
    """The index over the whole vocab of each row's largest logit, where
    ``logits`` (..., V / m) is this rank's vocab block over ``model``:
    each block's first largest, the largest value by one all-reduce MAX
    and the smallest index that holds it by one MIN (``argmax``'s first
    occurrence over the whole vocab), int64."""
    n = logits.shape[-1]
    idx = torch.argmax(logits, dim=-1)
    val = torch.gather(logits, -1, idx[..., None])[..., 0].float()
    top = all_reduce(val, mi, "model", "max")
    cand = torch.where(val == top, idx + vocab_start(n, mi),
                       torch.full_like(idx, torch.iinfo(idx.dtype).max))
    return all_reduce(cand, mi, "model", "min")


def _vocab_gold(logits: torch.Tensor, labels: torch.Tensor, v0: int
                ) -> torch.Tensor:
    """Each row's logit at its label where the label falls in this rank's
    block ``[v0, v0 + n)`` of the logits' last dimension, else 0."""
    n = logits.shape[-1]
    local = labels - v0
    inside = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    return torch.where(inside, gold, torch.zeros_like(gold))


def vocab_parallel_xent(embed_params: dict, x: torch.Tensor,
                        labels: torch.Tensor, softcap: Optional[float],
                        mi: MeshInfo, n_chunks: int = 8,
                        count: Optional[int] = None) -> torch.Tensor:
    """``chunked_xent`` with ``embed_params`` this rank's vocab block of
    the head (or of the tied table): each chunk's (B, S/n, V/m) logits of
    ``copy_to(x)`` (so x's gradient sums the ranks' blocks), softcapped in
    fp32; the row max all-reduced (MAX, detached: the logsumexp does not
    depend on it), then the block's sum of exp(logits - max) and its gold
    logit (``_vocab_gold``) summed over ``model`` in one all-reduce. Every
    model rank returns the same loss."""
    key = "head" if "head" in embed_params else "table"
    n = embed_params[key].shape[-1 if key == "head" else 0]
    v0 = vocab_start(n, mi)

    def step(xi, li):
        logits = logits_fn(embed_params, copy_to(xi, mi, "model"),
                           softcap).float()
        top = all_reduce(logits.detach().amax(-1), mi, "model", op="max")
        part = torch.stack([torch.exp(logits - top[..., None]).sum(-1),
                            _vocab_gold(logits, li, v0)])
        sums, gold = reduce_from(part, mi, "model").unbind(0)
        return torch.sum(top + torch.log(sums) - gold)

    return _chunked(step, x, labels, n_chunks, count)
