"""Plain PyTorch version of the flash-attention forward kernel: a port of the
forward of ``repro/models/attention.py::flash_attention`` (double-chunked
online softmax, GQA by repeating K/V, causal / window / q_offset masks,
softcap, probabilities cast to the value dtype before P @ V)."""
from __future__ import annotations

from typing import Optional

import torch


def _chunk_of(total: int, want: int) -> int:
    """Largest divisor of ``total`` that is <= want."""
    c = min(want, total)
    while total % c != 0:
        c -= 1
    return c


def _block_mask(q_pos, kv_pos, causal: bool, window: Optional[int]):
    mask = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= q_pos[:, None] - kv_pos[None, :] < window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None, q_offset: int = 0,
                        kv_chunk: int = 1024, q_chunk: int = 512
                        ) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D). Returns (B, Sq, Hq, D)."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    C = _chunk_of(Skv, kv_chunk)
    QC = _chunk_of(Sq, q_chunk)
    scale = D ** -0.5
    dev = q.device
    outs = []
    for i in range(Sq // QC):
        qi = q[:, i * QC:(i + 1) * QC].float()
        q_pos = i * QC + torch.arange(QC, device=dev) + q_offset
        m = torch.full((B, QC, Hq), float("-inf"), device=dev)
        l = torch.zeros((B, QC, Hq), device=dev)
        acc = torch.zeros((B, QC, Hq, D), device=dev)
        for j in range(Skv // C):
            kj = k[:, j * C:(j + 1) * C]
            vj = v[:, j * C:(j + 1) * C]
            kv_pos = j * C + torch.arange(C, device=dev)
            s = torch.einsum("bqhd,bchd->bqhc", qi, kj.float()) * scale
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            mask = _block_mask(q_pos, kv_pos, causal, window)
            s = s.masked_fill(~mask[None, :, None, :], float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new,
                                 torch.zeros_like(m_new))
            p = torch.exp(s - m_safe[..., None])
            corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe,
                                         torch.full_like(m, float("-inf"))))
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqhc,bchd->bqhd", p.to(vj.dtype).float(), vj.float())
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-20)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=1)
