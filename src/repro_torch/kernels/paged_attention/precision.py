"""The yardstick of the bf16 decode kernel's precision in P.

The reference keeps the softmax weights P in fp32 through P.V
(``repro/models/attention.py::paged_decode_attention``). On random inputs a
bf16 output's own rounding (2^-8 relative) hides a P rounded to bf16
(2^-9 relative), so :func:`p_cancellation_case` builds a decode where it
shows: in every row, each page's first token scores highest and has V = 0;
the other tokens alternate between a group whose V rows are +c and one
whose rows are -c, with scores chosen so that the two groups' P fall
between bf16 neighbours in opposite directions (one rounds down, the other
up). The exact output is then near 0, and bf16(P) leaves an error of order
c * 2^-9. Every page starts with a maximal score, so each split and each
warp of the kernel meets the row's maximum in its first tile, and its P
equals the plain version's.

:func:`decode_p_rounded` is the plain decode that rounds P to bf16 before
P.V and sums l from the unrounded P: what the tensor-core path did before
it carried P in two bf16 terms.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.paged_attention.ref import (gather_global_pages,
                                                     gather_slot_pages)


def _bf16_grid(lo: float, hi: float) -> np.ndarray:
    """Every bf16 value in [lo, hi] (lo < hi <= 0), ascending."""
    bits = np.arange(0x8000, 0x10000, dtype=np.uint32) << 16
    vals = bits.view(np.float32)
    return np.sort(vals[(vals >= lo) & (vals <= hi) & np.isfinite(vals)])


def _round_frac(p: np.ndarray) -> np.ndarray:
    """Where p lies between its bf16 neighbours: 0 at the lower, 1 at the
    upper (p in [0.5, 1), where the spacing is 2^-8)."""
    return (p - 0.5) * 256.0 % 1.0


def cancellation_scores(d: int) -> Tuple[float, float]:
    """Two bf16 key values (the score of a query that is 1 in dimension 0):
    the first gives P = exp(k / sqrt(d)) just below a midpoint of bf16
    neighbours (bf16 rounds it down by ~0.45 of a spacing), the second
    just above one (rounded up by about as much)."""
    ks = _bf16_grid(-math.log(2.0) * math.sqrt(d) + 1e-3, -1e-3)
    p = np.exp(ks.astype(np.float64) / math.sqrt(d))
    f = _round_frac(p)
    down = np.where((f > 0.3) & (f < 0.45), f, -1.0)
    up = np.where((f > 0.55) & (f < 0.7), f, 2.0)
    return float(ks[int(np.argmax(down))]), float(ks[int(np.argmin(up))])


def p_cancellation_case(per_slot: bool, device, *, d: int = 64,
                        page: int = 16, hq: int = 8, hkv: int = 2,
                        n_pages: int = 4, batch: int = 3, c: float = 64.0,
                        seed: int = 0):
    """(q, k_pool, v_pool, table, lengths) in bf16 for the layout's wrapper:
    ``batch`` rows of ``n_pages`` full pages each, the tables a
    permutation of the pool's pages (see the module docstring)."""
    k_down, k_up = cancellation_scores(d)
    n_tok = n_pages * page
    kcol = np.empty((batch, n_tok), np.float32)
    vval = np.empty((batch, n_tok), np.float32)
    for b in range(batch):
        j = 0
        for t in range(n_tok):
            if t % page == 0:
                kcol[b, t], vval[b, t] = 0.0, 0.0      # the row's maximum
            else:
                kcol[b, t], vval[b, t] = ((k_down, c) if j % 2 == 0
                                          else (k_up, -c))
                j += 1
    kseq = np.zeros((batch, n_tok, hkv, d), np.float32)
    kseq[:, :, :, 0] = kcol[:, :, None]
    vseq = np.broadcast_to(vval[:, :, None, None],
                           (batch, n_tok, hkv, d)).copy()
    kpages = kseq.reshape(batch, n_pages, page, hkv, d)
    vpages = vseq.reshape(batch, n_pages, page, hkv, d)
    rng = np.random.default_rng(seed)
    if per_slot:
        table = np.stack([rng.permutation(n_pages)
                          for _ in range(batch)]).astype(np.int32)
        kp = np.zeros_like(kpages)
        vp = np.zeros_like(vpages)
        for b in range(batch):
            kp[b, table[b]] = kpages[b]
            vp[b, table[b]] = vpages[b]
    else:
        table = rng.permutation(batch * n_pages).reshape(
            batch, n_pages).astype(np.int32)
        kp = np.zeros((batch * n_pages, page, hkv, d), np.float32)
        vp = np.zeros_like(kp)
        kp[table.reshape(-1)] = kpages.reshape(-1, page, hkv, d)
        vp[table.reshape(-1)] = vpages.reshape(-1, page, hkv, d)
    q = np.zeros((batch, hq, d), np.float32)
    q[:, :, 0] = 1.0
    dev = torch.device(device)
    bf = lambda a: torch.from_numpy(a).to(dev).to(torch.bfloat16)
    return (bf(q), bf(kp), bf(vp), torch.from_numpy(table).to(dev),
            torch.full((batch,), n_tok, dtype=torch.int32, device=dev))


def decode_p_rounded(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, table: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Plain decode (no softcap; either layout, by the pool's rank) whose P
    is rounded to bf16 before P.V while l sums the unrounded P; fp32 out."""
    gather = gather_slot_pages if k_pool.dim() == 5 else gather_global_pages
    k = gather(k_pool, table).float()
    v = gather(v_pool, table).float()
    B, Hq, D = q.shape
    _, P, page, Hkv, _ = k.shape
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bhgd,bpthd->bhgpt", qg, k) * (D ** -0.5)
    pos = torch.arange(P * page, device=q.device).reshape(P, page)
    invalid = ~(pos[None] < lengths.long()[:, None, None])[:, None, None]
    s = s.masked_fill(invalid, float("-inf"))
    m = s.amax(dim=(-2, -1), keepdim=True)
    p = torch.exp(s - m).masked_fill(invalid, 0.0)
    l = p.sum(dim=(-2, -1))
    o = torch.einsum("bhgpt,bpthd->bhgd", p.bfloat16().float(), v)
    return (o / l[..., None]).reshape(B, Hq, D)
