"""Mamba-1 selective SSM mixer, jamba's sequence layer (port of
``repro/models/mamba.py``): plain PyTorch on tensors.

    h_t = exp(dt_t * A) h_{t-1} + (dt_t * B_t) x_t      (diagonal A)
    y_t = C_t . h_t + D * x_t

``mamba_mix`` is the reference's chunked scan: the (decay, drive) pairs of
a chunk are combined by an inclusive scan over time, and the state is
carried from chunk to chunk. The reference's ``jax.lax.associative_scan``
is written here as a log-depth doubling (Hillis-Steele) scan of the same
combine, ``(a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2)``; its order of
rounding differs from XLA's, so it agrees with the reference to fp32
rounding, not bit for bit. ``mamba_mix_step`` is the one-token recurrence.

Chunking is the reference's (chunk 256, ``nC = max(T // chunk, 1); C = T //
nC``): a length its reshape cannot take (513) raises ValueError.

``decay`` and ``drive`` are (B, T, d_inner, N) fp32, as in the reference:
at jamba's d_inner 16384 and N 16, 1 MiB a token each. ``softplus`` is
``torch.logaddexp(x, 0)``, the reference's ``jax.nn.softplus``
(``F.softplus`` returns x itself above 20, which differs by ulps).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.dist import NO_MESH, MeshInfo
from repro_torch.models.params import ParamSpec, residual
from repro_torch.models.rwkv6 import chunking


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return d_in, dt_rank, s.d_state, s.d_conv


def mamba_specs(cfg: ModelConfig, damp: float) -> Dict[str, ParamSpec]:
    """The reference's leaves: ``dt_bias`` uniform in +-4 and ``A_log`` in
    +-1 (fp32), ``D`` ones (fp32), ``conv_b`` zeros, the rest at fan-in std
    and ``out_proj`` damped."""
    d = cfg.d_model
    d_in, dt_rank, N, K = _dims(cfg)
    return {
        "in_proj": ParamSpec((d, 2 * d_in), pspec=("fsdp", "tp")),
        "conv_w": ParamSpec((K, d_in), pspec=(None, "tp")),
        "conv_b": ParamSpec((d_in,), "zeros", pspec=("tp",)),
        "x_proj": ParamSpec((d_in, dt_rank + 2 * N), pspec=("tp", None)),
        "dt_proj": ParamSpec((dt_rank, d_in), pspec=(None, "tp")),
        "dt_bias": ParamSpec((d_in,), "uniform_pm", 4.0, dtype="float32",
                             pspec=("tp",)),
        "A_log": ParamSpec((d_in, N), "uniform_pm", 1.0, dtype="float32",
                           pspec=("tp", None)),
        "D": ParamSpec((d_in,), "ones", dtype="float32", pspec=("tp",)),
        "out_proj": residual((d_in, d), damp, ("tp", "fsdp")),
    }


class MambaState(NamedTuple):
    conv: torch.Tensor   # (B, K-1, d_in) last inputs of the causal conv
    ssm: torch.Tensor    # (B, d_in, N) fp32


def zero_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
               device) -> MambaState:
    """The reference's ``mamba_state_specs`` (and ``_zero_mamba``) as
    zeros."""
    d_in, _, N, K = _dims(cfg)
    return MambaState(
        conv=torch.zeros((batch, K - 1, d_in), dtype=dtype, device=device),
        ssm=torch.zeros((batch, d_in, N), dtype=torch.float32, device=device))


def _conv_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 carry: torch.Tensor):
    """Depthwise causal conv. x: (B, T, d_in), w: (K, d_in), carry:
    (B, K-1, d_in). Taps summed in order i = 0..K-1, then the bias."""
    K, T = w.shape[0], x.shape[1]
    xp = torch.cat([carry, x], dim=1)                  # (B, T+K-1, d_in)
    out = sum(xp[:, i:i + T] * w[i] for i in range(K)) + b
    return out, xp[:, -(K - 1):]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _ssm_inputs(p: dict, x: torch.Tensor, cfg: ModelConfig):
    _, dt_rank, N, _ = _dims(cfg)
    proj = x @ p["x_proj"]                             # (B, T, dt_rank+2N)
    dt_lr, Bm, Cm = torch.split(proj, [dt_rank, N, N], dim=-1)
    dt = _softplus((dt_lr @ p["dt_proj"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])                         # (d_in, N)
    decay = torch.exp(dt[..., None] * A)               # (B, T, d_in, N)
    drive = (dt[..., None] * Bm[:, :, None, :].float()
             * x[..., None].float())                   # (B, T, d_in, N)
    return decay, drive, Cm


def _scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along dim 1 of the pairs (a, b) under
    (a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2), by doubling."""
    T, d = a.shape[1], 1
    while d < T:
        a_lo, b_lo = a[:, :-d], b[:, :-d]
        a_hi, b_hi = a[:, d:], b[:, d:]
        b = torch.cat([b[:, :d], b_lo * a_hi + b_hi], dim=1)
        a = torch.cat([a[:, :d], a_lo * a_hi], dim=1)
        d *= 2
    return a, b


def mamba_mix(p: dict, x: torch.Tensor, cfg: ModelConfig, state: MambaState,
              chunk: int = 256, *, mi: MeshInfo = NO_MESH):
    """x: (B, T, d). Returns (out (B, T, d), new MambaState). ``mi`` is
    taken as the reference takes it, and not used (every rank holds whole
    tensors)."""
    B, T, _ = x.shape
    nC, C = chunking(T, chunk)
    xi, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    xi, conv_carry = _conv_causal(xi, p["conv_w"], p["conv_b"], state.conv)
    xi = F.silu(xi)
    decay, drive, Cm = _ssm_inputs(p, xi, cfg)
    h0 = state.ssm.float()
    hs = []
    for j in range(nC):
        sl = slice(j * C, (j + 1) * C)
        a_sc, b_sc = _scan(decay[:, sl], drive[:, sl])
        h = a_sc * h0[:, None] + b_sc                  # (B, C, d_in, N)
        h0 = h[:, -1]
        hs.append(h)
    h = torch.cat(hs, dim=1) if nC > 1 else hs[0]
    y = torch.einsum("btdn,btn->btd", h, Cm.float()) \
        + p["D"] * xi.float()
    out = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    return out, MambaState(conv=conv_carry, ssm=h0)


def mamba_mix_step(p: dict, x: torch.Tensor, cfg: ModelConfig,
                   state: MambaState):
    """Single-token decode. x: (B, 1, d)."""
    xi, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    xi_c, conv_carry = _conv_causal(xi, p["conv_w"], p["conv_b"], state.conv)
    xi_c = F.silu(xi_c)
    decay, drive, Cm = _ssm_inputs(p, xi_c, cfg)
    h = decay[:, 0] * state.ssm + drive[:, 0]          # (B, d_in, N)
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0].float()) \
        + p["D"] * xi_c[:, 0].float()
    out = (y[:, None].to(x.dtype) * F.silu(z)) @ p["out_proj"]
    return out, MambaState(conv=conv_carry, ssm=h)
