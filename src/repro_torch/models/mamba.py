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

Tensor parallelism (``tp``, training on a mesh whose ``model`` axis is
larger than 1; the leaves are this rank's blocks by the reference's
specs, ``mamba_specs``): d_inner splits over ``model``, c = d_in / model
channels a rank, and the scan runs over the rank's channels alone.

  in_proj      ``("fsdp", "tp")`` over the concatenated [xi | z] columns,
               so a rank's block is the contiguous columns [r 2c, (r+1)
               2c): on a model axis of 2, rank 0 holds xi whole and rank
               1 z whole. The rank needs xi's columns [r c, (r+1) c) and
               z's d_in + [r c, (r+1) c). The layer reassembles them
               without changing the stored layout: x enters through
               ``copy_to`` (its gradient summed), each rank's product with
               its block is gathered over ``model`` (``gather_from``:
               all-gather forward, reduce-scatter backward) and the rank
               takes its two ranges. That moves the (B, T, 2 d_in)
               product, B T 4 d_in bytes in bf16 (67 MB for jamba's d_in
               16384 at 2 x 512 tokens), where gathering the weight would
               move 4 d d_in (537 MB a layer): the product is the smaller
               below d tokens a rank.
  conv_w, conv_b, dt_proj, dt_bias, A_log, D
               the rank's c channels (``"tp"`` on their d_in dimension).
  x_proj       ``("tp", None)``, row parallel: the partial (B, T,
               dt_rank + 2N) product is summed over ``model``
               (``reduce_from``, forward). dt_lr, B and C are then whole,
               but each rank uses them for its own channels only, so their
               gradient is summed over ``model`` (``copy_to`` after the
               sum, backward).
  out_proj     ``("tp", "fsdp")``, row parallel: its output summed over
               ``model`` (``reduce_from``, forward).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.dist import (NO_MESH, MeshInfo, axis_rank, copy_to,
                                     gather_from, reduce_from)
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


def state_specs(cfg: ModelConfig, batch: int) -> MambaState:
    """The reference's ``mamba_state_specs``: one slot's state a row, the
    d_in channels over ``model``."""
    d_in, _, N, K = _dims(cfg)
    return MambaState(
        conv=ParamSpec((batch, K - 1, d_in), "zeros",
                       dtype=cfg.activation_dtype,
                       pspec=("batch", None, "tp")),
        ssm=ParamSpec((batch, d_in, N), "zeros", dtype="float32",
                      pspec=("batch", "tp", None)))


def zero_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
               device, split: int = 1) -> MambaState:
    """The reference's ``mamba_state_specs`` (and ``_zero_mamba``) as
    zeros, over d_in / ``split`` channels (a rank's, under tensor
    parallelism over a model axis of ``split``)."""
    d_in, _, N, K = _dims(cfg)
    d_in //= split
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


def _ssm_inputs(p: dict, x: torch.Tensor, cfg: ModelConfig,
                mi: Optional[MeshInfo] = None):
    """(decay, drive, C); with ``mi``, x_proj's product is summed over its
    model axis and its gradient summed there too (the module's
    docstring)."""
    _, dt_rank, N, _ = _dims(cfg)
    proj = x @ p["x_proj"]                             # (B, T, dt_rank+2N)
    if mi is not None:
        proj = copy_to(reduce_from(proj, mi, "model"), mi, "model")
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


def _tp_in_proj(p: dict, x: torch.Tensor, mi: MeshInfo):
    """(xi, z) of this rank's c channels from its contiguous block of
    in_proj's [xi | z] columns: the products gathered over ``model``, then
    xi's columns [r c, (r+1) c) and z's d_in + [r c, (r+1) c)."""
    c = p["conv_w"].shape[1]
    lo, d_in = axis_rank(mi, "model") * c, c * mi.size("model")
    xz = gather_from(copy_to(x, mi, "model") @ p["in_proj"], -1, mi,
                     "model")
    return xz[..., lo:lo + c], xz[..., d_in + lo:d_in + lo + c]


def mamba_mix(p: dict, x: torch.Tensor, cfg: ModelConfig, state: MambaState,
              chunk: int = 256, *, mi: MeshInfo = NO_MESH, tp: bool = False):
    """x: (B, T, d). Returns (out (B, T, d), new MambaState). With ``tp``
    the tensor-parallel form over ``mi``'s model axis (the module's
    docstring): the state holds the rank's channels and ``out`` is the
    sum over the ranks."""
    B, T, _ = x.shape
    nC, C = chunking(T, chunk)
    if tp:
        xi, z = _tp_in_proj(p, x, mi)
    else:
        xi, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    xi, conv_carry = _conv_causal(xi, p["conv_w"], p["conv_b"], state.conv)
    xi = F.silu(xi)
    decay, drive, Cm = _ssm_inputs(p, xi, cfg, mi if tp else None)
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
    if tp:
        out = reduce_from(out, mi, "model")
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
