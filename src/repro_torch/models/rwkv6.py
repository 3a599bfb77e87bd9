"""RWKV-6 "Finch" time mix and channel mix (port of
``repro/models/rwkv6.py``, the serving forms): plain PyTorch on tensors.

Time-mix recurrence per head (head size N):
    y_t   = r_t^T (S_t + u * k_t v_t^T)
    S_t+1 = diag(w_t) S_t + k_t v_t^T        (w_t data-dependent, in (0,1))

``rwkv_time_mix`` is the reference's chunked form (its non-``unroll_scans``
path, the serving default): within a chunk the (t, s) interaction uses
per-channel cumulative log-decays (every exponent <= 0); across chunks the
(N, N) state is carried by a Python loop over chunks, one chunk's
(B, C, C, H, N) intra-chunk tensor at a time. ``rwkv_time_mix_step`` is the
plain recurrence for one decode token.

Chunking is the reference's, ``nC = max(T // chunk, 1); C = T // nC``, and
its reshape takes only lengths where ``nC * C == T``; at any other length
(71 tokens at chunk 32) this raises ValueError where the reference fails to
reshape. Nothing is padded and no ragged last chunk is taken.

Cast points are the reference's: r, k and v leave their matmuls at the
activation dtype and are then made fp32, the decay is fp32, the group norm
runs in fp32 (population variance) and is cast back before the gate. The
state keeps ``wkv`` in fp32 and both token-shift carries at the activation
dtype.

Tensor parallelism (``tp``, training on a mesh whose ``model`` axis is
larger than 1; the leaves are this rank's blocks by the reference's specs,
``rwkv_time_mix_specs``). Each rank runs the reference's function on its
own heads, and the collectives are Megatron's f and g (``models.dist``):

  time mix     ``wr``/``wk``/``wv``/``wg`` (``("fsdp", "tp")``) are column
               blocks of H / model heads and ``u`` (``("tp", None)``) the
               same heads: r, k, v, g and the chunked scan are local to
               them, the WKV state (B, H / model, N, N) too, and the scan
               needs no collective. ``wo`` (``("tp", "fsdp")``) is row
               parallel: its partial output is summed over ``model``
               (``reduce_from``, forward). ``mu``, ``w0``, ``w_lora_a``,
               ``w_lora_b`` and ``ln_w`` are whole on every rank; the
               decay's ``w0``/``w_lora_b`` and the group norm's ``ln_w``
               are cut to the rank's channels. Each rank's gradient of
               those five leaves is therefore partial, and is summed over
               ``model`` once, by ``copy_to`` on the leaf (backward); x
               and x_prev enter through ``copy_to`` too (their gradient
               summed, backward). No path sums twice: a leaf's gradient
               is taken before the input's ``copy_to`` is reached.
  channel mix  ``wk`` (``("fsdp", "tp")``) is column parallel over d_ff
               and ``wv`` (``("tp", "fsdp")``) row parallel: the key
               input enters through ``copy_to`` and the value product, a
               partial sum of full width d, is summed by ``reduce_from``
               before the gate. ``wr`` is ``("fsdp", "tp")`` as well, but
               its d / model receptance channels cannot gate the whole
               (B, T, d) sum; it is gathered whole over ``model`` at use
               (``gather_param``, forward, 2 d^2 bytes in bf16: 13.1 MB a
               layer for rwkv6-3b), so every model rank computes the same
               receptance, and its gradient, the same on every rank, is
               sliced back, not summed. The receptance path takes no
               ``copy_to``: its gradient is whole on every rank already.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.dist import (NO_MESH, MeshInfo, axis_rank, copy_to,
                                     gather_param, reduce_from)
from repro_torch.models.params import ParamSpec, placed, residual

LORA_R = 64   # decay low-rank width


def rwkv_time_mix_specs(cfg: ModelConfig, damp: float) -> Dict[str, ParamSpec]:
    """The reference's leaves: ``mu`` (5, d) and ``u`` uniform in +-0.5,
    ``w0`` in +-1 (fp32), ``w_lora_b`` zeros (fp32), ``ln_w`` ones (fp32),
    the projections at fan-in std and ``wo`` damped."""
    d, H, N = cfg.d_model, cfg.n_heads, cfg.d_head
    mat = lambda: ParamSpec((d, d), pspec=("fsdp", "tp"))
    return {
        "mu": ParamSpec((5, d), "uniform_pm", 0.5, pspec=(None, None)),
        "w0": ParamSpec((d,), "uniform_pm", 1.0, dtype="float32",
                        pspec=(None,)),
        "w_lora_a": ParamSpec((d, LORA_R), pspec=("fsdp", None)),
        "w_lora_b": ParamSpec((LORA_R, d), "zeros", dtype="float32",
                              pspec=(None, None)),
        "u": ParamSpec((H, N), "uniform_pm", 0.5, dtype="float32",
                       pspec=("tp", None)),
        "wr": mat(), "wk": mat(), "wv": mat(), "wg": mat(),
        "wo": residual((d, d), damp, ("tp", "fsdp")),
        "ln_w": ParamSpec((d,), "ones", dtype="float32", pspec=(None,)),
    }


def rwkv_channel_mix_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """``mu_k``/``mu_r`` uniform in +-0.5; ``wv`` is not damped (the
    reference damps only the keys wo, w_down, w2 and out_proj)."""
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "mu_k": ParamSpec((d,), "uniform_pm", 0.5, pspec=(None,)),
        "mu_r": ParamSpec((d,), "uniform_pm", 0.5, pspec=(None,)),
        "wk": ParamSpec((d, ff), pspec=("fsdp", "tp")),
        "wv": ParamSpec((ff, d), pspec=("tp", "fsdp")),
        "wr": ParamSpec((d, d), pspec=("fsdp", "tp")),
    }


class RWKVState(NamedTuple):
    wkv: torch.Tensor        # (B, H, N, N) fp32
    shift_tm: torch.Tensor   # (B, d) last token (time mix)
    shift_cm: torch.Tensor   # (B, d) last token (channel mix)


def state_specs(cfg: ModelConfig, batch: int) -> RWKVState:
    """The reference's ``rwkv_state_specs``: one slot's state a row, the
    WKV state's heads over ``model``."""
    d, H, N = cfg.d_model, cfg.n_heads, cfg.d_head
    act = cfg.activation_dtype
    return RWKVState(
        wkv=ParamSpec((batch, H, N, N), "zeros", dtype="float32",
                      pspec=("batch", "tp", None, None)),
        shift_tm=ParamSpec((batch, d), "zeros", dtype=act,
                           pspec=("batch", None)),
        shift_cm=ParamSpec((batch, d), "zeros", dtype=act,
                           pspec=("batch", None)))


def zero_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
               device, split: int = 1) -> RWKVState:
    """The reference's ``rwkv_state_specs`` (and ``_zero_rwkv``) as zeros;
    the WKV state of H / ``split`` heads (a rank's, under tensor
    parallelism over a model axis of ``split``)."""
    H, N, d = cfg.n_heads // split, cfg.d_head, cfg.d_model
    return RWKVState(
        wkv=torch.zeros((batch, H, N, N), dtype=torch.float32, device=device),
        shift_tm=torch.zeros((batch, d), dtype=dtype, device=device),
        shift_cm=torch.zeros((batch, d), dtype=dtype, device=device))


def chunking(T: int, chunk: int) -> tuple:
    """(nC, C) of the reference's ``nC = max(T // chunk, 1); C = T // nC``;
    raises ValueError at the lengths its reshape cannot take."""
    nC = max(T // chunk, 1)
    C = T // nC
    if nC * C != T:
        raise ValueError(
            f"sequence length {T} does not split into chunks: the "
            f"reference's chunking (nC = max(T // {chunk}, 1) = {nC}, C = "
            f"T // nC = {C}) covers {nC * C} tokens, and its reshape fails "
            f"at any length where nC * C != T")
    return nC, C


def _decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent per-channel decay w_t in (0, 1); returns log(w_t)
    (fp32, <= 0)."""
    lora = torch.tanh(xw @ p["w_lora_a"]).float() @ p["w_lora_b"]
    return -torch.exp(torch.clamp(p["w0"] + lora, -8.0, 6.0))


def _group_norm(y: torch.Tensor, w: torch.Tensor,
                eps: float = 64e-5) -> torch.Tensor:
    """Per-head group norm over the value dim, fp32. y: (B, T, H, N)."""
    yf = y.float()
    mean = torch.mean(yf, dim=-1, keepdim=True)
    var = torch.var(yf, dim=-1, keepdim=True, correction=0)
    yn = (yf - mean) * torch.rsqrt(var + eps)
    B, T = y.shape[:2]
    return yn.reshape(B, T, -1) * w


def _mix(p: dict, x: torch.Tensor, x_prev: torch.Tensor):
    dx = x_prev - x
    return [x + dx * p["mu"][i] for i in range(5)]


def _chunk_step(S, rf, kf, vf, wj, u):
    """One chunk: (B, C, H, N) fp32 inputs, S (B, H, N, N) -> (S', y)."""
    C = rf.shape[1]
    cl = torch.cumsum(wj, dim=1)                       # inclusive
    cl_prev = cl - wj                                  # exclusive
    # inter: y_inter[t] = (r_t * exp(cl_prev_t))^T S
    y_inter = torch.einsum("bchn,bhnm->bchm", rf * torch.exp(cl_prev), S)
    # intra: A[t,s] = sum_n r_t[n] k_s[n] exp(cl_prev_t[n] - cl_s[n]), s < t,
    # held as (B, t, s, H)
    expo = cl_prev[:, :, None] - cl[:, None, :]        # (B, t, s, H, N)
    mask_lt = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                    device=rf.device), -1)
    expo = torch.where(mask_lt[None, :, :, None, None], expo, -torch.inf)
    A = (rf[:, :, None] * kf[:, None, :] * torch.exp(expo)).sum(-1)
    diag = (rf * u * kf).sum(-1)                       # bonus term u
    y = y_inter + torch.einsum("btsh,bshm->bthm", A, vf) \
        + diag[..., None] * vf
    # S' = diag(prod w) S + sum_s k_s exp(cl_end - cl_s) v_s^T
    cl_end = cl[:, -1]                                 # (B, H, N)
    k_dec = kf * torch.exp(cl_end[:, None] - cl)
    S_new = torch.exp(cl_end)[..., None] * S \
        + torch.einsum("bchn,bchm->bhnm", k_dec, vf)
    return S_new, y


def _tp_time_mix(p: dict, mi: MeshInfo) -> dict:
    """The time mix's leaves under tensor parallelism: the whole leaves
    through ``copy_to`` (their gradient summed over ``model``), the
    per-channel ones cut to this rank's heads' channels after it."""
    H, N = p["u"].shape
    lo = axis_rank(mi, "model") * H * N
    ch = slice(lo, lo + H * N)
    w = {k: copy_to(p[k], mi, "model")
         for k in ("mu", "w0", "w_lora_a", "w_lora_b", "ln_w")}
    return dict(p, mu=w["mu"], w_lora_a=w["w_lora_a"], w0=w["w0"][ch],
                w_lora_b=w["w_lora_b"][:, ch], ln_w=w["ln_w"][ch])


def rwkv_time_mix(p: dict, x: torch.Tensor, x_prev: torch.Tensor,
                  cfg: ModelConfig, state: torch.Tensor, chunk: int = 32, *,
                  mi: MeshInfo = NO_MESH, tp: bool = False):
    """Chunked WKV6. x: (B, T, d); x_prev: x shifted right by one; state:
    (B, H, N, N). Returns (out (B, T, d), final state (B, H, N, N) fp32).
    With ``tp`` the tensor-parallel form over ``mi``'s model axis (the
    module's docstring): H is the rank's heads and ``out`` the sum over
    the ranks."""
    B, T, d = x.shape
    H, N = p["u"].shape
    nC, C = chunking(T, chunk)
    if tp:
        p = _tp_time_mix(p, mi)
        x, x_prev = copy_to(x, mi, "model"), copy_to(x_prev, mi, "model")
    xr, xk, xv, xw, xg = _mix(p, x, x_prev)
    r = (xr @ p["wr"]).reshape(B, T, H, N).float()
    k = (xk @ p["wk"]).reshape(B, T, H, N).float()
    v = (xv @ p["wv"]).reshape(B, T, H, N).float()
    g = F.silu(xg @ p["wg"])
    logw = _decay(p, xw).reshape(B, T, H, N)           # fp32, <= 0
    S = state.float()
    ys = []
    for j in range(nC):
        sl = slice(j * C, (j + 1) * C)
        S, y = _chunk_step(S, r[:, sl], k[:, sl], v[:, sl], logw[:, sl],
                           p["u"])
        ys.append(y)
    y = torch.cat(ys, dim=1)
    out = _group_norm(y, p["ln_w"]).to(x.dtype) * g
    out = out @ p["wo"]
    return (reduce_from(out, mi, "model") if tp else out), S


def rwkv_time_mix_step(p: dict, x: torch.Tensor, x_prev: torch.Tensor,
                       cfg: ModelConfig, state: torch.Tensor):
    """Single-token decode. x: (B, 1, d); state: (B, H, N, N)."""
    B = x.shape[0]
    H, N = cfg.n_heads, cfg.d_head
    xr, xk, xv, xw, xg = _mix(p, x, x_prev)
    r = (xr @ p["wr"]).reshape(B, H, N).float()
    k = (xk @ p["wk"]).reshape(B, H, N).float()
    v = (xv @ p["wv"]).reshape(B, H, N).float()
    g = F.silu(xg @ p["wg"])
    w = torch.exp(_decay(p, xw).reshape(B, H, N))
    kv = k[..., None] * v[..., None, :]                # (B, H, N, N)
    y = torch.einsum("bhn,bhnm->bhm", r, state + p["u"][..., None] * kv)
    S_new = w[..., None] * state + kv
    out = _group_norm(y[:, None], p["ln_w"]).to(x.dtype) * g
    return out @ p["wo"], S_new


def rwkv_channel_mix(p: dict, x: torch.Tensor, x_prev: torch.Tensor, *,
                     mi: MeshInfo = NO_MESH, tp: bool = False
                     ) -> torch.Tensor:
    """sigmoid(xr wr) * (relu(xk wk)^2 wv); with ``tp`` the
    tensor-parallel form over ``mi``'s model axis (the module's
    docstring)."""
    dx = x_prev - x
    xk = x + dx * p["mu_k"]
    xr = x + dx * p["mu_r"]
    wr = p["wr"]
    if tp:
        xk = copy_to(xk, mi, "model")
        wr = gather_param(wr, placed((None, "model"), mi), mi, ("model",),
                          ())
    kk = torch.square(F.relu(xk @ p["wk"]))
    kv = kk @ p["wv"]
    if tp:
        kv = reduce_from(kv, mi, "model")
    return torch.sigmoid(xr @ wr) * kv


def token_shift(x: torch.Tensor, carry: torch.Tensor):
    """x: (B, T, d), carry: (B, d) last token of the previous segment.
    Returns (x_prev, new carry)."""
    x_prev = torch.cat([carry[:, None], x[:, :-1]], dim=1)
    return x_prev, x[:, -1]
