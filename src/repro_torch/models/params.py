"""Parameter specs and initialization for the port (no JAX dtypes).

A spec walk over the same tree the JAX package builds
(``repro/models/params.py``, ``layers.py``, ``attention.py``, ``rwkv6.py``,
``mamba.py``, ``model.py::model_specs``): the same shapes, the same
initializers (``normal * fan_in**-0.5`` with ``fan_in = shape[-2]``,
``uniform_pm``: uniform in +-scale, ``ones``, ``zeros``), the 0.02
embedding scale and the 1/sqrt(2L) residual damping of the reference's
``_residual_init_damping`` (every ``wo``, ``w_down``, ``w2`` and
``out_proj``: attention's and cross-attention's, rwkv time-mix's, an MoE
layer's experts' and shared expert's, the 2-layer MLP's, mamba's; the
encoder's at the decoder's depth too). Every leaf takes ``cfg.param_dtype`` but where its
spec names a dtype: an MoE router, rwkv's decay (``w0``, ``w_lora_b``),
bonus (``u``) and group-norm weight, and mamba's ``A_log``, ``dt_bias``
and ``D`` are float32 whatever the parameters' dtype, as the reference's.
The port keeps its blocks as a list of per-block dicts instead of one
stacked tree (and ``first_k_dense`` dense layers under ``"first"``, and an
encoder-decoder's encoder under ``"encoder"``, as the reference);
``from_jax_params`` converts a JAX parameter tree (as numpy
leaves) into that form.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# attn_mlp_local (a sliding-window layer) and jamba's attn have the same
# leaves as attn_mlp; attn_moe has the same attention and an MoE FFN
# (models/moe.py); rwkv a time mix and a channel mix (models/rwkv6.py);
# mamba and mamba_moe mamba's selective SSM (models/mamba.py) before a GLU
# MLP or an MoE FFN; xattn_mlp a gated cross-attention over image
# embeddings in place of self-attention, cross_mlp self-attention then
# cross-attention over the encoder's output.
SERVED_KINDS = ("attn_mlp", "attn_mlp_local", "attn_moe", "attn", "rwkv",
                "mamba", "mamba_moe", "xattn_mlp", "cross_mlp")
MAMBA_KINDS = ("mamba", "mamba_moe")
# layers that keep a per-slot state (scanned left to right) instead of KV
RECURRENT_KINDS = MAMBA_KINDS + ("rwkv",)


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"            # normal | zeros | ones | uniform_pm
    scale: Optional[float] = None   # normal: None -> 1/sqrt(fan_in);
                                    # uniform_pm: the half-width
    dtype: Optional[str] = None     # None -> cfg.param_dtype

    def fan_in(self) -> int:
        if len(self.shape) <= 1:
            return max(self.shape[-1] if self.shape else 1, 1)
        return self.shape[-2]

    def std(self) -> float:
        return self.scale if self.scale is not None else self.fan_in() ** -0.5

    def torch_dtype(self, cfg: ModelConfig) -> torch.dtype:
        return DTYPES[self.dtype or cfg.param_dtype]


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def residual(shape: Tuple[int, ...], damp: float) -> ParamSpec:
    """A residual-writing projection: its fan-in std times ``damp``."""
    return ParamSpec(shape, "normal", ParamSpec(shape).std() * damp)


def glu_specs(d: int, ff: int, damp: float) -> Dict[str, ParamSpec]:
    return {"w_gate": ParamSpec((d, ff)), "w_up": ParamSpec((d, ff)),
            "w_down": residual((ff, d), damp)}


def _attention_specs(cfg: ModelConfig, damp: float,
                     cross: bool = False) -> Dict[str, ParamSpec]:
    """Self-attention's projections (QKV biases where ``cfg.qkv_bias``), or
    cross-attention's: no biases, and a scalar tanh ``gate`` from zero
    (llama-vision's gated cross-attention; seamless's carries it too)."""
    d, dh, hq, hkv = cfg.d_model, cfg.d_head, cfg.n_heads, cfg.n_kv_heads
    out = {"wq": ParamSpec((d, hq, dh)), "wk": ParamSpec((d, hkv, dh)),
           "wv": ParamSpec((d, hkv, dh)), "wo": residual((hq, dh, d), damp)}
    if cfg.qkv_bias and not cross:
        out["bq"] = ParamSpec((hq, dh), "zeros")
        out["bk"] = ParamSpec((hkv, dh), "zeros")
        out["bv"] = ParamSpec((hkv, dh), "zeros")
    if cross:
        out["gate"] = ParamSpec((), "zeros")
    return out


def _layer_specs(cfg: ModelConfig, kind: str, damp: float) -> Dict[str, Any]:
    if kind not in SERVED_KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported "
                                  f"(the port serves {SERVED_KINDS})")
    d = cfg.d_model
    out: Dict[str, Any] = {"ln1": ParamSpec((d,), "ones")}
    if kind == "rwkv":                 # no MLP: the channel mix is its FFN
        from repro_torch.models.rwkv6 import (rwkv_channel_mix_specs,
                                              rwkv_time_mix_specs)
        out["tm"] = rwkv_time_mix_specs(cfg, damp)
        out["ln2"] = ParamSpec((d,), "ones")
        out["cm"] = rwkv_channel_mix_specs(cfg)
        return out
    if kind in MAMBA_KINDS:
        from repro_torch.models.mamba import mamba_specs
        out["mamba"] = mamba_specs(cfg, damp)
    elif kind == "xattn_mlp":
        out["xattn"] = _attention_specs(cfg, damp, cross=True)
    else:
        out["attn"] = _attention_specs(cfg, damp)
    if kind == "cross_mlp":
        out["lnx"] = ParamSpec((d,), "ones")
        out["xattn"] = _attention_specs(cfg, damp, cross=True)
    out["ln2"] = ParamSpec((d,), "ones")
    if kind in ("attn_moe", "mamba_moe"):
        from repro_torch.models.moe import moe_specs
        out["moe"] = moe_specs(cfg, damp)
    elif cfg.act == "relu":            # seamless's 2-layer MLP
        out["mlp"] = {"w1": ParamSpec((d, cfg.d_ff)),
                      "w2": residual((cfg.d_ff, d), damp)}
    else:
        out["mlp"] = glu_specs(d, cfg.d_ff, damp)
    return out


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """{"embed": {"table"[, "head"]}, "final_ln", ["first": {"0": dense
    layer, ...},] "blocks": [per-block {"0": layer, ...}][, "encoder":
    {"blocks": [per-block {"0": layer, ...}], "final_ln"}]} of ParamSpecs.
    The encoder's residual projections are damped at the decoder's depth,
    as the reference damps the whole tree."""
    damp = 1.0 / math.sqrt(2.0 * max(cfg.n_layers, 1))
    embed = {"table": ParamSpec((cfg.vocab_size, cfg.d_model), "normal", 0.02)}
    if not cfg.tie_embeddings:
        embed["head"] = ParamSpec((cfg.d_model, cfg.vocab_size), "normal", 0.02)
    blocks = [{str(i): _layer_specs(cfg, kind, damp)
               for i, kind in enumerate(cfg.block_pattern)}
              for _ in range(cfg.n_blocks)]
    out = {"embed": embed, "final_ln": ParamSpec((cfg.d_model,), "ones"),
           "blocks": blocks}
    if cfg.first_k_dense:
        out["first"] = {str(i): _layer_specs(cfg, "attn_mlp", damp)
                        for i in range(cfg.first_k_dense)}
    if cfg.is_encdec:
        n_enc = cfg.n_enc_layers // len(cfg.enc_block_pattern)
        out["encoder"] = {
            "blocks": [{str(i): _layer_specs(cfg, kind, damp)
                        for i, kind in enumerate(cfg.enc_block_pattern)}
                       for _ in range(n_enc)],
            "final_ln": ParamSpec((cfg.d_model,), "ones")}
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Dict[str, Any]:
    """Random weights built directly on ``device`` from ``generator`` (which
    must live on that device). Same init rules as the JAX package; the
    numbers differ, since the generators differ."""
    return materialize(model_specs(cfg), cfg, generator, device)


def materialize(specs, cfg: ModelConfig, generator: torch.Generator,
                device="cuda"):
    """A tree of ParamSpecs as tensors on ``device``, drawn from
    ``generator`` in the tree's order."""
    dev = resolve_device(device)

    def mk(s: ParamSpec) -> torch.Tensor:
        dt = s.torch_dtype(cfg)
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=dev)
        if s.init == "uniform_pm":
            u = torch.rand(s.shape, generator=generator, dtype=torch.float32,
                           device=dev)
            return ((u * 2 - 1) * s.scale).to(dt)
        w = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (w * s.std()).to(dt)

    return _map(mk, specs)


def from_jax_params(cfg: ModelConfig, np_tree: Dict[str, Any],
                    device="cpu") -> Dict[str, Any]:
    """Turn the numpy leaves of a JAX ``init_params`` tree into the port's
    parameters: stacked ``blocks`` leaves (leading ``(n_blocks,)`` axis),
    the decoder's and the encoder's, become one dict per block; ``first``
    is taken as it is. Shapes are checked against the port's specs, and
    each leaf takes its spec's dtype."""
    dev = resolve_device(device)
    specs = model_specs(cfg)

    def leaf(spec: ParamSpec, arr) -> torch.Tensor:
        a = np.asarray(arr)
        if tuple(a.shape) != tuple(spec.shape):
            raise ValueError(f"shape {a.shape} != spec {spec.shape}")
        # a float32 copy: JAX hands out read-only buffers, and ml_dtypes'
        # bfloat16 has no torch counterpart in numpy
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=dev, dtype=spec.torch_dtype(cfg))

    def walk(spec, arr):
        if isinstance(spec, dict):
            if set(spec) != set(arr):
                raise ValueError(f"keys {sorted(arr)} != {sorted(spec)}")
            return {k: walk(spec[k], arr[k]) for k in spec}
        if isinstance(spec, list):
            if len(spec) != len(arr):
                raise ValueError(f"{len(arr)} blocks != {len(spec)}")
            return [walk(s_, a) for s_, a in zip(spec, arr)]
        return leaf(spec, arr)

    return walk(specs, unstack_blocks(np_tree))


def stack_blocks(params) -> Dict[str, Any]:
    """The reference's layout of a parameter tree (or of any tree of its
    structure, an optimizer moment's): the decoder's and the encoder's
    per-block dicts stacked into one dict whose leaves lead with
    ``(n_blocks,)``. Copies; ``unstack_blocks`` undoes it."""
    from repro_torch.tree import tree_map
    stack = lambda blocks: tree_map(lambda *xs: torch.stack(xs), *blocks)
    out = {**params, "blocks": stack(params["blocks"])}
    if "encoder" in params:
        out["encoder"] = {**params["encoder"],
                          "blocks": stack(params["encoder"]["blocks"])}
    return out


def unstack_blocks(tree) -> Dict[str, Any]:
    """The port's layout of a tree in the reference's: one dict per block
    (views of the stacked leaves)."""
    from repro_torch.tree import leaves, tree_map

    def unstack(stacked):
        n = leaves(stacked)[0].shape[0]
        return [tree_map(lambda a, b=b: a[b], stacked) for b in range(n)]

    out = {**tree, "blocks": unstack(tree["blocks"])}
    if "encoder" in tree:
        out["encoder"] = {**tree["encoder"],
                          "blocks": unstack(tree["encoder"]["blocks"])}
    return out


def count_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(count_params(v) for v in tree)
    return tree.numel()
