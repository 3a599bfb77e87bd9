"""Parameter specs and initialization for the port (no JAX dtypes).

A spec walk over the same tree the JAX package builds
(``repro/models/params.py``, ``layers.py``, ``attention.py``,
``model.py::model_specs``): the same shapes, the same initializers
(``normal * fan_in**-0.5`` with ``fan_in = shape[-2]``, ``ones``, ``zeros``),
the 0.02 embedding scale and the 1/sqrt(2L) residual damping of ``wo`` and
``w_down``. The port keeps its blocks as a list of per-block dicts instead
of one stacked tree; ``from_jax_params`` converts a JAX parameter tree
(as numpy leaves) into that form.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SERVED_KINDS = ("attn_mlp",)


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"            # normal | zeros | ones
    scale: Optional[float] = None   # None -> 1/sqrt(fan_in)

    def fan_in(self) -> int:
        if len(self.shape) <= 1:
            return max(self.shape[-1] if self.shape else 1, 1)
        return self.shape[-2]

    def std(self) -> float:
        return self.scale if self.scale is not None else self.fan_in() ** -0.5


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def _layer_specs(cfg: ModelConfig, kind: str, damp: float) -> Dict[str, Any]:
    if kind not in SERVED_KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported "
                                  f"(the port serves {SERVED_KINDS})")
    d, dh, hq, hkv = cfg.d_model, cfg.d_head, cfg.n_heads, cfg.n_kv_heads

    def residual(shape):
        return ParamSpec(shape, "normal", ParamSpec(shape).std() * damp)

    attn = {"wq": ParamSpec((d, hq, dh)), "wk": ParamSpec((d, hkv, dh)),
            "wv": ParamSpec((d, hkv, dh)), "wo": residual((hq, dh, d))}
    if cfg.qkv_bias:
        attn["bq"] = ParamSpec((hq, dh), "zeros")
        attn["bk"] = ParamSpec((hkv, dh), "zeros")
        attn["bv"] = ParamSpec((hkv, dh), "zeros")
    if cfg.act == "relu":
        raise NotImplementedError("the 2-layer relu MLP is not ported")
    return {"ln1": ParamSpec((d,), "ones"), "attn": attn,
            "ln2": ParamSpec((d,), "ones"),
            "mlp": {"w_gate": ParamSpec((d, cfg.d_ff)),
                    "w_up": ParamSpec((d, cfg.d_ff)),
                    "w_down": residual((cfg.d_ff, d))}}


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """{"embed": {"table"[, "head"]}, "final_ln", "blocks": [per-block
    {"0": layer, ...}]} of ParamSpecs."""
    if cfg.first_k_dense or cfg.is_encdec or cfg.n_image_tokens \
            or cfg.moe is not None or cfg.ssm is not None:
        raise NotImplementedError(f"{cfg.name}: only dense attn_mlp decoders "
                                  "are ported")
    damp = 1.0 / math.sqrt(2.0 * max(cfg.n_layers, 1))
    embed = {"table": ParamSpec((cfg.vocab_size, cfg.d_model), "normal", 0.02)}
    if not cfg.tie_embeddings:
        embed["head"] = ParamSpec((cfg.d_model, cfg.vocab_size), "normal", 0.02)
    blocks = [{str(i): _layer_specs(cfg, kind, damp)
               for i, kind in enumerate(cfg.block_pattern)}
              for _ in range(cfg.n_blocks)]
    return {"embed": embed, "final_ln": ParamSpec((cfg.d_model,), "ones"),
            "blocks": blocks}


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
    dev = resolve_device(device)
    dt = torch_dtype(cfg.param_dtype)

    def mk(s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=dev)
        w = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (w * s.std()).to(dt)

    return _map(mk, model_specs(cfg))


def from_jax_params(cfg: ModelConfig, np_tree: Dict[str, Any],
                    device="cpu") -> Dict[str, Any]:
    """Turn the numpy leaves of a JAX ``init_params`` tree into the port's
    parameters: stacked ``blocks`` leaves (leading ``(n_blocks,)`` axis)
    become one dict per block. Shapes are checked against the port's specs."""
    dev = resolve_device(device)
    specs = model_specs(cfg)

    def leaf(spec: ParamSpec, arr) -> torch.Tensor:
        a = np.asarray(arr)
        if tuple(a.shape) != tuple(spec.shape):
            raise ValueError(f"shape {a.shape} != spec {spec.shape}")
        # a float32 copy: JAX hands out read-only buffers, and ml_dtypes'
        # bfloat16 has no torch counterpart in numpy
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=dev, dtype=torch_dtype(cfg.param_dtype))

    def walk(spec, arr):
        if isinstance(spec, dict):
            if set(spec) != set(arr):
                raise ValueError(f"keys {sorted(arr)} != {sorted(spec)}")
            return {k: walk(spec[k], arr[k]) for k in spec}
        return leaf(spec, arr)

    blocks = [walk(spec, _map(lambda a, b=b: a[b], np_tree["blocks"]))
              for b, spec in enumerate(specs["blocks"])]
    return {"embed": walk(specs["embed"], np_tree["embed"]),
            "final_ln": leaf(specs["final_ln"], np_tree["final_ln"]),
            "blocks": blocks}


def count_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(count_params(v) for v in tree)
    return tree.numel()
