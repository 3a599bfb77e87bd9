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

Each spec carries the reference's partition spec (``pspec``: a tuple of
logical names, ``"fsdp"``, ``"tp"``, ``"batch"`` or None, one a leading
dimension; the reference's stacked block leaves lead with one more None,
which a per-block leaf here does not have). ``logical_to_mesh`` and
``resolve_spec`` turn it into mesh axes as the reference's do, dropping an
axis that does not divide its dimension; ``shardings`` gives every leaf
its :class:`Sharding` on a mesh, and ``init_params`` and
``from_jax_params`` with a mesh give each rank only its block of every
leaf (the same values the whole tree holds there). ``abstract`` gives a
spec tree as meta tensors of a rank's local shapes, which allocate
nothing (the reference's ShapeDtypeStruct stand-ins).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.dist import NO_MESH, MeshInfo, axis_rank

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32}
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
    pspec: Tuple = ()               # logical names a leading dimension

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


# Logical axis names a spec uses, and the mesh axes ``logical_to_mesh``
# resolves them to: "fsdp" -> the data axis (parameters sharded over data;
# the batch shards over data too), "tp" -> the model axis.
LOGICAL_RULES_SINGLE = {"fsdp": "data", "tp": "model", "batch": ("data",)}


def logical_to_mesh(spec: Tuple, mesh_axes: Tuple[str, ...]) -> Tuple:
    """Resolve logical names to the mesh's axes. On the multi-pod mesh the
    batch shards over (pod, data) and fsdp stays on data (pods replicate
    the parameters)."""
    multi_pod = "pod" in mesh_axes
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif entry == "batch":
            out.append(("pod", "data") if multi_pod else "data")
        elif entry == "fsdp":
            out.append("data")
        elif entry == "tp":
            out.append("model")
        else:
            out.append(entry)
    return tuple(out)


def resolve_spec(spec: Tuple, shape, sizes: Mapping[str, int]) -> Tuple:
    """Resolve logical names against a mesh of axis ``sizes`` (axis -> size,
    in the mesh's order) and drop the axes that do not divide their
    dimension, innermost first: e.g. 8 KV heads on a model axis of 16 are
    replicated. One entry a dimension: None, an axis, or a tuple of axes."""
    resolved = logical_to_mesh(spec, tuple(sizes))
    out = []
    for i, dim in enumerate(shape):
        entry = resolved[i] if i < len(resolved) else None
        if entry is None:
            out.append(None)
            continue
        axes = list(entry) if isinstance(entry, tuple) else [entry]
        while axes:
            if dim % math.prod(sizes[a] for a in axes) == 0:
                break
            axes.pop()              # drop the innermost axis and retry
        out.append(tuple(axes) if len(axes) > 1 else
                   (axes[0] if axes else None))
    return tuple(out)


def split_axes(entry) -> Tuple[str, ...]:
    """The axes one entry of a resolved spec splits its dimension over."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True)
class Sharding:
    """A leaf's placement on a mesh (the reference's NamedSharding): its
    resolved spec, the mesh's axis sizes and this rank's coordinate on
    each axis. A leaf of the optimizer or parameter trees, never walked
    into by ``repro_torch.tree``."""
    spec: Tuple
    sizes: Tuple[Tuple[str, int], ...] = ()
    coords: Tuple[Tuple[str, int], ...] = ()

    def axes(self, dim: int) -> Tuple[str, ...]:
        return split_axes(self.spec[dim]) if dim < len(self.spec) else ()

    @property
    def split(self) -> Tuple[str, ...]:
        """Every axis the leaf is split over."""
        return tuple(a for i in range(len(self.spec)) for a in self.axes(i))

    def local_shape(self, shape) -> Tuple[int, ...]:
        sz = dict(self.sizes)
        return tuple(n // math.prod(sz[a] for a in self.axes(i))
                     for i, n in enumerate(shape))

    def cut(self, t):
        """This rank's block of the whole leaf ``t`` (a tensor or an
        array): each dimension in as many equal blocks as its axes' sizes
        multiply to, the block at the rank's coordinates (the first axis
        outermost). A view where ``t`` allows one."""
        sz, co = dict(self.sizes), dict(self.coords)
        for i in range(len(self.spec)):
            axes = self.axes(i)
            if not axes:
                continue
            n, idx = 1, 0
            for a in axes:
                n, idx = n * sz[a], idx * sz[a] + co[a]
            size = t.shape[i] // n
            index = (slice(None),) * i + (slice(idx * size,
                                                (idx + 1) * size),)
            t = t[index]
        return t


def mesh_sizes(mi: MeshInfo) -> Dict[str, int]:
    """{axis: size} of ``mi``'s mesh, in its order ({} without one)."""
    return {a: mi.size(a) for a in mi.axis_names}


def placed(spec: Tuple, mi: MeshInfo) -> Sharding:
    """A resolved ``spec`` (mesh axes) as this rank's :class:`Sharding` on
    ``mi``'s mesh."""
    sizes = mesh_sizes(mi)
    return Sharding(tuple(spec), tuple(sizes.items()),
                    tuple((a, axis_rank(mi, a)) for a in sizes))


def sharding_of(spec: Tuple, shape, mi: MeshInfo) -> Sharding:
    """The :class:`Sharding` of a leaf of ``shape`` and logical ``spec`` on
    ``mi``'s mesh, at this rank (whole without a mesh)."""
    if not mi.active:
        return Sharding((None,) * len(shape))
    return placed(resolve_spec(spec, shape, mesh_sizes(mi)), mi)


def shardings(specs, mi: MeshInfo):
    """A tree of ParamSpecs as a tree of each leaf's :class:`Sharding` on
    ``mi``'s mesh (the reference's ``shardings``)."""
    return _map(lambda s: sharding_of(s.pspec, s.shape, mi), specs)


def abstract(specs, mi: MeshInfo = NO_MESH, device="meta",
             cfg: Optional[ModelConfig] = None):
    """The reference's ``abstract``: a tree of ParamSpecs as tensors of
    this rank's local shapes (``Sharding.local_shape`` on ``mi``'s mesh;
    whole without one) and the specs' dtypes (``cfg.param_dtype`` where a
    spec names none), on ``device``: by default the meta device, which
    allocates nothing."""
    def mk(s: ParamSpec) -> torch.Tensor:
        if s.dtype is None and cfg is None:
            raise ValueError(f"a spec of shape {s.shape} names no dtype: "
                             f"pass cfg")
        dt = DTYPES[s.dtype] if s.dtype else DTYPES[cfg.param_dtype]
        shape = sharding_of(s.pspec, s.shape, mi).local_shape(s.shape)
        return torch.empty(shape, dtype=dt, device=device)
    return _map(mk, specs)


def residual(shape: Tuple[int, ...], damp: float,
             pspec: Tuple = ()) -> ParamSpec:
    """A residual-writing projection: its fan-in std times ``damp``."""
    return ParamSpec(shape, "normal", ParamSpec(shape).std() * damp,
                     pspec=pspec)


def norm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), "ones", pspec=(None,))


def glu_specs(d: int, ff: int, damp: float) -> Dict[str, ParamSpec]:
    return {"w_gate": ParamSpec((d, ff), pspec=("fsdp", "tp")),
            "w_up": ParamSpec((d, ff), pspec=("fsdp", "tp")),
            "w_down": residual((ff, d), damp, ("tp", "fsdp"))}


def _attention_specs(cfg: ModelConfig, damp: float,
                     cross: bool = False) -> Dict[str, ParamSpec]:
    """Self-attention's projections (QKV biases where ``cfg.qkv_bias``), or
    cross-attention's: no biases, and a scalar tanh ``gate`` from zero
    (llama-vision's gated cross-attention; seamless's carries it too)."""
    d, dh, hq, hkv = cfg.d_model, cfg.d_head, cfg.n_heads, cfg.n_kv_heads
    col = ("fsdp", "tp", None)
    out = {"wq": ParamSpec((d, hq, dh), pspec=col),
           "wk": ParamSpec((d, hkv, dh), pspec=col),
           "wv": ParamSpec((d, hkv, dh), pspec=col),
           "wo": residual((hq, dh, d), damp, ("tp", None, "fsdp"))}
    if cfg.qkv_bias and not cross:
        out["bq"] = ParamSpec((hq, dh), "zeros", pspec=("tp", None))
        out["bk"] = ParamSpec((hkv, dh), "zeros", pspec=("tp", None))
        out["bv"] = ParamSpec((hkv, dh), "zeros", pspec=("tp", None))
    if cross:
        out["gate"] = ParamSpec((), "zeros")
    return out


def _layer_specs(cfg: ModelConfig, kind: str, damp: float) -> Dict[str, Any]:
    if kind not in SERVED_KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported "
                                  f"(the port serves {SERVED_KINDS})")
    d = cfg.d_model
    out: Dict[str, Any] = {"ln1": norm_spec(d)}
    if kind == "rwkv":                 # no MLP: the channel mix is its FFN
        from repro_torch.models.rwkv6 import (rwkv_channel_mix_specs,
                                              rwkv_time_mix_specs)
        out["tm"] = rwkv_time_mix_specs(cfg, damp)
        out["ln2"] = norm_spec(d)
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
        out["lnx"] = norm_spec(d)
        out["xattn"] = _attention_specs(cfg, damp, cross=True)
    out["ln2"] = norm_spec(d)
    if kind in ("attn_moe", "mamba_moe"):
        from repro_torch.models.moe import moe_specs
        out["moe"] = moe_specs(cfg, damp)
    elif cfg.act == "relu":            # seamless's 2-layer MLP
        out["mlp"] = {"w1": ParamSpec((d, cfg.d_ff), pspec=("fsdp", "tp")),
                      "w2": residual((cfg.d_ff, d), damp, ("tp", "fsdp"))}
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
    embed = {"table": ParamSpec((cfg.vocab_size, cfg.d_model), "normal", 0.02,
                                pspec=("tp", "fsdp"))}
    if not cfg.tie_embeddings:
        embed["head"] = ParamSpec((cfg.d_model, cfg.vocab_size), "normal",
                                  0.02, pspec=("fsdp", "tp"))
    blocks = [{str(i): _layer_specs(cfg, kind, damp)
               for i, kind in enumerate(cfg.block_pattern)}
              for _ in range(cfg.n_blocks)]
    out = {"embed": embed, "final_ln": norm_spec(cfg.d_model),
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
            "final_ln": norm_spec(cfg.d_model)}
    return out


def _map(fn, tree):
    """``fn`` over the ParamSpecs of a tree of dicts, lists and NamedTuples
    (an OptState of spec trees), None holding none."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    return fn(tree)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", mi: MeshInfo = NO_MESH) -> Dict[str, Any]:
    """Random weights built directly on ``device`` from ``generator`` (which
    must live on that device). Same init rules as the JAX package; the
    numbers differ, since the generators differ. On a mesh (``mi``) each
    rank keeps its block of every leaf of the same whole tree (every rank
    draws the whole tree from the same generator state)."""
    params = materialize(model_specs(cfg), cfg, generator, device)
    return local_blocks(cfg, params, mi)


def local_blocks(cfg: ModelConfig, params, mi: MeshInfo = NO_MESH):
    """This rank's block of every leaf of a whole parameter tree (or of a
    tree of its structure) on ``mi``'s mesh, each a contiguous copy that
    holds its block alone (a block cut along the first dimension is a
    view, whose storage is the whole leaf's); the tree itself without a
    mesh."""
    if not mi.active:
        return params
    from repro_torch.tree import tree_map
    return tree_map(lambda t, sh: sh.cut(t).clone(
        memory_format=torch.contiguous_format), params,
        shardings(model_specs(cfg), mi))


def materialize(specs, cfg: ModelConfig, generator: torch.Generator,
                device="cuda"):
    """A tree of ParamSpecs as tensors on ``device``, drawn from
    ``generator`` in the tree's order. Each draw is scaled in place, so a
    leaf needs one float32 buffer beside its own: kimi-k2's expert leaves,
    (384, 7168, 2048), are 22.5 GB in float32."""
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
            return u.mul_(2).sub_(1).mul_(s.scale).to(dt)
        w = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return w.mul_(s.std()).to(dt)

    return _map(mk, specs)


def from_jax_params(cfg: ModelConfig, np_tree: Dict[str, Any],
                    device="cpu", mi: MeshInfo = NO_MESH) -> Dict[str, Any]:
    """Turn the numpy leaves of a JAX ``init_params`` tree into the port's
    parameters: stacked ``blocks`` leaves (leading ``(n_blocks,)`` axis),
    the decoder's and the encoder's, become one dict per block; ``first``
    is taken as it is. Shapes are checked against the port's specs, and
    each leaf takes its spec's dtype. On a mesh (``mi``) each rank keeps
    its block of every leaf."""
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

    return local_blocks(cfg, walk(specs, unstack_blocks(np_tree)), mi)


def stack_specs(specs) -> Dict[str, Any]:
    """The reference's layout of a spec tree: the decoder's and the
    encoder's per-block specs as one block's, each shape led by
    ``n_blocks`` and each spec by None (the reference's ``stack_specs``),
    for the shardings of a checkpoint in that layout."""
    def stack(blocks):
        n = len(blocks)
        return _map(lambda s: ParamSpec((n,) + tuple(s.shape), s.init,
                                        s.scale, s.dtype,
                                        (None,) + tuple(s.pspec)), blocks[0])
    out = {**specs, "blocks": stack(specs["blocks"])}
    if "encoder" in specs:
        out["encoder"] = {**specs["encoder"],
                          "blocks": stack(specs["encoder"]["blocks"])}
    return out


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
