"""Stand-ins for every model input of every dry-run cell (port of
``repro/launch/input_specs.py``): meta tensors of one rank's local
shapes, which allocate nothing, each beside its leaf's
:class:`~repro_torch.models.params.Sharding`.

Each function returns ``(tensors, shardings)``, two trees of one
structure: ``input_specs`` gives the keyword inputs of the cell's step
(``launch/steps.py::make_step``) after its state, ``{"batch"}`` for a
train cell, ``{"batch", "cache"}`` for a prefill cell and ``{"token",
"pos", "cache"}`` for a decode cell. ``mi`` may be a mesh the process
has not joined (``launch/mesh.py::abstract_mesh``): only its axes, their
sizes and this rank's coordinates are read.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.dist import NO_MESH, MeshInfo
from repro_torch.models.model import (DEFAULT_PAGE_SIZE, ENCDEC_SRC_LEN,
                                      cache_specs)
from repro_torch.models.params import ParamSpec, abstract, shardings


def _pair(specs, mi: MeshInfo) -> Tuple[Any, Any]:
    return abstract(specs, mi), shardings(specs, mi)


def _batch_spec_tree(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The ParamSpecs of a train or prefill batch: tokens (and labels in
    training) (B, S) int32, and ``enc_x`` (B, src, d) (src S in training,
    ``ENCDEC_SRC_LEN`` in a prefill) or ``img_x`` (B, n_image_tokens, d)
    in the activation dtype, rows over the batch axes."""
    B, S, act = shape.global_batch, shape.seq_len, cfg.activation_dtype
    tok = lambda: ParamSpec((B, S), "zeros", dtype="int32",
                            pspec=("batch", None))
    out = {"tokens": tok()}
    if shape.kind == "train":
        out["labels"] = tok()
    if cfg.is_encdec:
        src = S if shape.kind == "train" else ENCDEC_SRC_LEN
        out["enc_x"] = ParamSpec((B, src, cfg.d_model), "zeros", dtype=act,
                                 pspec=("batch", None, None))
    elif cfg.n_image_tokens:
        out["img_x"] = ParamSpec((B, cfg.n_image_tokens, cfg.d_model),
                                 "zeros", dtype=act,
                                 pspec=("batch", None, None))
    return out


def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                mi: MeshInfo = NO_MESH) -> Tuple[Dict, Dict]:
    """Training / prefill batch inputs."""
    return _pair(_batch_spec_tree(cfg, shape), mi)


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, mi: MeshInfo = NO_MESH,
                 page_size: int = DEFAULT_PAGE_SIZE) -> Tuple[Dict, Dict]:
    """Decode-step inputs: one new token (B, 1) a row, the position (a
    scalar) and the per-slot cache at length ``seq_len``."""
    B = shape.global_batch
    specs = {"token": ParamSpec((B, 1), "zeros", dtype="int32",
                                pspec=("batch", None)),
             "pos": ParamSpec((), "zeros", dtype="int32"),
             "cache": cache_specs(cfg, B, shape.seq_len, page_size,
                                  ENCDEC_SRC_LEN)}
    return _pair(specs, mi)


def prefill_cache_specs(cfg: ModelConfig, shape: ShapeConfig,
                        mi: MeshInfo = NO_MESH,
                        page_size: int = DEFAULT_PAGE_SIZE) -> Tuple[list, list]:
    """A prefill cell's cache: ``seq_len`` tokens a row."""
    return _pair(cache_specs(cfg, shape.global_batch, shape.seq_len,
                             page_size, ENCDEC_SRC_LEN), mi)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mi: MeshInfo = NO_MESH
                ) -> Tuple[Dict, Dict]:
    """All inputs for the cell's step function (see steps.make_step)."""
    if shape.kind == "train":
        t, s = batch_specs(cfg, shape, mi)
        return {"batch": t}, {"batch": s}
    if shape.kind == "prefill":
        bt, bs = batch_specs(cfg, shape, mi)
        ct, cs = prefill_cache_specs(cfg, shape, mi)
        return {"batch": bt, "cache": ct}, {"batch": bs, "cache": cs}
    return decode_specs(cfg, shape, mi)
