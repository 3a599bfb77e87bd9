"""Step builders (port of ``repro/launch/steps.py``): ``make_train_step``
(the loss, its gradients and the AdamW update), ``make_prefill_step`` and
``make_decode_step`` (the serve steps), each on one device or on a mesh,
and ``make_step``, the dry run's entry point: a cell's step and the specs
of its state.

Parameters are plain tensors that each train step replaces: the step takes
gradients with ``torch.autograd.grad`` over detached copies of the leaves
that ask for them, so no autograd state outlives it.

On a mesh the serve steps are the function the reference lowers there:
``params`` are the rank's blocks (``init_params(..., mi=)``), the cache
the rank's blocks of ``model.cache_specs`` (``init_cache(..., mi=,
placed=True)``, at the step's ``page_size``), the batch or token global;
each rank returns its rows (``model.forward_prefill`` with ``placed``).
The dense kinds only (``model.mesh_serve_refusal``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.models.dist import NO_MESH, MeshInfo
from repro_torch.models.layers import vocab_parallel_argmax
from repro_torch.models.model import (DEFAULT_PAGE_SIZE, batch_sharding,
                                      check_mesh_servable,
                                      check_mesh_trainable, forward_decode,
                                      forward_prefill, forward_train,
                                      placed_decode)
from repro_torch.models.params import model_specs, shardings
from repro_torch.optim import (OptState, adamw_update, clip_by_global_norm,
                               opt_state_specs)
from repro_torch.optim.compression import ef_compress
from repro_torch.tree import flatten, tree_map, unflatten


def loss_and_grads(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
                   mi: MeshInfo = NO_MESH) -> Tuple[torch.Tensor, Any]:
    """(loss, grads): ``forward_train``'s loss and its gradient for every
    leaf of ``params``, in the leaf's dtype (a leaf the loss does not reach
    gets zeros, as ``jax.grad`` gives it). On a mesh, the global batch's
    loss and this rank's blocks of its gradient."""
    flat, treedef = flatten(params)
    live = [p.detach().requires_grad_(True) for p in flat]
    loss = forward_train(cfg, unflatten(treedef, live), batch, mi)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), unflatten(treedef, grads)


def microbatch(batch: Dict[str, torch.Tensor], i: int, mb: int,
               mi: MeshInfo = NO_MESH) -> Dict[str, torch.Tensor]:
    """Microbatch ``i`` of ``mb``: without a mesh rows [i B/mb, (i+1)
    B/mb), the reference's ``reshape(mb, B/mb)``; on a mesh, where the
    rows split over n ranks, the i-th of ``mb`` equal parts of each
    rank's rows, so every rank's microbatch is its own rows (the same
    rows summed in another order than the reference's)."""
    B = batch["tokens"].shape[0]
    n = 1
    if mi.active:
        sh = batch_sharding((B // mb,), mi)
        for a in sh.axes(0):
            n *= mi.size(a)
    return {k: x.reshape(n, mb, B // (n * mb), *x.shape[1:])[:, i]
            .reshape(B // mb, *x.shape[1:]) for k, x in batch.items()}


def make_train_step(cfg: ModelConfig, tc: TrainConfig,
                    mi: MeshInfo = NO_MESH):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {"loss", "grad_norm", "lr"}). With ``tc.microbatches`` > 1 the
    batch's rows are cut into that many equal microbatches
    (:func:`microbatch`), whose losses and gradients are summed in fp32
    and divided by their count; with ``grad_compression="int8_ef"`` the
    gradients go through ``ef_compress`` before the clip. The optimizer
    state is updated in place (see ``optim/adamw.py``).

    On a mesh (a model axis that does not split the arch's widths raises
    ``NotImplementedError``, ``mesh_train_refusal``) ``params`` and
    ``opt_state`` are this rank's blocks (``params.shardings``, ``init_opt_state`` of the blocks) and
    ``batch`` the global batch; the gradients are the rank's blocks of
    the global batch's, the global norm and ``ef_compress``'s per-leaf
    scales see every element once, and AdamW updates the blocks."""
    check_mesh_trainable(cfg, mi)
    shards = shardings(model_specs(cfg), mi) if mi.active else None

    def train_step(params, opt_state: OptState, batch):
        if tc.microbatches > 1:
            mb = tc.microbatches
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                             params)
            for i in range(mb):
                l_i, g_i = loss_and_grads(cfg, params,
                                          microbatch(batch, i, mb, mi), mi)
                loss = loss + l_i
                grads = tree_map(torch.add, grads, g_i)
            loss = loss / mb
            grads = tree_map(lambda g: g / mb, grads)
        else:
            loss, grads = loss_and_grads(cfg, params, batch, mi)

        if tc.grad_compression == "int8_ef":
            grads, new_ef = ef_compress(grads, opt_state.ef, mi, shards)
            opt_state = opt_state._replace(ef=new_ef)

        grads, gnorm = clip_by_global_norm(grads, tc.grad_clip, mi, shards)
        params, opt_state, extras = adamw_update(params, grads, opt_state, tc)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, **extras}

    return train_step


def make_prefill_step(cfg: ModelConfig, mi: MeshInfo = NO_MESH,
                      page_size: int = DEFAULT_PAGE_SIZE):
    """Returns prefill_step(params, batch, cache) -> (last_logits, cache)
    (``forward_prefill``; on a mesh with placed weights and cache, at
    ``page_size``, the global batch in and the rank's rows out). A kind
    without a serving form on a mesh refuses here."""
    check_mesh_servable(cfg, mi)

    @torch.no_grad()
    def prefill_step(params, batch, cache):
        return forward_prefill(cfg, params, batch, cache, mi,
                               placed=mi.active, page_size=page_size)
    return prefill_step


def make_decode_step(cfg: ModelConfig, mi: MeshInfo = NO_MESH,
                     sample: bool = False,
                     page_size: int = DEFAULT_PAGE_SIZE):
    """Returns serve_step(params, token, pos, cache) -> (logits, cache), or
    with ``sample`` (next_token (B,) int32, cache): the greedy token over
    the whole vocab, on the device. On a mesh as ``make_prefill_step``;
    where the embedding is vocab-parallel the argmax takes each rank's
    block's largest logit and one all-reduce MAX and one MIN over
    ``model`` (``layers.vocab_parallel_argmax``), not the whole logits."""
    check_mesh_servable(cfg, mi)

    @torch.no_grad()
    def serve_step(params, token, pos, cache):
        if not sample:
            return forward_decode(cfg, params, token, pos, cache, mi,
                                  placed=mi.active, page_size=page_size)
        if mi.active:
            logits, vocab_mi, cache = placed_decode(cfg, params, token, pos,
                                                    cache, mi, page_size)
        else:
            (logits, cache), vocab_mi = forward_decode(
                cfg, params, token, pos, cache), None
        tok = (torch.argmax(logits, -1) if vocab_mi is None
               else vocab_parallel_argmax(logits, vocab_mi))
        return tok.to(torch.int32), cache
    return serve_step


def make_step(cfg: ModelConfig, shape: ShapeConfig, mi: MeshInfo = NO_MESH,
              tc: Optional[TrainConfig] = None):
    """The dry run's entry: (the cell's step, the specs of its state that
    is not an input): ``{"params", "opt_state"}`` for a train cell,
    ``{"params"}`` for a serve cell (its inputs are
    ``launch/input_specs.py``'s)."""
    tc = tc or TrainConfig()
    pspecs = model_specs(cfg)
    if shape.kind == "train":
        return make_train_step(cfg, tc, mi), {
            "params": pspecs,
            "opt_state": opt_state_specs(
                pspecs, with_ef=tc.grad_compression == "int8_ef")}
    if shape.kind == "prefill":
        return make_prefill_step(cfg, mi), {"params": pspecs}
    return make_decode_step(cfg, mi), {"params": pspecs}
