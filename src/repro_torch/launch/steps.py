"""The train step (port of ``repro/launch/steps.py::make_train_step``):
the loss, its gradients and the AdamW update. ``make_step``, the dry run's
entry point, waits for the multi-device slice.

Parameters are plain tensors that each step replaces: the step takes
gradients with ``torch.autograd.grad`` over detached copies of the leaves
that ask for them, so no autograd state outlives it.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models.model import forward_train
from repro_torch.optim import (OptState, adamw_update, clip_by_global_norm)
from repro_torch.optim.compression import ef_compress
from repro_torch.tree import flatten, tree_map, unflatten


def loss_and_grads(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Any]:
    """(loss, grads): ``forward_train``'s loss and its gradient for every
    leaf of ``params``, in the leaf's dtype (a leaf the loss does not reach
    gets zeros, as ``jax.grad`` gives it)."""
    flat, treedef = flatten(params)
    live = [p.detach().requires_grad_(True) for p in flat]
    loss = forward_train(cfg, unflatten(treedef, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), unflatten(treedef, grads)


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {"loss", "grad_norm", "lr"}). With ``tc.microbatches`` > 1 the
    batch's rows are cut into that many equal microbatches in order, whose
    losses and gradients are summed in fp32 and divided by their count;
    with ``grad_compression="int8_ef"`` the gradients go through
    ``ef_compress`` before the clip. The optimizer state is updated in
    place (see ``optim/adamw.py``)."""

    def train_step(params, opt_state: OptState, batch):
        if tc.microbatches > 1:
            mb = tc.microbatches
            B = batch["tokens"].shape[0]
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                             params)
            for i in range(mb):
                part = {k: x.reshape(mb, B // mb, *x.shape[1:])[i]
                        for k, x in batch.items()}
                l_i, g_i = loss_and_grads(cfg, params, part)
                loss = loss + l_i
                grads = tree_map(torch.add, grads, g_i)
            loss = loss / mb
            grads = tree_map(lambda g: g / mb, grads)
        else:
            loss, grads = loss_and_grads(cfg, params, batch)

        if tc.grad_compression == "int8_ef":
            grads, new_ef = ef_compress(grads, opt_state.ef)
            opt_state = opt_state._replace(ef=new_ef)

        grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
        params, opt_state, extras = adamw_update(params, grads, opt_state, tc)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, **extras}

    return train_step
