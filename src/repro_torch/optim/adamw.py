"""AdamW with fp32 master weights (port of ``repro/optim/adamw.py``).

State per parameter: master fp32 + mu fp32 + nu fp32, and the parameter in
its own dtype, taken from the master after every update. The reference's
step is pure and its launcher donates the state; here ``adamw_update``
updates master, mu and nu in place (one copy of 12 bytes a parameter
instead of two) and returns the same tensors. ``opt_state_specs`` (the
dry run's sharding metadata) waits for the multi-device slice.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.tree import leaves, tree_map


class OptState(NamedTuple):
    master: Any   # fp32 params
    mu: Any       # fp32 first moment
    nu: Any       # fp32 second moment
    count: torch.Tensor
    ef: Any = None   # int8-compression error-feedback buffers (optional)


def init_opt_state(params, with_ef: bool = False) -> OptState:
    """fp32 copies of ``params`` (never aliasing an fp32 parameter), zero
    moments, count 0 (int32, on the parameters' device)."""
    master = tree_map(lambda x: x.detach().to(torch.float32, copy=True),
                      params)
    zeros = lambda: tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                             params)
    dev = leaves(params)[0].device
    return OptState(master=master, mu=zeros(), nu=zeros(),
                    count=torch.zeros((), dtype=torch.int32, device=dev),
                    ef=zeros() if with_ef else None)


def lr_schedule(tc: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, on fp32 tensors in the reference's
    order of operations (Python floats would round otherwise)."""
    step = step.to(torch.float32)
    warm = tc.lr * step / max(tc.warmup_steps, 1)
    prog = torch.clamp((step - tc.warmup_steps)
                       / max(tc.total_steps - tc.warmup_steps, 1), 0.0, 1.0)
    cos = tc.lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < tc.warmup_steps, warm, cos)


def clip_by_global_norm(grads, max_norm: float):
    """(fp32 grads scaled to a global norm of at most ``max_norm``, the
    norm before): the squares summed a leaf at a time in leaf order."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), gnorm


def adamw_update(params, grads, state: OptState, tc: TrainConfig
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One step; ``grads`` fp32 (after the clip). Updates ``state``'s
    master, mu and nu in place; the new parameters are the master cast to
    each parameter's dtype."""
    count = state.count + 1
    lr = lr_schedule(tc, count)
    b1, b2 = tc.beta1, tc.beta2
    c1 = 1.0 - b1 ** count.to(torch.float32)
    c2 = 1.0 - b2 ** count.to(torch.float32)
    for m, g, mu, nu in zip(leaves(state.master), leaves(grads),
                            leaves(state.mu), leaves(state.nu)):
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * torch.square(g))
        step_ = (mu / c1) / (torch.sqrt(nu / c2) + tc.eps)
        m.sub_(lr * (step_ + tc.weight_decay * m))
    new_params = tree_map(lambda m, p: m.to(p.dtype), state.master, params)
    return (new_params, state._replace(count=count), {"lr": lr})
