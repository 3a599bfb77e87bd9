"""AdamW with fp32 master weights (port of ``repro/optim/adamw.py``).

State per parameter: master fp32 + mu fp32 + nu fp32, and the parameter in
its own dtype, taken from the master after every update. The reference's
step is pure and its launcher donates the state; here ``adamw_update``
updates master, mu and nu in place (one copy of 12 bytes a parameter
instead of two) and returns the same tensors.

On a mesh the state inherits the parameters' shardings
(``opt_state_specs``: master, mu, nu and ef take each parameter's spec in
fp32), so ``init_opt_state`` of a rank's parameter blocks is the rank's
blocks of the state: ZeRO's memory falls out of the specs, as in the
reference. ``clip_by_global_norm`` then sums each leaf's squares over the
ranks it is split across, once.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.dist import NO_MESH, MeshInfo, all_reduce
from repro_torch.tree import leaves, tree_map


class OptState(NamedTuple):
    master: Any   # fp32 params
    mu: Any       # fp32 first moment
    nu: Any       # fp32 second moment
    count: torch.Tensor
    ef: Any = None   # int8-compression error-feedback buffers (optional)


def init_opt_state(params, with_ef: bool = False) -> OptState:
    """fp32 copies of ``params`` (never aliasing an fp32 parameter), zero
    moments, count 0 (int32, on the parameters' device). Of a rank's
    parameter blocks, the rank's blocks of the state."""
    master = tree_map(lambda x: x.detach().to(torch.float32, copy=True),
                      params)
    zeros = lambda: tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                             params)
    dev = leaves(params)[0].device
    return OptState(master=master, mu=zeros(), nu=zeros(),
                    count=torch.zeros((), dtype=torch.int32, device=dev),
                    ef=zeros() if with_ef else None)


def opt_state_specs(param_specs, with_ef: bool = False) -> OptState:
    """The state's ParamSpecs, mirroring the parameters' shardings:
    master, mu, nu (and ef) fp32 zeros at each parameter's shape and
    spec, the count a whole int32 scalar."""
    from repro_torch.models.params import ParamSpec, _map
    f32 = lambda: _map(lambda s: ParamSpec(s.shape, "zeros", dtype="float32",
                                           pspec=s.pspec), param_specs)
    return OptState(master=f32(), mu=f32(), nu=f32(),
                    count=ParamSpec((), "zeros", dtype="int32"),
                    ef=f32() if with_ef else None)


def lr_schedule(tc: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, on fp32 tensors in the reference's
    order of operations (Python floats would round otherwise)."""
    step = step.to(torch.float32)
    warm = tc.lr * step / max(tc.warmup_steps, 1)
    prog = torch.clamp((step - tc.warmup_steps)
                       / max(tc.total_steps - tc.warmup_steps, 1), 0.0, 1.0)
    cos = tc.lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < tc.warmup_steps, warm, cos)


def clip_by_global_norm(grads, max_norm: float, mi: MeshInfo = NO_MESH,
                        shards=None):
    """(fp32 grads scaled to a global norm of at most ``max_norm``, the
    norm before): the squares summed a leaf at a time in leaf order. On a
    mesh ``grads`` are this rank's blocks, placed by the Shardings
    ``shards``: the leaves split over the same axes sum their squares
    together, and each such sum is summed over those axes alone, so a
    block held whole by several ranks counts once."""
    sq = [torch.sum(torch.square(g.to(torch.float32))) for g in leaves(grads)]
    if mi.active:
        by_axes = {}
        for s_, sh in zip(sq, leaves(shards)):
            axes = tuple(a for a in sh.split if mi.size(a) > 1)
            by_axes[axes] = by_axes[axes] + s_ if axes in by_axes else s_
        sq = [all_reduce(t, mi, axes) for axes, t in by_axes.items()]
    gnorm = torch.sqrt(sum(sq))
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
