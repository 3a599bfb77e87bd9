"""GPipe-style pipeline parallelism over a ``stage`` mesh axis (port of
``repro/launch/pipeline.py``).

The block stack (n_blocks, ...) is split over stages, each rank holding its
stage's n_blocks / n_stages blocks; microbatches flow stage to stage. The
schedule is the reference's fill-drain: T = n_micro + n_stages - 1 ticks,
bubble fraction (n_stages - 1) / T. At tick t stage 0 takes microbatch t,
every stage applies its blocks to what it holds, the last stage records
microbatch t - (n_stages - 1), and each stage hands its result to the next
(``_Shift``, the reference's ``ppermute``; stage 0 receives zeros). The
last stage's outputs are summed over the stage group (``reduce_from``, the
reference's ``psum``), so every rank returns them whole.

Backward is autograd through the loop, each tick's activations stashed, as
``jax.grad`` through the reference's ``fori_loop``: ``_Shift``'s backward
sends the gradient back the other way (``ppermute``'s transpose), and
``x_micro`` enters through ``copy_to``, so its gradient (stage 0's) is
summed over the stage group and whole on every rank. Every rank must call
backward on a loss of the output, as every rank of the reference's global
program does.

Every rank builds every tick's shift node, so the sends and receives of
the backward pair up across ranks: the injection and the recording are
``torch.where`` selections, as the reference's ``jnp.where``, which keep
a stage's unused inputs in the graph (with zero gradient), and each shift
also takes a zero-size anchor that needs a gradient, so its output needs
one on every rank even where this rank's input does not (parameters that
need none, ``x_micro`` that does). The last tick's shift, whose output the
reference discards, is not made.

Sends go to the next stage's rank and receives come from the previous
one's, both issued before either is waited on. Where the stage group's
backend is gloo and the tensor lies on a CUDA device, it is staged through
host memory: gloo's send and receive read a tensor's storage as host
memory. NCCL takes the CUDA tensor itself. Nothing is probed: the choice
follows the group's backend and the tensor's device.

This is an optional execution mode; nothing else in the reference calls
it. Importing this module touches no device and no process group.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models.dist import (MeshInfo, axis_group, axis_rank,
                                     copy_to, reduce_from)


def _exchange(send, dst, recv_like, src, group):
    """Send ``send`` to the stage at group rank ``dst`` and receive a tensor
    like ``recv_like`` from the one at ``src`` (either may be None: no
    such stage), both at once. Returns the received tensor, or zeros."""
    import torch.distributed as dist
    staged = (dist.get_backend(group) == "gloo"
              and recv_like.device.type == "cuda")
    ops, got = [], None
    if dst is not None:
        t = send.detach().contiguous()
        t = t.cpu() if staged else t
        ops.append(dist.P2POp(dist.isend, t, dist.get_global_rank(group, dst),
                              group))
    if src is not None:
        got = torch.empty(recv_like.shape, dtype=recv_like.dtype,
                          device="cpu" if staged else recv_like.device)
        ops.append(dist.P2POp(dist.irecv, got,
                              dist.get_global_rank(group, src), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if got is None:
        return torch.zeros_like(recv_like)
    return got.to(recv_like.device) if staged else got


class _Shift(torch.autograd.Function):
    """Forward: ``y`` to stage s + 1, stage s - 1's ``y`` back (zeros at
    stage 0). Backward: the gradient of what came in back to s - 1, and
    the gradient of ``y`` from s + 1 (zeros at the last stage)."""

    @staticmethod
    def forward(ctx, y, anchor, group, s, n):
        ctx.group, ctx.s, ctx.n = group, s, n
        return _exchange(y, s + 1 if s + 1 < n else None, y,
                         s - 1 if s > 0 else None, group)

    @staticmethod
    def backward(ctx, g):
        s, n = ctx.s, ctx.n
        gy = _exchange(g, s - 1 if s > 0 else None, g,
                       s + 1 if s + 1 < n else None, ctx.group)
        return gy, None, None, None, None


def pipeline_apply(block_params: Any, x_micro: torch.Tensor,
                   apply_stage: Callable, mesh, stage_axis: str = "stage"
                   ) -> torch.Tensor:
    """Run microbatches through stage-split blocks.

    block_params: this rank's stage of the stack, the blocks
                  [s * n_blocks / n_stages, (s + 1) * n_blocks / n_stages)
                  in whatever form ``apply_stage`` takes (the port keeps a
                  rank's blocks as ``params.local_blocks`` gives them).
    x_micro:      (n_micro, mb, S, d) microbatched activations, the same on
                  every rank.
    apply_stage:  fn(stage_block_params, x) -> x, applying the local blocks.
    mesh:         a ``DeviceMesh`` with ``stage_axis`` (or its
                  ``MeshInfo``); without a mesh (``NO_MESH``) one stage.

    Returns (n_micro, mb, S, d) outputs, the same on every rank."""
    mi = mesh if isinstance(mesh, MeshInfo) else MeshInfo(mesh)
    n_stages = mi.size(stage_axis)
    n_micro = x_micro.shape[0]
    T = n_micro + n_stages - 1
    if n_stages == 1:
        s, group, anchor = 0, None, None
    else:
        s, group = axis_rank(mi, stage_axis), axis_group(mi, stage_axis)
        x_micro = copy_to(x_micro, mi, stage_axis)
        anchor = (x_micro.new_zeros(0, requires_grad=True)
                  if torch.is_grad_enabled() else x_micro.new_zeros(0))
    first = torch.tensor(s == 0, device=x_micro.device)
    cur = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    for t in range(T):
        # stage 0 injects microbatch t (clipped, as the reference's index)
        cur = torch.where(first, x_micro[min(t, n_micro - 1)], cur)
        y = apply_stage(block_params, cur)
        # the last stage records microbatch t - (n_stages - 1)
        mb_out = t - (n_stages - 1)
        valid = s == n_stages - 1 and 0 <= mb_out < n_micro
        idx = torch.tensor([min(max(mb_out, 0), n_micro - 1)],
                           device=x_micro.device)
        outs = torch.where(torch.tensor(valid, device=x_micro.device),
                           outs.index_copy(0, idx, y[None]), outs)
        if t < T - 1 and n_stages > 1:
            cur = _Shift.apply(y, anchor, group, s, n_stages)
    last = torch.tensor(s == n_stages - 1, device=x_micro.device)
    return reduce_from(torch.where(last, outs, torch.zeros_like(outs)), mi,
                       stage_axis)
