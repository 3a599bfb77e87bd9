"""Plain PyTorch version of the heat3d stencil step.

Written after ``repro/kernels/heat3d/ref.py``: ``c0 * center + c1 * sum of
the six neighbours`` on the interior of (Z, Y, X), the boundary kept. The
neighbours are added in the reference's order (z-, z+, y-, y+, x-, x+).
JAX rounds the coefficients to the array's dtype (weak typing) and rounds
after every op; a Python float would stay fp32 in a torch op on a bf16
tensor, so c0 and c1 are rounded to the dtype first.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.axpy.ref import scalar_in

C0, C1 = 0.4, 0.1


def heat3d_step_ref(u: torch.Tensor, *, c0: float = C0,
                    c1: float = C1) -> torch.Tensor:
    """One timestep over (Z, Y, X). Returns a new tensor."""
    c0, c1 = scalar_in(c0, u.dtype), scalar_in(c1, u.dtype)
    center = u[1:-1, 1:-1, 1:-1]
    neigh = (u[:-2, 1:-1, 1:-1] + u[2:, 1:-1, 1:-1]
             + u[1:-1, :-2, 1:-1] + u[1:-1, 2:, 1:-1]
             + u[1:-1, 1:-1, :-2] + u[1:-1, 1:-1, 2:])
    out = u.clone()
    out[1:-1, 1:-1, 1:-1] = c0 * center + c1 * neigh
    return out
