"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), each with a plain
PyTorch version beside it and a launch counter on its wrapper.

The per-slot wrapper is reached as ``kernels.paged_attention.ops.
paged_attention`` (here the name ``paged_attention`` is its subpackage).
The paper's kernels (gemm, gesummv, axpy, heat3d, and mergesort's
block sort and merge kernels) are reached through their subpackages'
``ops`` modules, as in the JAX package."""
from repro_torch.kernels.axpy.ops import axpy
from repro_torch.kernels.flash_attention.ops import flash_attention_fwd
from repro_torch.kernels.gemm.ops import gemm
from repro_torch.kernels.gesummv.ops import gesummv
from repro_torch.kernels.heat3d.ops import heat3d_step
from repro_torch.kernels.mergesort.ops import (block_sort, merge_stage,
                                               merge_tile)
from repro_torch.kernels.paged_attention import ops as _paged
from repro_torch.kernels.paged_attention.ops import paged_attention_global

KERNELS = {"paged_attention_global": paged_attention_global,
           "paged_attention": _paged.paged_attention,
           "flash_attention_fwd": flash_attention_fwd,
           "gemm": gemm, "gesummv": gesummv, "axpy": axpy,
           "heat3d_step": heat3d_step, "block_sort": block_sort,
           "merge_stage": merge_stage, "merge_tile": merge_tile}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    flash_attention_fwd.wgmma_launches = 0
    gemm.wgmma_launches = 0
