"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), each with a plain
PyTorch version beside it and a launch counter on its wrapper."""
from repro_torch.kernels.flash_attention.ops import flash_attention_fwd
from repro_torch.kernels.paged_attention.ops import paged_attention_global

KERNELS = {"paged_attention_global": paged_attention_global,
           "flash_attention_fwd": flash_attention_fwd}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
