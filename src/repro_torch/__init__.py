"""PyTorch/CUDA port of the zero-copy paged serving system.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``configs/``, ``core/sva/``, ``core/serving/``, ``models/``, ``kernels/``,
``launch/``) and imports nothing from it. Entry points run on a CUDA device
unless the caller passes ``device="cpu"``.
"""
