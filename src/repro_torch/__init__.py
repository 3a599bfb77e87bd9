"""PyTorch/CUDA port of the zero-copy paged serving system and its training
path.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``configs/``, ``core/sva/``, ``core/serving/``, ``models/``, ``kernels/``,
``launch/``, ``optim/``, ``checkpoint/``, ``runtime/``, ``data/``) and
imports nothing from it. Entry points run on a CUDA device
unless the caller passes ``device="cpu"``.
"""
