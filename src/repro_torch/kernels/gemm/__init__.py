"""Tiled GEMM with fp32 accumulation (paper kernel #1)."""
