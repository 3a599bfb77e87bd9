"""Fused gesummv, ``alpha * A @ x + beta * B @ x`` (paper kernel #2)."""
