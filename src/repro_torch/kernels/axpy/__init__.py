"""Streaming axpy, ``a * x + y`` (paper kernel #4)."""
