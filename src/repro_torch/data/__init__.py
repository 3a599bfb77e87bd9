"""Synthetic data (a copy of the reference's JAX-free ``data/pipeline.py``)."""
