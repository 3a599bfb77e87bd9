"""Fault tolerance (a copy of the reference's JAX-free ``runtime/ft.py``)."""
