"""Paged decode attention over the shared global KV pool."""
