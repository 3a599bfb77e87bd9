"""Bitonic sort (paper kernel #5): block sort and the cross-block merge
ladder."""
