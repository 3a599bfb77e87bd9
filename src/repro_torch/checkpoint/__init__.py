"""Checkpoints in the reference's layout (port of ``repro/checkpoint``)."""
