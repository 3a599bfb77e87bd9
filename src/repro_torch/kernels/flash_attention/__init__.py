"""Flash-attention forward (prefill)."""
