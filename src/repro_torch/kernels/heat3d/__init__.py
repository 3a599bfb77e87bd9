"""heat3d 7-point stencil with a fixed boundary (paper kernel #3)."""
