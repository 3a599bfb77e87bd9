"""Serving engine over the paged SVA layer."""
