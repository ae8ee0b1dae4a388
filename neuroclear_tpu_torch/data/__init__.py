"""Tile geometry, copied from ``neuroclear_tpu/data`` (which imports JAX)."""
