"""Tiled inference on the card."""
