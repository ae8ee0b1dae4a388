"""Inference model and checkpoint loading."""
