"""The save side of ``neuroclear_tpu/models/base_model.py``: one
``{suffix}_net_{NAME}.npz`` per network in the JAX flat format, written
atomically (a temporary file, then a rename), so that the JAX package's
``TestModel`` and the port's ``test_dice`` load it.  Optimizer state is not
saved yet (ROADMAP.md)."""

from __future__ import annotations

import os

import numpy as np

from ..utils.weights import flat_from_module


def atomic_savez(path: str, arrays: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # a file handle: savez appends no '.npz'
        np.savez(f, **arrays)
    os.replace(tmp, path)


def save_networks(nets: dict, save_dir: str, suffix: str) -> list:
    """Write every net of ``nets`` ({NAME: module}); returns the paths."""
    os.makedirs(save_dir, exist_ok=True)
    paths = []
    for name, net in nets.items():
        path = os.path.join(save_dir, f"{suffix}_net_{name}.npz")
        atomic_savez(path, flat_from_module(net))
        paths.append(path)
    return paths
