"""Slice, MIP and all-slices probes of 5-D volumes, the port of
``neuroclear_tpu/ops/sampling.py`` with the random index or window start
passed in (the JAX package draws it from a PRNG key inside; the port's step
takes the draws as an input, so a test can hand it the JAX draws).

Volumes are NDHWC (N, Z, Y, X, C); ``axis`` 0 = lateral (slice over Z -> XY
image), 1 = axial_1 (over Y -> XZ), 2 = axial_2 (over X -> YZ).  As in the
JAX package, the extent of the sliced axis is its true size.
"""

from __future__ import annotations

import torch


def random_slice(vol: torch.Tensor, idx: int, axis: int) -> torch.Tensor:
    """Slice ``idx`` along ``axis`` -> (N, h, w, C); idx in [0, n)."""
    return vol.select(axis + 1, idx)


def random_projection(vol: torch.Tensor, start: int, depth: int, axis: int) -> torch.Tensor:
    """Max-intensity projection over slices [start, start + depth) along
    ``axis`` -> (N, h, w, C); start in [0, n - depth).  ``torch.amax``
    splits the gradient evenly among tied maxima, as JAX's max does."""
    return torch.amax(vol.narrow(axis + 1, start, depth), dim=axis + 1)


def all_slices(vol: torch.Tensor, axis: int) -> torch.Tensor:
    """Every slice along ``axis`` as the batch: (N, Z, Y, X, C) ->
    (N * n, h, w, C), slice-major within each volume (``all_slices`` of the
    JAX package, Athena's per-slice loop as one batched 2D conv).  A
    contiguous copy for axes 1 and 2; a view for axis 0."""
    v = torch.movedim(vol, axis + 1, 1)
    return v.reshape((-1,) + tuple(v.shape[2:])).contiguous()
