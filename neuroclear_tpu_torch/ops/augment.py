"""The crop-and-flip branch of ``neuroclear_tpu/ops/augment.py``
(``augment_core`` with ``do_rotate=False``, ``do_rot90=False``): a random
crop of a (Z, Y, X) volume, scaled by ``dtype_inv_scale``, then a flip of
each axis with probability 1/2.  Rotation is not ported yet (ROADMAP.md)."""

from __future__ import annotations

import torch


def crop_draws(vol_shape, crop_size, generator: torch.Generator):
    """Crop offsets uniform on [0, extent - crop] (inclusive, as
    ``augment_core`` draws them) and three flips, each with probability 1/2,
    from ``generator``."""
    offsets = []
    for extent, c in zip(vol_shape, crop_size):
        if c > extent:
            raise ValueError(f"crop {tuple(crop_size)} does not fit the volume {tuple(vol_shape)}")
        offsets.append(int(torch.randint(0, extent - c + 1, (), generator=generator)))
    flips = [bool(f) for f in torch.rand(3, generator=generator) < 0.5]
    return tuple(offsets), tuple(flips)


def sample_crop(vol: torch.Tensor, offsets, crop_size, inv_scale: float,
                flips=(False, False, False)) -> torch.Tensor:
    """vol[z0:z0+cz, y0:y0+cy, x0:x0+cx] in f32 times ``inv_scale``, flipped
    along each axis whose flag is set: ``sample_rotated_crop(rotate=False)``
    and the flips of ``augment_core``."""
    z0, y0, x0 = offsets
    cz, cy, cx = crop_size
    out = vol[z0:z0 + cz, y0:y0 + cy, x0:x0 + cx].float() * inv_scale
    dims = [d for d, f in enumerate(flips) if f]
    return torch.flip(out, dims) if dims else out
