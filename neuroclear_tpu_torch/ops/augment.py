"""The augmentation chain of ``neuroclear_tpu/ops/augment.py``
(``augment_core`` and ``sample_rotated_crop``): a random crop of a (Z, Y, X)
volume, optionally rotated in XY (``random3Drotate``: an angle uniform on
{0..359} degrees; ``random90rotate``: one of +-90, +-180, +-270) and cropped
to the rotated slice's largest inscribed rectangle, scaled by
``dtype_inv_scale``, then flipped along each axis with probability 1/2.

The draws come from an explicit ``torch.Generator`` as host ints and the
rotation's geometry is host float32 math (``ops/rotation.py``), so the
sampler reads nothing back from the device: the crop is one bilinear gather
from the (cz, Y, X) slab, run on the device in float32 from host scalars.

The host-window form (``window_plan``, ``sample_window_crop``; JAX's
``host_window_sample``) keeps the volume in host memory: from the same draws
it plans, on the host, the (cz, Wy, Wx) window of the volume that holds
every tap of the crop, and the gather runs on the device over that window
alone.  The source coordinates are the same float32 operations on the same
host scalars in both forms, and each tap's index is clipped to the volume
before it is moved into the window, so a window that holds every tap gives
the card-volume crop bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .rotation import rotation_geometry

ROT90_ANGLES = (-90.0, 90.0, -180.0, 180.0, -270.0, 270.0)  # augment_core's order


def draw_angle(rotate: str | None, generator: torch.Generator):
    """``augment_core``'s angle draw: None without rotation, an int degree
    for ``rotate="any"``, one of ``ROT90_ANGLES`` for ``rotate="90"``."""
    if rotate is None:
        return None
    if rotate == "any":
        return int(torch.randint(0, 360, (), generator=generator))
    if rotate == "90":
        return ROT90_ANGLES[int(torch.randint(0, 6, (), generator=generator))]
    raise ValueError(f"rotate {rotate!r}: None, 'any' or '90'")


def crop_draws(vol_shape, crop_size, generator: torch.Generator, angle=None):
    """Crop offsets uniform on [0, extent - crop] (inclusive, as
    ``augment_core`` draws them; for a rotation the extents in Y and X are
    the inscribed crop's) and three flips, each with probability 1/2, from
    ``generator``."""
    extents = vol_shape
    if angle is not None:
        g = rotation_geometry(vol_shape[2], vol_shape[1], angle)
        extents = (vol_shape[0], g.crop_h, g.crop_w)
    offsets = []
    for extent, c in zip(extents, crop_size):
        if c > extent:
            raise ValueError(f"crop {tuple(crop_size)} does not fit the volume "
                             f"{tuple(vol_shape)} rotated by {angle or 0} degrees")
        offsets.append(int(torch.randint(0, extent - c + 1, (), generator=generator)))
    flips = [bool(f) for f in torch.rand(3, generator=generator) < 0.5]
    return tuple(offsets), tuple(flips)


def _flip(out: torch.Tensor, flips) -> torch.Tensor:
    dims = [d for d, f in enumerate(flips) if f]
    return torch.flip(out, dims) if dims else out


def sample_crop(vol: torch.Tensor, offsets, crop_size, inv_scale: float,
                flips=(False, False, False)) -> torch.Tensor:
    """vol[z0:z0+cz, y0:y0+cy, x0:x0+cx] in f32 times ``inv_scale``, flipped
    along each axis whose flag is set: ``sample_rotated_crop(rotate=False)``
    and the flips of ``augment_core``."""
    z0, y0, x0 = offsets
    cz, cy, cx = crop_size
    out = vol[z0:z0 + cz, y0:y0 + cy, x0:x0 + cx].float() * inv_scale
    return _flip(out, flips)


def _taps(vol_shape, angle, offsets, crop_size, dev):
    """The bilinear taps of the rotated crop: (ya, yb, xa, xb, wx, wy), each
    tap's index clipped to the (Z, Y, X) volume, from the crop's canvas
    coordinates (exact integers in f32) through the inverse affine."""
    _, y_n, x_n = vol_shape
    g = rotation_geometry(x_n, y_n, angle)
    _, y0, x0 = offsets
    _, cy, cx = crop_size
    i00, i01, i02, i10, i11, i12 = (float(c) for c in g.inv)
    py0, px0 = g.y1 + y0, g.x1 + x0
    py = torch.arange(py0, py0 + cy, device=dev, dtype=torch.float32)[:, None]
    px = torch.arange(px0, px0 + cx, device=dev, dtype=torch.float32)[None, :]
    sx = px * i00 + py * i01 + i02  # (cy, cx)
    sy = px * i10 + py * i11 + i12
    xf, yf = torch.floor(sx), torch.floor(sy)
    xa = xf.long().clamp_(0, x_n - 1)
    xb = (xa + 1).clamp_(max=x_n - 1)
    ya = yf.long().clamp_(0, y_n - 1)
    yb = (ya + 1).clamp_(max=y_n - 1)
    return ya, yb, xa, xb, sx - xf, sy - yf


def _mix(slab: torch.Tensor, width: int, ya, yb, xa, xb, wx, wy, inv_scale: float, flips):
    """The crop from a (cz, H * width) slab and taps indexing it."""
    cz = slab.shape[0]
    cy, cx = wx.shape
    ya, yb = ya * width, yb * width
    taps = torch.stack([ya + xa, ya + xb, yb + xa, yb + xb]).view(-1)
    v00, v01, v10, v11 = slab.index_select(1, taps).view(cz, 4, cy, cx).float().unbind(1)
    out = ((v00 * (1 - wx) + v01 * wx) * (1 - wy) + (v10 * (1 - wx) + v11 * wx) * wy) * inv_scale
    return _flip(out, flips)


def sample_rotated_crop(vol: torch.Tensor, angle, offsets, crop_size, inv_scale: float,
                        flips=(False, False, False)) -> torch.Tensor:
    """The crop at ``offsets`` of the volume rotated by ``angle`` degrees in
    XY and cropped to its inscribed rectangle, times ``inv_scale``, flipped
    along each axis whose flag is set: ``sample_rotated_crop(rotate=True)``
    and the flips of ``augment_core``.  Each output voxel is the bilinear
    mix of four source voxels, each tap's index clipped to the volume, as
    the JAX package computes it (its local gather window only bounds the
    gather's source: the samples are the same)."""
    _, y_n, x_n = vol.shape
    taps = _taps(vol.shape, angle, offsets, crop_size, vol.device)
    slab = vol.narrow(0, offsets[0], crop_size[0]).reshape(crop_size[0], y_n * x_n)
    return _mix(slab, x_n, *taps, inv_scale, flips)


def window_plan(vol_shape, angle, offsets, crop_size) -> tuple:
    """The host window of the volume that holds every tap of a crop:
    ((z0, z1), (y_lo, y_hi), (x_lo, x_hi)), as JAX's ``host_window_sample``
    places it.  Without rotation it is the crop itself.  With one, the
    window is ``ceil(hypot(cy, cx)) + 5`` wide in Y and X (at most the
    volume), its origin the least source coordinate of the crop's four
    corners, in host float32, less 2, clipped into the volume; the slack
    absorbs a source coordinate inside the crop that rounds below the
    corners'."""
    z_n, y_n, x_n = vol_shape
    z0, y0, x0 = offsets
    cz, cy, cx = crop_size
    if angle is None:
        return (z0, z0 + cz), (y0, y0 + cy), (x0, x0 + cx)
    g = rotation_geometry(x_n, y_n, angle)
    i00, i01, i02, i10, i11, i12 = g.inv
    py0, px0 = g.y1 + y0, g.x1 + x0
    pys = np.asarray([py0, py0 + cy - 1], np.float32)[:, None]
    pxs = np.asarray([px0, px0 + cx - 1], np.float32)[None, :]
    sx = pxs * i00 + pys * i01 + i02
    sy = pxs * i10 + pys * i11 + i12
    diag = int(math.ceil(math.hypot(cy, cx))) + 5
    wy, wx = min(y_n, diag), min(x_n, diag)
    y_lo = int(np.clip(math.floor(sy.min()) - 2, 0, y_n - wy))
    x_lo = int(np.clip(math.floor(sx.min()) - 2, 0, x_n - wx))
    return (z0, z0 + cz), (y_lo, y_lo + wy), (x_lo, x_lo + wx)


def sample_window_crop(window: torch.Tensor, plan, vol_shape, angle, offsets, crop_size,
                       inv_scale: float, flips=(False, False, False)) -> torch.Tensor:
    """The crop of ``sample_rotated_crop`` (or ``sample_crop`` without an
    angle) from ``window``, the part of the volume that ``plan``
    (``window_plan``) names, on the device: each tap's index clipped to the
    volume, then moved into the window and clipped to it."""
    if angle is None:
        return _flip(window.float() * inv_scale, flips)
    (_, _), (y_lo, y_hi), (x_lo, x_hi) = plan
    wy, wx = y_hi - y_lo, x_hi - x_lo
    ya, yb, xa, xb, fx, fy = _taps(vol_shape, angle, offsets, crop_size, window.device)
    taps = [(t - lo).clamp_(0, n - 1) for t, lo, n in
            ((ya, y_lo, wy), (yb, y_lo, wy), (xa, x_lo, wx), (xb, x_lo, wx))]
    return _mix(window.reshape(window.shape[0], wy * wx), wx, *taps, fx, fy, inv_scale, flips)
