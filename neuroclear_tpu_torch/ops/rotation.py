"""Rotation geometry of the ``random3Drotate`` augmentation, a copy of
``neuroclear_tpu/ops/rotation.py`` computed on the host in numpy float32.

The original repository rotates every XY slice by a random angle with cv2,
letting the canvas grow, then centre-crops to the largest inscribed
axis-aligned rectangle.  The JAX package's trainer computes that geometry on
the device in float32 (``rotation_geometry(jnp.float32(X), ..., xp=jnp)``
inside its jitted sampler); this module repeats its ``xp=jnp`` branch
operation for operation in numpy float32, so that its integer geometry
equals the device chain's, not the JAX package's float64 host form (at 180
degrees on a square N x N slice the float32 inscribed crop is N - 1 wide,
the float64 one N).  On non-square slices a few angles still differ from the
jitted chain (ROADMAP.md, queue 3), and the inverse-affine coefficients may
differ from XLA's in the last bit (its sin and cos are not numpy's).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np

_F = np.float32
_PI = _F(math.pi)
# XLA rewrites a division by a constant as a product with its float32
# reciprocal and folds constant products: ``angle * pi / 180`` runs as
# ``angle * (pi * (1 / 180))`` and ``angle / (pi / 2)`` as
# ``angle * (1 / (pi / 2))``, each constant rounded to float32 on the way.
_DEG = _PI * (_F(1) / _F(180))
_INV_HALF_PI = _F(1) / _F(math.pi / 2)


class RotGeom(NamedTuple):
    """Integer geometry of rotate-then-inscribed-crop for one angle.

    new_w/new_h: rotated canvas size; x1/y1: top-left of the inscribed crop
    in canvas coords; crop_w/crop_h: inscribed crop size (python ints);
    inv: 6-tuple row-major 2x3 inverse affine (canvas -> source coords), and
    fwd: the forward one, as numpy float32 scalars.
    """

    new_w: int
    new_h: int
    x1: int
    y1: int
    crop_w: int
    crop_h: int
    inv: tuple
    fwd: tuple


def _floor_int(v) -> int:
    return int(np.floor(v))


def largest_rotated_rect(w, h, angle) -> tuple:
    """Largest axis-aligned rectangle inside a w x h rectangle rotated by
    ``angle`` radians in [0, 2 pi): float32 (wr, hr)."""
    w, h, angle = _F(w), _F(h), _F(angle)
    quadrant = _floor_int(angle * _INV_HALF_PI) % 4
    odd = quadrant % 2
    sign_alpha = _F(odd) * (_PI - angle) + _F(1 - odd) * angle
    alpha = np.remainder(np.remainder(sign_alpha, _PI) + _PI, _PI)

    bb_w = w * np.cos(alpha) + h * np.sin(alpha)
    bb_h = w * np.sin(alpha) + h * np.cos(alpha)

    gamma = np.arctan2(bb_w, bb_h)  # == pi/4 for square inputs
    delta = _PI - alpha - gamma
    d = np.maximum(w, h) * np.cos(alpha)
    a = d * np.sin(alpha) / np.sin(delta)
    y = a * np.cos(gamma)
    x = y * np.tan(gamma)
    return bb_w - _F(2) * x, bb_h - _F(2) * y


@functools.lru_cache(maxsize=4096)
def rotation_geometry(w: int, h: int, angle_deg) -> RotGeom:
    """The rotate + centre-crop geometry of a W x H slice for ``angle_deg``
    degrees (cv2 convention: positive is counter-clockwise), as the JAX
    device chain computes it in float32."""
    w, h = _F(w), _F(h)
    theta = _F(angle_deg) * _DEG
    a, b = np.cos(theta), np.sin(theta)
    half = _F(0.5)
    w2, h2 = w * half, h * half

    new_w = _floor_int(np.abs(w * a) + np.abs(h * b))
    new_h = _floor_int(np.abs(w * b) + np.abs(h * a))
    tx = _F(_floor_int(_F(new_w) * half - w2))
    ty = _F(_floor_int(_F(new_h) * half - h2))

    # forward affine (src -> canvas): cv2's rotation matrix about the centre
    # plus the integer translation; its inverse for the pure rotation part
    one = _F(1)
    m02 = (one - a) * w2 - b * h2 + tx
    m12 = b * w2 + (one - a) * h2 + ty
    i00, i01, i10, i11 = a, -b, b, a
    i02 = -(i00 * m02 + i01 * m12)
    i12 = -(i10 * m02 + i11 * m12)

    wr, hr = largest_rotated_rect(w, h, np.remainder(theta, _F(2 * math.pi)))
    wr = np.minimum(wr, _F(new_w))
    hr = np.minimum(hr, _F(new_h))
    cx = _F(_floor_int(_F(new_w) * half))
    cy = _F(_floor_int(_F(new_h) * half))
    x1 = _floor_int(cx - wr * half)
    x2 = _floor_int(cx + wr * half)
    y1 = _floor_int(cy - hr * half)
    y2 = _floor_int(cy + hr * half)
    return RotGeom(new_w, new_h, x1, y1, x2 - x1, y2 - y1,
                   (i00, i01, i02, i10, i11, i12), (a, b, m02, -b, a, m12))
