"""The host chain's slice rotation without cv2: ``rotate_clean`` of
``neuroclear_tpu/data/base_dataset.py``, which warps each XY slice with
``cv2.warpAffine(..., INTER_LINEAR)`` on the raw (uint8, uint16 or float32)
slice and crops the largest inscribed rectangle.

``warp_affine_linear`` is a numpy twin of that warp as OpenCV 5.0 computes
it, held bit for bit against it (``tests/test_torch_host_chain.py``):
  * the 2x3 matrix is inverted in float64 as ``cv::warpAffine`` inverts it,
    then rounded to float32;
  * each output pixel's source coordinates are float32: ``fma(x, M0, Mx)``
    with ``Mx = y * M1 + M2`` in the vector loop (``LANES`` columns at a
    time), ``fma(x, M0, y * M1) + M2`` in the scalar loop that finishes a
    row (a fused multiply-add rounds once; here it is taken in float64 and
    rounded to float32, exact for these operands);
  * the four neighbours are read as float32 (zero outside the slice:
    BORDER_CONSTANT), and interpolated as ``fma(ax, p01 - p00, p00)``, the
    same along x for the lower row, then along y;
  * integer outputs are rounded to nearest even and saturated.
No fixed-point coordinate grid is involved: OpenCV 5.0's linear warp is in
float32 (1/32-pixel quantization is the older OpenCV 4 path).

The geometry is the float64 host form of ``rotation_geometry`` (the JAX
package's ``xp=math`` branch), which ``rotation_geometry_f64`` copies; the
device sampler's float32 geometry (``ops/rotation.py``) differs from it by
one in the crop at a few angles.
"""

from __future__ import annotations

import math

import numpy as np

_F = np.float32
LANES = 16  # OpenCV's vector loop of the warp (16 float32 lanes), then its scalar tail


def _largest_rotated_rect(w: float, h: float, angle: float) -> tuple:
    quadrant = int(math.floor(angle / (math.pi / 2))) % 4
    sign_alpha = angle if quadrant % 2 == 0 else math.pi - angle
    alpha = (sign_alpha % math.pi + math.pi) % math.pi
    bb_w = w * math.cos(alpha) + h * math.sin(alpha)
    bb_h = w * math.sin(alpha) + h * math.cos(alpha)
    gamma = math.atan2(bb_w * 1.0, bb_h * 1.0)
    delta = math.pi - alpha - gamma
    d = max(w, h) * math.cos(alpha)
    a = d * math.sin(alpha) / math.sin(delta)
    y = a * math.cos(gamma)
    x = y * math.tan(gamma)
    return bb_w - 2 * x, bb_h - 2 * y


def rotation_geometry_f64(w: float, h: float, angle_deg: float) -> tuple:
    """(new_w, new_h, x1, y1, crop_w, crop_h, fwd): the canvas, the
    inscribed crop and the forward 2x3 matrix (row-major) of rotating a
    w x h slice by ``angle_deg`` degrees, in float64 with the JAX package's
    int truncations."""
    theta = angle_deg * math.pi / 180.0
    a, b = math.cos(theta), math.sin(theta)
    w2, h2 = w * 0.5, h * 0.5
    new_w = int(abs(w * a) + abs(h * b))
    new_h = int(abs(w * b) + abs(h * a))
    tx = int(new_w * 0.5 - w2)
    ty = int(new_h * 0.5 - h2)
    m02 = (1 - a) * w2 - b * h2 + tx
    m12 = b * w2 + (1 - a) * h2 + ty
    wr, hr = _largest_rotated_rect(w, h, theta % (2 * math.pi))
    wr, hr = min(wr, new_w), min(hr, new_h)
    cx, cy = int(new_w * 0.5), int(new_h * 0.5)
    x1, x2 = int(cx - wr * 0.5), int(cx + wr * 0.5)
    y1, y2 = int(cy - hr * 0.5), int(cy + hr * 0.5)
    return new_w, new_h, x1, y1, x2 - x1, y2 - y1, (a, b, m02, -b, a, m12)


def _invert(m) -> np.ndarray:
    """``cv::warpAffine``'s inversion of the forward matrix, in float64."""
    m = np.asarray(m, np.float64).ravel().copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once (a * b is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F)


def _source_coords(m_inv: np.ndarray, width: int, height: int) -> tuple:
    """float32 (sx, sy), each (height, width): the vector loop's form for
    the first ``width // LANES * LANES`` columns, the scalar tail's after."""
    m = m_inv.astype(_F)
    x = np.arange(width, dtype=_F)[None, :]
    y = np.arange(height, dtype=_F)[:, None]
    tail = np.arange(width)[None, :] >= width // LANES * LANES
    out = []
    for c0, c1, c2 in ((m[0], m[1], m[2]), (m[3], m[4], m[5])):
        vec = _fma(x, c0, y * c1 + c2)
        scalar = _fma(x, c0, y * c1) + c2
        out.append(np.where(tail, scalar, vec))
    return out


def warp_affine_linear(src: np.ndarray, m, dsize) -> np.ndarray:
    """``cv2.warpAffine(src, m, dsize, flags=cv2.INTER_LINEAR)`` (border
    constant 0) of OpenCV 5.0 on a (..., h, w) stack of slices that share
    the warp: uint8, uint16 or float32 in, the same dtype out, (...,
    dsize[1], dsize[0])."""
    if src.dtype not in (np.uint8, np.uint16, np.float32):
        raise TypeError(f"warp_affine_linear takes uint8, uint16 or float32, got {src.dtype}")
    width, height = dsize
    sx, sy = _source_coords(_invert(m), width, height)
    ix, iy = np.floor(sx), np.floor(sy)
    ax, ay = sx - ix, sy - iy  # exact in float32
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)
    h, w = src.shape[-2:]

    def tap(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = src[..., np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)].astype(_F)
        return np.where(inside, v, _F(0))

    p00, p01 = tap(iy, ix), tap(iy, ix + 1)
    p10, p11 = tap(iy + 1, ix), tap(iy + 1, ix + 1)
    v0 = _fma(ax, p01 - p00, p00)
    v1 = _fma(ax, p11 - p10, p10)
    v = _fma(ay, v1 - v0, v0)
    if src.dtype == np.float32:
        return v
    top = np.iinfo(src.dtype).max
    return np.clip(np.rint(v), 0, top).astype(src.dtype)


def rotate_clean(image: np.ndarray, angle) -> np.ndarray:
    """Rotate (..., h, w) slices about their centre by ``angle`` degrees and
    crop the largest inscribed rectangle (``rotate_clean`` of the JAX
    package, every slice of a stack at once)."""
    h, w = image.shape[-2:]
    new_w, new_h, x1, y1, crop_w, crop_h, fwd = rotation_geometry_f64(
        float(w), float(h), float(angle))
    canvas = warp_affine_linear(image, fwd, (new_w, new_h))
    return canvas[..., y1:y1 + crop_h, x1:x1 + crop_w]
