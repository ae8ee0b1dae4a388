"""Copies of ``neuroclear_tpu/utils/imageops.py::pad_for_dicing`` and
``neuroclear_tpu/ops/augment.py::dtype_inv_scale``."""

from __future__ import annotations

import numpy as np


def pad_for_dicing(image: np.ndarray, roi_size: int, overlap: int = 0) -> np.ndarray:
    """End-pad (zeros) so stride (roi-overlap) tiles the volume exactly."""
    step = roi_size - overlap
    pads = []
    for dim in image.shape[::-1]:
        counts = (dim + overlap) // step
        pads.append(step * counts + roi_size - dim)
    z_pad, y_pad, x_pad = pads[2], pads[1], pads[0]
    return np.pad(image, ((0, z_pad), (0, y_pad), (0, x_pad)))


def dtype_inv_scale(dtype) -> float:
    """uint8 -> 1/255, uint16 -> 1/65535; floats pass through."""
    if dtype == np.uint8:
        return 1.0 / (2 ** 8 - 1.0)
    if dtype == np.uint16:
        return 1.0 / (2 ** 16 - 1.0)
    return 1.0
