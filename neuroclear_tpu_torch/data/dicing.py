"""Overlap-tile ("dice") index math, a copy of ``neuroclear_tpu/data/dicing.py``
(``DiceGrid``): x -> y -> z linear order, stride (roi - overlap), reflect
border_cut over-read.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DiceGrid:
    """Tile grid over a padded volume of shape `image_size` (z, y, x)."""

    image_size: tuple
    roi_size: int
    overlap: int = 0
    border_cut: int = 0

    def __post_init__(self):
        self.step = self.roi_size - self.overlap
        self.z_steps = (self.image_size[0] - self.overlap) // self.step
        self.y_steps = (self.image_size[1] - self.overlap) // self.step
        self.x_steps = (self.image_size[2] - self.overlap) // self.step

    def __len__(self):
        return self.z_steps * self.y_steps * self.x_steps

    def index_to_3d(self, index: int):
        x = index % self.x_steps
        y = (index % (self.x_steps * self.y_steps)) // self.x_steps
        z = index // (self.x_steps * self.y_steps)
        return z, y, x

    def index_to_coordinates(self, index: int):
        z, y, x = self.index_to_3d(index)
        return z * self.step, y * self.step, x * self.step

    def all_offsets(self) -> np.ndarray:
        """(N, 3) int32 tile offsets in dicing order (z, y, x coords)."""
        return np.array([self.index_to_coordinates(i) for i in range(len(self))],
                        dtype=np.int32)

    def coverage_1d(self, axis_len_steps: int) -> np.ndarray:
        """1D tile coverage count along one axis (the 3D coverage is the
        outer product of these).  Length: padded axis extent."""
        n = axis_len_steps * self.step + self.overlap
        cov = np.zeros(n, dtype=np.float32)
        for i in range(axis_len_steps):
            cov[i * self.step:i * self.step + self.roi_size] += 1.0
        return cov
