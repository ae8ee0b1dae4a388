"""Overlap-tile ("dice") index math, a copy of ``neuroclear_tpu/data/dicing.py``
(``DiceGrid`` and ``DiceCube``): x -> y -> z linear order, stride
(roi - overlap), reflect border_cut over-read.
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


class DiceCube:
    """Random-access view over a padded volume yielding
    (roi + 2*border_cut)^3 cubes in x -> y -> z order; the volume is
    reflect-padded by border_cut on every side, on the host."""

    def __init__(self, image: np.ndarray, roi_size: int, overlap: int = 0,
                 border_cut: int = 0):
        self.grid = DiceGrid(image.shape, roi_size, overlap, border_cut)
        self.roi_size = roi_size
        self.overlap = overlap
        self.border_cut = border_cut
        self.step = self.grid.step
        self.z_steps = self.grid.z_steps
        self.y_steps = self.grid.y_steps
        self.x_steps = self.grid.x_steps
        b = border_cut
        self.image = np.pad(image, ((b, b), (b, b), (b, b)), mode="reflect")

    def __getitem__(self, index: int) -> np.ndarray:
        z0, y0, x0 = self.grid.index_to_coordinates(index)
        ext = self.roi_size + 2 * self.border_cut
        return self.image[z0:z0 + ext, y0:y0 + ext, x0:x0 + ext]

    def __len__(self):
        return len(self.grid)
