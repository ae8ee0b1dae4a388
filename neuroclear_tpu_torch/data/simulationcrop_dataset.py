"""The diceImage dataset on a fixed 700^3 crop of its volume, cut at (z, y,
x) = (136, 104, 120) before dicing: the port of
``neuroclear_tpu/data/simulationcrop_dataset.py`` (the original's hard-coded
offsets), for ``test_dice --dataset_mode simulationcrop``."""

from __future__ import annotations

import numpy as np

from ..utils import tiffio
from .diceImage_dataset import DiceImageDataSet


class SimulationCropDataSet(DiceImageDataSet):
    CROP_OFFSET = (136, 104, 120)  # z, y, x
    CROP_SIZE = 700

    def _load(self) -> np.ndarray:
        vol = tiffio.imread(self.A_path)
        z, y, x = self.CROP_OFFSET
        s = self.CROP_SIZE
        return np.ascontiguousarray(vol[z:z + s, y:y + s, x:x + s])
