"""Inference dataset: one volume, padded for dicing, the port of
``neuroclear_tpu/data/diceImage_dataset.py``.  The fused tile pipeline reads
the padded volume (``.volume``) and its tile grid (``.grid``); the per-cube
loop (``--legacy_pipeline``) indexes the dataset, which cuts each cube from
``.cube`` (a ``DiceCube``, built on first use: its reflect pad copies the
volume on the host) and runs it through the preprocess chain."""

from __future__ import annotations

import functools

import numpy as np

from ..utils import tiffio
from ..utils.imageops import pad_for_dicing
from .base_dataset import BaseDataset, get_transform
from .dicing import DiceCube, DiceGrid
from .image_folder import make_dataset


class DiceImageDataSet(BaseDataset):
    """The first volume under ``opt.dataroot`` (TIFF or ``.npy``), end-padded
    so that stride ``dice_size[0] - overlap`` tiles it exactly."""

    def __init__(self, opt):
        BaseDataset.__init__(self, opt)
        self.transform = get_transform(opt)
        found = make_dataset(opt.dataroot, 1)
        if not found:
            raise FileNotFoundError(f"no volume under {opt.dataroot}")
        self.A_path = found[0]
        vol = self._load()
        if vol.ndim != 3:
            raise ValueError(f"{self.A_path}: expected a (z, y, x) volume, got {vol.shape}")
        self.roi_size = opt.dice_size[0]
        self.overlap = opt.overlap
        self.border_cut = opt.border_cut
        self.image_size_original = vol.shape
        self.volume = pad_for_dicing(vol, self.roi_size, overlap=self.overlap)
        self.image_size = self.volume.shape
        self.grid = DiceGrid(self.image_size, self.roi_size, self.overlap, self.border_cut)

    def _load(self) -> np.ndarray:
        return tiffio.imread(self.A_path)

    @functools.cached_property
    def cube(self) -> DiceCube:
        return DiceCube(self.volume, self.roi_size, overlap=self.overlap,
                        border_cut=self.border_cut)

    def __getitem__(self, index):
        return {"A": self.transform(self.cube[index]), "A_paths": str(index)}

    def __len__(self):
        return len(self.grid)

    def shape(self):
        return (self.grid.z_steps, self.grid.y_steps, self.grid.x_steps)

    def size(self):
        return self.image_size

    def size_original(self):
        return self.image_size_original
