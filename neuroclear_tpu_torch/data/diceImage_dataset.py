"""Inference dataset: one volume, padded for dicing, with its tile grid; the
port of ``neuroclear_tpu/data/diceImage_dataset.py`` as the fused tile
pipeline uses it (the per-cube ``DiceCube`` view waits, ROADMAP.md)."""

from __future__ import annotations

from ..utils import tiffio
from ..utils.imageops import pad_for_dicing
from .dicing import DiceGrid
from .image_folder import make_dataset


class DiceImageDataSet:
    """The first volume under ``opt.dataroot`` (TIFF or ``.npy``), end-padded
    so that stride ``dice_size[0] - overlap`` tiles it exactly."""

    def __init__(self, opt):
        found = make_dataset(opt.dataroot, 1)
        if not found:
            raise FileNotFoundError(f"no volume under {opt.dataroot}")
        path = found[0]
        vol = tiffio.imread(path)
        if vol.ndim != 3:
            raise ValueError(f"{path}: expected a (z, y, x) volume, got {vol.shape}")
        self.image_size_original = vol.shape
        self.volume = pad_for_dicing(vol, opt.dice_size[0], overlap=opt.overlap)
        self.grid = DiceGrid(self.volume.shape, opt.dice_size[0], opt.overlap, opt.border_cut)

    def size_original(self):
        return self.image_size_original
