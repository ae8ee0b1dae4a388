"""Training data: ONE volume on the device, each sample a fresh random crop
of it, the port of ``neuroclear_tpu/data/singlevolume_dataset.py``'s device
path for the preprocess
``randomcrop_randomflip_addColorChannel_addBatchChannel``.  Rotations
(``random3Drotate``, ``random90rotate``) are not ported yet (ROADMAP.md)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.augment import crop_draws, sample_crop
from ..utils.imageops import dtype_inv_scale

PORTED_TOKENS = {"randomcrop", "randomflip", "addColorChannel", "addBatchChannel"}
# numpy dtype of the volume -> the dtype it is uploaded in
_UPLOAD = {np.dtype(np.uint8): np.uint8, np.dtype(np.uint16): np.int32,
           np.dtype(np.float32): np.float32}


def check_preprocess(preprocess: str) -> set:
    """The preprocess tokens, or NotImplementedError for what is not ported."""
    tokens = {t for t in preprocess.split("_") if t and t != "none"}
    missing = tokens - PORTED_TOKENS
    if missing:
        raise NotImplementedError(f"preprocess {sorted(missing)} is not ported yet "
                                  "(ROADMAP.md, queue 1 item 6); this port takes "
                                  "randomcrop_randomflip_addColorChannel_addBatchChannel")
    if "randomcrop" not in tokens:
        raise NotImplementedError("the port samples random crops only (randomcrop)")
    return tokens


class SingleVolumeDataset:
    """``vol`` (Z, Y, X) uint8, uint16 or float32 numpy, uploaded to
    ``device`` once (uint16 as int32, which torch handles on every device);
    ``sample(generator)`` draws a (1, cz, cy, cx, 1) f32 crop there."""

    def __init__(self, vol: np.ndarray, crop_size, preprocess: str, device):
        if vol.ndim != 3:
            raise ValueError(f"expected a (z, y, x) volume, got shape {vol.shape}")
        if vol.dtype not in _UPLOAD:
            raise TypeError(f"volume dtype {vol.dtype}: the port reads uint8, uint16 "
                            "and float32")
        tokens = check_preprocess(preprocess)
        self.crop_size = tuple(int(c) for c in crop_size)
        self.flip = "randomflip" in tokens
        self.inv_scale = dtype_inv_scale(vol.dtype)
        self.shape = vol.shape
        self.vol = torch.from_numpy(np.ascontiguousarray(vol, _UPLOAD[vol.dtype])).to(device)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        offsets, flips = crop_draws(self.shape, self.crop_size, generator)
        if not self.flip:
            flips = (False, False, False)
        return sample_crop(self.vol, offsets, self.crop_size, self.inv_scale, flips)[None, ..., None]
