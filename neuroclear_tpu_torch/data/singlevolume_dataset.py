"""Training data: ONE volume on the device, each sample a fresh random
augmentation of it, the port of ``neuroclear_tpu/data/singlevolume_dataset.py``'s
device path (``sample``): the preprocess tokens ``random3Drotate`` or
``random90rotate``, ``randomcrop``, ``randomflip``, ``addColorChannel`` and
``addBatchChannel``.  Both rotations together leave the JAX package's device
path for its host cv2 chain, which the port does not have: that is refused."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.augment import crop_draws, draw_angle, sample_crop, sample_rotated_crop
from ..utils.imageops import dtype_inv_scale

PORTED_TOKENS = {"random3Drotate", "random90rotate", "randomcrop", "randomflip",
                 "addColorChannel", "addBatchChannel"}
# numpy dtype of the volume -> the dtype it is uploaded in
_UPLOAD = {np.dtype(np.uint8): np.uint8, np.dtype(np.uint16): np.int32,
           np.dtype(np.float32): np.float32}


def check_preprocess(preprocess: str) -> set:
    """The preprocess tokens, or NotImplementedError for what is not ported."""
    tokens = {t for t in preprocess.split("_") if t and t != "none"}
    missing = tokens - PORTED_TOKENS
    if missing:
        raise NotImplementedError(f"preprocess {sorted(missing)} is not ported yet "
                                  "(ROADMAP.md, queue 1); this port takes the tokens "
                                  f"{sorted(PORTED_TOKENS)}")
    if {"random3Drotate", "random90rotate"} <= tokens:
        raise NotImplementedError("random3Drotate with random90rotate runs the JAX "
                                  "package's host cv2 chain, which is not ported "
                                  "(ROADMAP.md, queue 1); choose one rotation")
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
        self.rotate = ("any" if "random3Drotate" in tokens
                       else "90" if "random90rotate" in tokens else None)
        if self.rotate == "any":
            # the worst-case inscribed rectangle (45 degrees) must still hold
            # the crop, checked up front as the JAX dataset does
            z, y, x = vol.shape
            worst = int(min(y, x) / np.sqrt(2.0))
            cz, cy, cx = self.crop_size
            if not (z >= cz and worst >= cy and worst >= cx):
                raise ValueError(f"crop {list(crop_size)} cannot fit the worst-case rotated "
                                 f"volume extents ({z},{worst},{worst})")
        self.inv_scale = dtype_inv_scale(vol.dtype)
        self.shape = vol.shape
        self.vol = torch.from_numpy(np.ascontiguousarray(vol, _UPLOAD[vol.dtype])).to(device)

    def draws(self, generator: torch.Generator) -> tuple:
        """``augment_core``'s draws in its order: (angle or None, offsets,
        flips)."""
        angle = draw_angle(self.rotate, generator)
        offsets, flips = crop_draws(self.shape, self.crop_size, generator, angle)
        if not self.flip:
            flips = (False, False, False)
        return angle, offsets, flips

    def crop(self, angle, offsets, flips) -> torch.Tensor:
        """The (1, cz, cy, cx, 1) crop for given draws."""
        if angle is None:
            out = sample_crop(self.vol, offsets, self.crop_size, self.inv_scale, flips)
        else:
            out = sample_rotated_crop(self.vol, angle, offsets, self.crop_size,
                                      self.inv_scale, flips)
        return out[None, ..., None]

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        return self.crop(*self.draws(generator))
