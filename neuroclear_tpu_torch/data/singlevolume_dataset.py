"""Training data: ONE volume, each sample a fresh random augmentation of it,
the port of ``neuroclear_tpu/data/singlevolume_dataset.py``.  Its device
path (``sample``, for ``train_onecube``) keeps the volume on the device and
takes the preprocess tokens ``random3Drotate`` or ``random90rotate``,
``randomcrop``, ``randomflip``, ``addColorChannel`` and ``addBatchChannel``
(both rotations together are refused there: the JAX package leaves its
device path for the host chain then).  Its host path (``__getitem__``, for
the epoch trainer, ten items an epoch) runs the host chain
(``base_dataset.get_transform``) on the volume in host memory."""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.augment import crop_draws, draw_angle, sample_crop, sample_rotated_crop
from ..utils import tiffio
from ..utils.imageops import dtype_inv_scale
from .base_dataset import get_transform
from .image_folder import make_dataset

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


def volume_path(dataroot: str) -> str:
    """The training volume: ``dataroot`` itself if it is a file, else the
    first image file under it in sorted order (``make_dataset(dataroot,
    1)[0]``, as the JAX dataset picks it)."""
    if os.path.isfile(dataroot):
        return dataroot
    found = make_dataset(dataroot, 1)
    if not found:
        raise FileNotFoundError(f"{dataroot} holds no volume (TIFF or .npy)")
    return found[0]


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

    @classmethod
    def from_options(cls, opt, rng: np.random.Generator):
        """The epoch trainer's dataset: the volume of ``--dataroot`` on the
        host, its chain drawing from ``rng``."""
        path = volume_path(opt.dataroot)
        return HostVolumeDataset(tiffio.imread(path), opt, rng, path)


class HostVolumeDataset:
    """The JAX dataset's host path: every item the volume through the random
    host chain of ``opt.preprocess``, drawing from ``rng``."""

    def __init__(self, vol: np.ndarray, opt, rng: np.random.Generator, path: str = ""):
        self.A_img_np, self.A_path = vol, path
        self.transform_A = get_transform(opt, rng=rng)

    def __getitem__(self, index):
        return {"A": self.transform_A(self.A_img_np), "A_paths": self.A_path}

    def __len__(self):
        return 10  # an epoch is ten items, as in the original
