"""Training data: ONE volume, each sample a fresh random augmentation of it,
the port of ``neuroclear_tpu/data/singlevolume_dataset.py``.  Its device
path (``SingleVolumeDataset``, for ``train_onecube``) takes the preprocess
tokens ``random3Drotate`` or ``random90rotate``, ``randomcrop``,
``randomflip``, ``addColorChannel`` and ``addBatchChannel`` with a crop of
every axis (``device_chain_takes``); it cuts its crops from the volume on the
device (``sample``, ``per_crop_sampler``, ``sample_batch``), or from windows
of the volume in host memory that it uploads one by one
(``sample_host_window``, ``per_crop_host_window_sampler``): a dataset used
only so never uploads the volume.  Its host path (``HostVolumeDataset``, for
the epoch trainer and for ``train_onecube`` with ``--host_augment`` or a
chain the device path does not take) runs the host chain
(``base_dataset.get_transform``) on the volume in host memory."""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.augment import (crop_draws, draw_angle, sample_crop, sample_rotated_crop,
                           sample_window_crop, window_plan)
from ..utils import tiffio
from ..utils.imageops import dtype_inv_scale
from .base_dataset import get_transform
from .image_folder import make_dataset

PORTED_TOKENS = {"random3Drotate", "random90rotate", "randomcrop", "randomflip",
                 "addColorChannel", "addBatchChannel"}
# numpy dtype of the volume -> the dtype it is uploaded in
_UPLOAD = {np.dtype(np.uint8): np.uint8, np.dtype(np.uint16): np.int32,
           np.dtype(np.float32): np.float32}


def device_chain_takes(preprocess: str, crop_size) -> bool:
    """Whether the device path takes this chain, as the JAX dataset decides
    (``_device_ok``): its tokens only, not both rotations, ``randomcrop``,
    and a crop of every axis; else ``train_onecube`` runs the host chain."""
    tokens = {t for t in preprocess.split("_") if t and t != "none"}
    return (tokens <= PORTED_TOKENS and not {"random3Drotate", "random90rotate"} <= tokens
            and "randomcrop" in tokens and all(c > 0 for c in crop_size))


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
    """``vol`` (Z, Y, X) uint8, uint16 or float32 numpy, kept in host
    memory; the crops come (1, cz, cy, cx, 1) f32 on ``device``, cut from
    the volume uploaded there on first use (uint16 as int32, which torch
    handles on every device) or from host windows of it."""

    def __init__(self, vol: np.ndarray, crop_size, preprocess: str, device):
        if vol.ndim != 3:
            raise ValueError(f"expected a (z, y, x) volume, got shape {vol.shape}")
        if vol.dtype not in _UPLOAD:
            raise TypeError(f"volume dtype {vol.dtype}: the port reads uint8, uint16 "
                            "and float32")
        if not device_chain_takes(preprocess, crop_size):
            raise ValueError(f"preprocess {preprocess} with crop {list(crop_size)}: the device "
                             f"chain takes the tokens {sorted(PORTED_TOKENS)} with one rotation, "
                             "randomcrop and a crop of every axis (else the host chain runs)")
        tokens = set(preprocess.split("_"))
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
        self.host_vol = vol
        self.device = torch.device(device)
        self._vol = None

    @property
    def vol(self) -> torch.Tensor:
        """The volume on the device, uploaded on first use."""
        if self._vol is None:
            self._vol = self._upload(self.host_vol)
        return self._vol

    @property
    def uploaded(self) -> bool:
        return self._vol is not None

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, _UPLOAD[a.dtype])).to(self.device)

    def draws(self, generator: torch.Generator) -> tuple:
        """``augment_core``'s draws in its order: (angle or None, offsets,
        flips)."""
        angle = draw_angle(self.rotate, generator)
        offsets, flips = crop_draws(self.shape, self.crop_size, generator, angle)
        if not self.flip:
            flips = (False, False, False)
        return angle, offsets, flips

    def crop(self, angle, offsets, flips) -> torch.Tensor:
        """The (1, cz, cy, cx, 1) crop for given draws, from the device
        volume."""
        if angle is None:
            out = sample_crop(self.vol, offsets, self.crop_size, self.inv_scale, flips)
        else:
            out = sample_rotated_crop(self.vol, angle, offsets, self.crop_size,
                                      self.inv_scale, flips)
        return out[None, ..., None]

    def window_crop(self, angle, offsets, flips) -> torch.Tensor:
        """The same crop from the host window that holds its taps
        (``window_plan``), uploaded alone: JAX's ``host_window_sample``."""
        plan = window_plan(self.shape, angle, offsets, self.crop_size)
        window = self._upload(self.host_vol[tuple(slice(*r) for r in plan)])
        out = sample_window_crop(window, plan, self.shape, angle, offsets, self.crop_size,
                                 self.inv_scale, flips)
        return out[None, ..., None]

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        return self.crop(*self.draws(generator))

    def sample_host_window(self, generator: torch.Generator) -> torch.Tensor:
        """``sample`` without the volume on the device
        (``NEUROCLEAR_HOST_WINDOW=1`` in ``train_onecube``)."""
        return self.window_crop(*self.draws(generator))

    def per_crop_sampler(self, generator: torch.Generator, n: int):
        """i -> crop i of an n-crop step, cut from the device volume when
        asked for: the n crops' draws are taken now, in order."""
        geometry = [self.draws(generator) for _ in range(n)]
        return lambda i: self.crop(*geometry[i])

    def per_crop_host_window_sampler(self, generator: torch.Generator, n: int):
        """``per_crop_sampler`` without the volume on the device: crop i is
        cut from its host window when asked for."""
        geometry = [self.draws(generator) for _ in range(n)]
        return lambda i: self.window_crop(*geometry[i])

    def sample_batch(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """The n crops of ``per_crop_sampler`` (the same draws), cut from the
        device volume at once: (n, cz, cy, cx, 1), resident together."""
        crop = self.per_crop_sampler(generator, n)
        return torch.cat([crop(i) for i in range(n)])

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
