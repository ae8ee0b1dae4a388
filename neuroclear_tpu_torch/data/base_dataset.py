"""``BaseDataset`` and the deterministic part of the host transform chain, the
port of ``neuroclear_tpu/data/base_dataset.py``: the preprocess tokens
``centercrop``, ``addColorChannel``, ``reorderColorChannel`` and
``addBatchChannel`` around ``normalize_dtype``, in the JAX package's order,
channels-last, with a contiguous float32 array at the end.

The random tokens (``random3Drotate``, ``random90rotate``, ``randomcrop``,
``randomflip``) belong to the epoch trainer's host chain, which is not
ported (ROADMAP.md, queue 1 item 8); ``get_transform`` refuses them.  The
single-volume trainer samples its crops on the device
(``data/singlevolume_dataset.py``).
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np

RANDOM_TOKENS = ("random3Drotate", "random90rotate", "randomcrop", "randomflip")


class BaseDataset(ABC):
    def __init__(self, opt):
        self.opt = opt
        self.root = opt.dataroot

    @abstractmethod
    def __len__(self):
        return 0

    @abstractmethod
    def __getitem__(self, index):
        pass


def get_transform(opt):
    """Compose the host chain for ``opt.preprocess``; returns fn(np) -> np."""
    pp = opt.preprocess
    refused = [t for t in RANDOM_TOKENS if t in pp]
    if refused:
        raise NotImplementedError(f"preprocess {refused}: the random host transforms belong to "
                                  "the epoch trainer, not ported yet (ROADMAP.md, queue 1 "
                                  "item 8)")
    steps = []
    if "centercrop" in pp:
        steps.append(lambda v: center_crop(v, opt.crop_portion))
    steps.append(normalize_dtype)
    if "addColorChannel" in pp:
        steps.append(lambda v: np.expand_dims(v, axis=-1))  # channels-last
    if "reorderColorChannel" in pp:
        # (c, y, x) -> (y, x, c): the original's reorder, kept channels-last
        steps.append(lambda v: np.moveaxis(v, 0, -1))
    if "addBatchChannel" in pp:
        steps.append(lambda v: np.expand_dims(v, axis=0))
    steps.append(lambda v: np.ascontiguousarray(v, dtype=np.float32))

    def compose(v):
        for s in steps:
            v = s(v)
        return v

    return compose


def normalize_dtype(img: np.ndarray) -> np.ndarray:
    """uint8 -> /255, uint16 -> /65535 in float64 (the cast to float32 comes
    at the chain's end, so a sample is f32(x / 65535), not f32(x) *
    f32(1 / 65535)); floats pass through unchanged."""
    if img.dtype == np.uint8:
        return (img / (2 ** 8 * 1.0 - 1)).astype(float)
    if img.dtype == np.uint16:
        return (img / (2 ** 16 * 1.0 - 1)).astype(float)
    return img


def center_crop(img: np.ndarray, crop_portion: int) -> np.ndarray:
    """Keep crop_portion percent around the centre."""
    frac = (100 - crop_portion * 1.0) / 100
    if img.ndim > 2:
        z, y, x = img.shape
        cz, cy, cx = int(z * frac / 2), int(y * frac / 2), int(x * frac / 2)
        return img[cz:-cz, cy:-cy, cx:-cx]
    y, x = img.shape
    cy, cx = int(y * frac / 2), int(x * frac / 2)
    return img[cy:-cy, cx:-cx]
