"""``BaseDataset`` and the host transform chain, the port of
``neuroclear_tpu/data/base_dataset.py``: the preprocess tokens compose in the
JAX package's order (``random3Drotate`` -> ``random90rotate`` ->
``randomcrop`` -> ``centercrop`` -> ``normalize_dtype`` -> ``randomflip`` ->
``addColorChannel`` -> ``reorderColorChannel`` -> ``addBatchChannel``),
channels-last, with a contiguous float32 array at the end.

The random tokens draw from an explicit numpy ``Generator`` (the JAX package
draws from Python's ``random`` and numpy's global state), or take
pre-drawn ``params`` (``get_params``: angle, crop position, flip axis) as
the JAX chain does.  The slice rotation is ``data/warp.py``'s numpy twin of
cv2's warp, bit for bit.  The epoch trainer's datasets run this chain; the
single-volume trainer samples its crops on the device
(``data/singlevolume_dataset.py``).
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np

from .warp import rotate_clean

RANDOM_TOKENS = ("random3Drotate", "random90rotate", "randomcrop", "randomflip")
INFERENCE_DATASETS = ("diceImage", "simulationcrop")  # test_dice's: cubes of the grid
HOST_TOKENS = {"random3Drotate", "random90rotate", "randomcrop", "centercrop",
               "addColorChannel", "reorderColorChannel", "addBatchChannel", "randomflip"}
ROT90_ANGLES = (-90, 90, -180, 180, -270, 270)


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


def check_host_preprocess(preprocess: str) -> None:
    """NotImplementedError for a token the host chain does not know."""
    tokens = {t for t in preprocess.split("_") if t and t != "none"}
    missing = tokens - HOST_TOKENS
    if missing:
        raise NotImplementedError(f"preprocess {sorted(missing)} is not ported yet "
                                  f"(ROADMAP.md, queue 1); the host chain takes "
                                  f"{sorted(HOST_TOKENS)}")


def to_ndhwc(a: np.ndarray) -> np.ndarray:
    """A loader batch as (N, Z, Y, X, 1), as the JAX models' ``_to_ndhwc``
    reads it: (B, 1, z, y, x, 1) from the host chain with addBatchChannel,
    (z, y, x, 1), (B, z, y, x) or (z, y, x)."""
    if a.ndim == 6:
        a = a.reshape((-1,) + a.shape[2:])
    if a.ndim == 4:
        a = a[None] if a.shape[-1] == 1 else a[..., None]
    if a.ndim == 3:
        a = a[None, ..., None]
    return np.ascontiguousarray(a, np.float32)


def get_params(opt, vol_shape, rng: np.random.Generator) -> dict:
    """Pre-drawn transform parameters (``get_params`` of the JAX package):
    the crop position, one flip axis and the rotation angle."""
    pos = tuple(int(rng.integers(0, max(0, n - c) + 1)) for n, c in zip(vol_shape, opt.crop_size))
    return {"crop_pos": pos, "flip_axis": int(rng.integers(0, 3)),
            "angle_3D": int(rng.integers(0, 360))}


def get_transform(opt, params=None, rng: np.random.Generator = None):
    """Compose the host chain for ``opt.preprocess``; returns fn(np) -> np.
    Without ``params`` the random tokens draw from ``rng`` each call."""
    pp = opt.preprocess
    refused = [t for t in RANDOM_TOKENS if t in pp]
    if refused and getattr(opt, "dataset_mode", None) in INFERENCE_DATASETS:
        raise NotImplementedError(f"preprocess {refused} on the inference dataset "
                                  f"{opt.dataset_mode}: the per-cube loop assembles cubes of "
                                  "the grid's shape, so it takes no random token (ROADMAP.md, "
                                  "queue 1)")
    if rng is None:
        rng = np.random.default_rng()
    steps = []
    if "random3Drotate" in pp:
        if params is None:
            steps.append(lambda v: rotate_clean(v, int(rng.integers(0, 360))))
        else:
            steps.append(lambda v: rotate_clean(v, params["angle_3D"]))
    if "random90rotate" in pp:
        steps.append(lambda v: rotate_clean(v, int(rng.choice(ROT90_ANGLES))))
    if "randomcrop" in pp:
        if params is None:
            steps.append(lambda v: random_crop(v, opt.crop_size, rng))
        else:
            steps.append(lambda v: crop_at(v, params["crop_pos"], opt.crop_size))
    if "centercrop" in pp:
        steps.append(lambda v: center_crop(v, opt.crop_portion))
    steps.append(normalize_dtype)
    if "randomflip" in pp:
        if params is None:
            steps.append(lambda v: random_flip(v, rng))
        else:
            steps.append(lambda v: np.flip(v, params["flip_axis"]))
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


def random_crop(img: np.ndarray, crop_size, rng: np.random.Generator) -> np.ndarray:
    """A random crop of a 3D (or 2D) image; a crop extent of 0 keeps the
    whole axis."""
    axes = 3 if img.ndim > 2 else 2
    sl = []
    for ax in range(axes):
        c = crop_size[ax]
        if img.shape[ax] - c < 0:
            raise ValueError(f"crop {list(crop_size)} larger than the image {img.shape}")
        o = int(rng.integers(0, img.shape[ax] - c + 1))
        sl.append(slice(None) if c == 0 else slice(o, o + c))
    return img[tuple(sl)]


def crop_at(img: np.ndarray, pos, crop_size) -> np.ndarray:
    z, y, x = pos
    cz, cy, cx = crop_size
    return img[z:z + cz, y:y + cy, x:x + cx]


def random_flip(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Each axis flipped with probability 1/2, in axis order."""
    for ax in range(img.ndim):
        if rng.uniform(0, 1) < 0.5:
            img = np.flip(img, ax)
    return img


def permutate(img: np.ndarray) -> np.ndarray:
    """The volume stacked with each single-axis flip of it."""
    return np.stack([img] + [np.flip(img, ax) for ax in range(img.ndim)], axis=0)


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
