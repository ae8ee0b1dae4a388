"""Host-side image helpers, copied from ``neuroclear_tpu/utils/imageops.py``
(``tensor2im``, ``pad_for_dicing``, ``crop_for_dicing``, ``normalize``,
``standardize``, ``rescale_intensity``, ``match_histograms``, ``get_psnr``,
``get_ssim``, ``save_image``) and ``neuroclear_tpu/ops/augment.py``
(``dtype_inv_scale``), in numpy float64 as there."""

from __future__ import annotations

import math

import numpy as np

from . import png


def pad_for_dicing(image: np.ndarray, roi_size: int, overlap: int = 0) -> np.ndarray:
    """End-pad (zeros) so stride (roi-overlap) tiles the volume exactly."""
    step = roi_size - overlap
    pads = []
    for dim in image.shape[::-1]:
        counts = (dim + overlap) // step
        pads.append(step * counts + roi_size - dim)
    z_pad, y_pad, x_pad = pads[2], pads[1], pads[0]
    return np.pad(image, ((0, z_pad), (0, y_pad), (0, x_pad)))


def crop_for_dicing(image: np.ndarray, roi_size: int, overlap: int = 0) -> np.ndarray:
    """Crop the leading samples so stride (roi-overlap) tiles the volume."""
    step = roi_size - overlap
    crops = []
    for dim in image.shape:
        counts = (dim - overlap) // step
        crops.append(dim - step * counts - overlap)
    return image[crops[0]:, crops[1]:, crops[2]:]


def tensor2im(x, imtype=np.uint16) -> np.ndarray:
    """Array in [0,1] -> clipped integer image."""
    img = np.asarray(x, dtype=np.float32)
    if imtype == np.uint8:
        img = np.clip(img, 0, 1) * (2 ** 8 - 1.0)
        img = np.clip(img, 0, 255)
    elif imtype == np.uint16:
        img = np.clip(img, 0, 1) * (2 ** 16 - 1.0)
        img = np.clip(img, 0, 2 ** 16 - 1)
    return img.astype(imtype)


def dtype_inv_scale(dtype) -> float:
    """uint8 -> 1/255, uint16 -> 1/65535; floats pass through."""
    if dtype == np.uint8:
        return 1.0 / (2 ** 8 - 1.0)
    if dtype == np.uint16:
        return 1.0 / (2 ** 16 - 1.0)
    return 1.0


def normalize(img: np.ndarray, data_type=float) -> np.ndarray:
    """Min-max rescale to the full range of data_type."""
    lo, hi = np.min(img), np.max(img)
    if data_type == np.uint8:
        new_max = 2 ** 8 - 1
    elif data_type == np.uint16:
        new_max = 2 ** 16 - 1
    else:
        new_max = 1
    out = (img - lo) * (new_max / (hi - lo))
    return out.astype(data_type)


def standardize(img: np.ndarray) -> np.ndarray:
    return (img - np.mean(img)) / np.std(img)


def rescale_intensity(img: np.ndarray, in_range: tuple) -> np.ndarray:
    """skimage.exposure.rescale_intensity(float image, in_range=(lo, hi)):
    clip, then scale to [0, 1]."""
    lo, hi = in_range
    img = np.clip(img, lo, hi)
    return (img - lo) / max(hi - lo, np.finfo(np.float32).tiny)


def match_histograms(image: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """skimage.exposure.match_histograms for single-channel arrays: map the
    image's empirical CDF onto the reference's."""
    src = image.ravel()
    ref = reference.ravel()
    src_vals, src_inv, src_cnt = np.unique(src, return_inverse=True, return_counts=True)
    ref_vals, ref_cnt = np.unique(ref, return_counts=True)
    src_q = np.cumsum(src_cnt) / src.size
    ref_q = np.cumsum(ref_cnt) / ref.size
    mapped = np.interp(src_q, ref_q, ref_vals)
    return mapped[src_inv].reshape(image.shape).astype(image.dtype, copy=False)


def save_image(image_numpy: np.ndarray, image_path: str) -> None:
    """A 2D uint8 image as an 8-bit grayscale PNG (``utils/png.py``; the JAX
    package writes it through PIL, which the port does not use)."""
    if not image_path.lower().endswith(".png"):
        raise ValueError(f"{image_path}: the port writes PNG images only")
    png.write_gray8(image_path, image_numpy)


def get_mse(source, target):
    return np.mean((np.asarray(target, float) - np.asarray(source, float)) ** 2)


def get_psnr(source, target, data_range):
    mse = get_mse(source, target)
    return 20 * math.log10(data_range) - 10 * math.log10(mse)


def _ssim_map_sum(a, b, data_range, win):
    """Sum and count of the local-window SSIM map over one (sub)volume."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    def box(x):
        for ax in range(x.ndim):
            c = np.cumsum(x, axis=ax)
            lead = np.take(c, range(win - 1, x.shape[ax]), axis=ax)
            lag = np.concatenate(
                [np.zeros_like(np.take(c, [0], axis=ax)),
                 np.take(c, range(0, x.shape[ax] - win), axis=ax)], axis=ax)
            x = (lead - lag) / win
        return x

    mu_a, mu_b = box(a), box(b)
    saa = box(a * a) - mu_a ** 2
    sbb = box(b * b) - mu_b ** 2
    sab = box(a * b) - mu_a * mu_b
    ssim_map = ((2 * mu_a * mu_b + c1) * (2 * sab + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (saa + sbb + c2))
    return float(np.sum(ssim_map)), ssim_map.size


def get_ssim(a, b, data_range, win: int = 7, chunk_voxels: int = 48_000_000):
    """Mean local-window SSIM, uniform filter by cumulative sums; a large
    volume goes in leading-axis chunks with a (win - 1)-row halo, which
    computes disjoint strips of the same valid-window map."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.ndim < 1 or a.shape[0] < win or a.size <= chunk_voxels:
        return _chunk_mean([(np.asarray(a, np.float64),
                             np.asarray(b, np.float64))], data_range, win)
    rows_per = max(win, chunk_voxels // max(1, int(np.prod(a.shape[1:]))))
    n_valid = a.shape[0] - win + 1  # valid window starts along axis 0
    pairs = []
    for z0 in range(0, n_valid, rows_per):
        z1 = min(z0 + rows_per, n_valid)
        pairs.append((np.asarray(a[z0:z1 + win - 1], np.float64),
                      np.asarray(b[z0:z1 + win - 1], np.float64)))
    return _chunk_mean(pairs, data_range, win)


def _chunk_mean(pairs, data_range, win):
    total, count = 0.0, 0
    for ca, cb in pairs:
        s, n = _ssim_map_sum(ca, cb, data_range, win)
        total += s
        count += n
    return total / max(count, 1)
