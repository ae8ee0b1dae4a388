"""Synthetic bead volumes for the simulation quality study: a numpy and
scipy copy of ``neuroclear_tpu/utils/synthetic.py``.

A randomized bead volume with (a) a sharp isotropic ground truth, (b) an
axially blurred and noisy input (the network's training data), and (c) a
90-degree rotated copy of the ground truth.  Beads are Gaussian blobs of
random intensity and size; the axial degradation is a separable Gaussian PSF
elongated along Z plus Gaussian and Poisson noise.  The artifact form
(``generate_artifact_volume``) damages the stack plane by plane instead, for
Athena.

The draws come from ``np.random.default_rng(seed)`` in the JAX package's
order, so that one seed gives the JAX package's volumes bit for bit.
"""

from __future__ import annotations

import numpy as np


def generate_bead_volume(
    shape=(300, 300, 300),
    n_beads: int = 1200,
    bead_sigma_range=(1.0, 3.0),
    intensity_range=(0.3, 1.0),
    axial_sigma: float = 6.0,
    lateral_sigma: float = 1.0,
    gauss_noise: float = 0.01,
    poisson_peak: float = 200.0,
    seed: int = 0,
    dtype=np.uint16,
):
    """Return (input_blurred, ground_truth, rotated_gt) uint16 volumes.

    input = GT convolved with an anisotropic Gaussian PSF (sigma_z =
    axial_sigma, sigma_xy = lateral_sigma) + Poisson shot noise + Gaussian
    read noise; rotated_gt is the GT rotated 90 degrees about the X axis
    (so its sharp plane becomes axial) — the evaluation aid the notebook
    produced.
    """
    rng = np.random.default_rng(seed)
    gt = _splat_beads(rng, shape, n_beads, bead_sigma_range, intensity_range)

    blurred = _gaussian_blur_separable(gt, (axial_sigma, lateral_sigma, lateral_sigma))
    noisy = rng.poisson(np.clip(blurred, 0, None) * poisson_peak) / poisson_peak
    noisy = noisy + rng.normal(0.0, gauss_noise, noisy.shape)
    noisy = np.clip(noisy, 0.0, 1.0)

    rotated = np.rot90(gt, k=1, axes=(0, 1))  # sharp plane becomes axial

    scale = np.iinfo(dtype).max if np.issubdtype(dtype, np.integer) else 1.0
    conv = lambda v: (v * scale).astype(dtype)
    return conv(noisy), conv(gt), conv(np.ascontiguousarray(rotated))


def _splat_beads(rng, shape, n_beads, bead_sigma_range, intensity_range):
    """Gaussian-blob bead ground truth on a padded canvas (identical draw
    order to the original inline loop — seeds reproduce old volumes)."""
    z, y, x = shape
    pad = 8
    canvas = np.zeros((z + 2 * pad, y + 2 * pad, x + 2 * pad), np.float32)
    for _ in range(n_beads):
        cz = rng.uniform(pad, z + pad)
        cy = rng.uniform(pad, y + pad)
        cx = rng.uniform(pad, x + pad)
        s = rng.uniform(*bead_sigma_range)
        amp = rng.uniform(*intensity_range)
        r = int(np.ceil(3 * s))
        zz = np.arange(int(cz) - r, int(cz) + r + 1)
        yy = np.arange(int(cy) - r, int(cy) + r + 1)
        xx = np.arange(int(cx) - r, int(cx) + r + 1)
        zz = zz[(zz >= 0) & (zz < canvas.shape[0])]
        yy = yy[(yy >= 0) & (yy < canvas.shape[1])]
        xx = xx[(xx >= 0) & (xx < canvas.shape[2])]
        gz = np.exp(-((zz - cz) ** 2) / (2 * s * s))
        gy = np.exp(-((yy - cy) ** 2) / (2 * s * s))
        gx = np.exp(-((xx - cx) ** 2) / (2 * s * s))
        canvas[np.ix_(zz, yy, xx)] += (amp * gz[:, None, None]
                                       * gy[None, :, None] * gx[None, None, :])
    return np.clip(canvas[pad:-pad, pad:-pad, pad:-pad], 0.0, 1.0)


def generate_artifact_volume(
    shape=(300, 300, 300),
    n_beads: int = 1200,
    bead_sigma_range=(1.0, 3.0),
    intensity_range=(0.3, 1.0),
    jitter_px: float = 2.0,
    jitter_step: float = 0.6,
    flicker_sigma: float = 0.15,
    axial_sigma: float = 2.0,
    gauss_noise: float = 0.01,
    poisson_peak: float = 200.0,
    seed: int = 0,
    dtype=np.uint16,
):
    """Synthetic OT-LSM-style *artifact* volume for the athena variant.

    Athena corrects images "from a badly calibrated system"
    (the original repository's ``models/axial_to_lateral_gan_athena_model.py:11-17``):
    each lateral (xy) plane is clean, but the stack across z carries the
    calibration damage — inter-plane misalignment and per-plane intensity
    flicker — which is invisible within an xy slice and glaring in the
    yz/xz views.  That is exactly the regime athena's six slice-wise
    discriminators (clean-plane real vs damaged-plane fake) are built for.

    Degradation model, applied plane-by-plane along z to the bead GT:
      1. mild axial blur (sigma_z = axial_sigma) — residual calibration
         smear between adjacent planes;
      2. per-plane subpixel translation following a clipped random walk
         (steps sigma = jitter_step px, |offset| <= jitter_px) — stage
         drift / galvo miscalibration;
      3. per-plane multiplicative gain 1 + N(0, flicker_sigma) —
         illumination flicker;
      4. Poisson shot noise + Gaussian read noise.

    Returns (input_corrupted, ground_truth, rotated_gt) like
    generate_bead_volume.
    """
    from scipy.ndimage import shift as nd_shift

    rng = np.random.default_rng(seed)
    gt = _splat_beads(rng, shape, n_beads, bead_sigma_range, intensity_range)

    vol = _gaussian_blur_separable(gt, (axial_sigma, 0.0, 0.0))

    z = shape[0]
    steps = rng.normal(0.0, jitter_step, (z, 2))
    offsets = np.clip(np.cumsum(steps, axis=0), -jitter_px, jitter_px)
    offsets -= offsets.mean(axis=0)  # zero net drift: keep content in frame
    gains = 1.0 + rng.normal(0.0, flicker_sigma, z)
    out = np.empty_like(vol)
    for k in range(z):
        plane = nd_shift(vol[k], offsets[k], order=1, mode="constant")
        out[k] = plane * max(gains[k], 0.0)

    noisy = rng.poisson(np.clip(out, 0, None) * poisson_peak) / poisson_peak
    noisy = noisy + rng.normal(0.0, gauss_noise, noisy.shape)
    noisy = np.clip(noisy, 0.0, 1.0)

    rotated = np.rot90(gt, k=1, axes=(0, 1))
    scale = np.iinfo(dtype).max if np.issubdtype(dtype, np.integer) else 1.0
    conv = lambda v: (v * scale).astype(dtype)
    return conv(noisy), conv(gt), conv(np.ascontiguousarray(rotated))


def _gaussian_blur_separable(vol: np.ndarray, sigmas) -> np.ndarray:
    """Separable Gaussian blur (scipy's 1D filter per axis)."""
    from scipy.ndimage import gaussian_filter1d

    out = vol
    for ax, s in enumerate(sigmas):
        if s > 0:
            out = gaussian_filter1d(out, s, axis=ax, mode="constant")
    return out


def digest(volumes) -> str:
    """sha256 over the volumes' shapes, dtypes and bytes, in order: the
    fingerprint of a generated trio (input, ground truth, rotated)."""
    import hashlib

    h = hashlib.sha256()
    for v in volumes:
        v = np.ascontiguousarray(v)
        h.update(f"{v.shape}{v.dtype.str}".encode())
        h.update(v.data)
    return h.hexdigest()
