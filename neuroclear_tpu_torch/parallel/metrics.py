"""Whole-volume PSNR and SSIM against a ground truth, slab-streamed on the
card: the port of ``neuroclear_tpu/parallel/metrics.py``.

The protocol is ``test_dice.compute_gt_metrics``'s: two rounds of
standardize + normalize to uint8, PSNR with data range 255, and the mean
valid-window SSIM (window 7, box mean).

* The quantisation stays in host float64, as a 65536-entry lookup table of
  the value domain built from the same np.mean/np.std/np.min/np.max
  statistics the host path takes, so lut[vol] is the host path's volume bit
  for bit (``_round_lut``).
* The square-error sums and the SSIM map run in torch on the given device in
  f32, over haloed z-slabs of the quantised volumes; the per-plane sums are
  added on the host in float64.

``NEUROCLEAR_DEVICE_METRICS=0`` selects the host path, as in the JAX
package.  ``protocol_metrics`` takes uint8 and uint16 volumes only.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device

_WIN = 7  # SSIM window (utils/imageops.get_ssim's default)


def enabled() -> bool:
    return os.environ.get("NEUROCLEAR_DEVICE_METRICS", "1") != "0"


def supported(*vols) -> bool:
    """True when ``protocol_metrics`` takes these volumes: uint8 or uint16,
    3D, at least one SSIM window along every axis."""
    return all(v.dtype in (np.uint8, np.uint16) and v.ndim == 3 and min(v.shape) >= _WIN
               for v in vols)


# --- host: exact quantisation as a value-domain LUT --------------------------


def _round_lut(arr, domain):
    """uint8 LUT for one standardize+normalize round of `arr`: the exact
    float64 expressions of ``imageops.standardize`` and ``normalize`` on
    every representable input value, with the statistics from the same
    numpy calls the host path makes.  The map is monotonic, so lut[arr] is
    the host volume bit for bit; that matters, because the second round maps
    integers almost onto themselves and truncation turns a last-ulp
    difference into flips of whole value classes."""
    mean, std = np.mean(arr), np.std(arr)
    s = (domain - mean) / std
    smin, smax = s[int(np.min(arr))], s[int(np.max(arr))]
    out = (s - smin) * (255.0 / (smax - smin))
    return out.astype(np.uint8)


def _quant_lut(vol):
    """Value-domain uint8 LUT composing both protocol rounds of `vol`."""
    if vol.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"LUT quantisation needs uint8/uint16, got {vol.dtype}")
    vals = np.arange(np.iinfo(vol.dtype).max + 1, dtype=np.float64)
    lut1 = _round_lut(vol, vals)
    lut2 = _round_lut(lut1[vol], np.arange(256, dtype=np.float64))
    return lut2[lut1]


# --- device: per-plane sums of one slab ----------------------------------------


def _box_mean(x: torch.Tensor) -> torch.Tensor:
    """Separable 7^3 valid-window mean: three 1-D window sums, one divide."""
    for ax in range(3):
        x = x.unfold(ax, _WIN, 1).sum(-1)
    return x / float(_WIN ** 3)


def _ssim_plane_sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-window-start-plane sums of the local SSIM map (data range 255)."""
    c1 = (0.01 * 255.0) ** 2
    c2 = (0.03 * 255.0) ** 2
    mu_a, mu_b = _box_mean(a), _box_mean(b)
    saa = _box_mean(a * a) - mu_a * mu_a
    sbb = _box_mean(b * b) - mu_b * mu_b
    sab = _box_mean(a * b) - mu_a * mu_b
    ssim_map = ((2 * mu_a * mu_b + c1) * (2 * sab + c2)) / (
        (mu_a * mu_a + mu_b * mu_b + c1) * (saa + sbb + c2))
    return ssim_map.sum(dim=(1, 2))


def _pair_slab(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor):
    """Both pairs (a, g) and (b, g) of one haloed (zs + 6, Y, X) uint8 slab:
    per-plane square-error sums (every plane; the caller keeps the non-halo
    ones) and per-window-start SSIM sums (zs planes), in f32."""
    qa, qb, qg = a.float(), b.float(), g.float()
    sq_in = ((qa - qg) ** 2).sum(dim=(1, 2))
    sq_out = ((qb - qg) ** 2).sum(dim=(1, 2))
    return sq_in, sq_out, _ssim_plane_sums(qa, qg), _ssim_plane_sums(qb, qg)


@torch.inference_mode()
def protocol_metrics(real, fake, gt, slab: int = 48, device=None) -> dict:
    """The full protocol's PSNR and SSIM for (real, gt) and (fake, gt), the
    sums on ``device`` (the card unless the caller passes ``"cpu"``).
    Inputs are host volumes of uint8 or uint16 and identical 3D shapes.
    Returns {psnr_input, psnr_output, ssim_input, ssim_output}."""
    if not (real.ndim == 3 and real.shape == fake.shape == gt.shape
            and min(real.shape) >= _WIN):
        raise ValueError("device metrics need equal 3-D volumes >= win")
    dev = resolve_device(device)
    vols = (real, fake, gt)
    luts = [_quant_lut(v) for v in vols]

    z = real.shape[0]
    n_valid = z - _WIN + 1
    sq_in = sq_out = 0.0
    ss_in = ss_out = 0.0
    for w0 in range(0, n_valid, slab):
        last = w0 + slab >= n_valid
        w1 = n_valid if last else w0 + slab
        zs = slice(w0, z if last else w1 + _WIN - 1)
        a, b, g = (torch.from_numpy(np.ascontiguousarray(lut[v[zs]])).to(dev)
                   for lut, v in zip(luts, vols))
        sums = [s.double().cpu().numpy() for s in _pair_slab(a, b, g)]
        take = a.shape[0] if last else w1 - w0
        sq_in += float(sums[0][:take].sum())
        sq_out += float(sums[1][:take].sum())
        ss_in += float(sums[2].sum())
        ss_out += float(sums[3].sum())

    n = float(real.size)
    n_win = float(n_valid * (real.shape[1] - _WIN + 1) * (real.shape[2] - _WIN + 1))

    def psnr(sq):
        return 20 * np.log10(255.0) - 10 * np.log10(sq / n)

    return {"psnr_input": float(psnr(sq_in)),
            "psnr_output": float(psnr(sq_out)),
            "ssim_input": ss_in / n_win,
            "ssim_output": ss_out / n_win}
