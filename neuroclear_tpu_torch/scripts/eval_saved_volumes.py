"""Quality metrics from saved volumes, on the host: the port of
``scripts/eval_saved_volumes.py``.

The protocol rows repeat ``test_dice``'s metric path (the input stretched
between its ``--sat_level`` percentiles as ``--normalize_intensity``
inference stretched the output, then the double standardize and min-max to
uint8, PSNR at data range 255, and the chunked SSIM); the raw rows follow
(no percentile stretch: ``diagnose_quality.report`` on stride-subsampled
volumes).  The saved output already carries the inference-time stretch, so
its raw row measures the stretched output against the raw ground truth.

    python -m neuroclear_tpu_torch.scripts.eval_saved_volumes --input <raw_input.tif> \
        --output <saved_output.tif> --gt <gt.tif> [--sat_level 0.25 99.75]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..utils import imageops, tiffio
from .diagnose_quality import report, to_f32


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Quality metrics from saved volumes.")
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--gt", required=True)
    ap.add_argument("--sat_level", type=float, nargs=2, default=[0.25, 99.75])
    ap.add_argument("--stride", type=int, default=2,
                    help="subsample stride for the raw-row statistics")
    ap.add_argument("--thresh", type=float, default=0.05)
    return ap


def main(argv=None) -> dict:
    """Print the protocol rows, then the raw rows; returns them."""
    args = build_parser().parse_args(argv)
    raw_in = tiffio.imread(args.input)
    gt = tiffio.imread(args.gt)
    out = tiffio.imread(args.output)

    # the input gets the stretch that the inference applied to the output
    scale = float(np.iinfo(raw_in.dtype).max) if np.issubdtype(
        raw_in.dtype, np.integer) else 1.0
    real_f = raw_in.astype(np.float32) / scale
    p1, p99 = np.percentile(real_f, tuple(args.sat_level))
    real = imageops.rescale_intensity(real_f, in_range=(p1, p99))
    real = (real * (2 ** 16 - 1)).astype(np.uint16)
    del real_f

    fake = out
    gt_v = gt
    for _ in range(2):
        real = imageops.normalize(imageops.standardize(real), np.uint8)
        fake = imageops.normalize(imageops.standardize(fake), np.uint8)
        gt_v = imageops.normalize(imageops.standardize(gt_v), np.uint8)
    rows = {"psnr_input": imageops.get_psnr(real, gt_v, 255),
            "ssim_input": imageops.get_ssim(real, gt_v, 255),
            "psnr_output": imageops.get_psnr(fake, gt_v, 255),
            "ssim_output": imageops.get_ssim(fake, gt_v, 255)}
    print("== protocol rows (test_dice compute_gt_metrics parity) ==")
    print(f"input  vs GT: psnr {rows['psnr_input']:.4f}  ssim {rows['ssim_input']:.4f}")
    print(f"output vs GT: psnr {rows['psnr_output']:.4f}  ssim {rows['ssim_output']:.4f}",
          flush=True)
    del real, fake, gt_v

    s = args.stride
    gt_f = to_f32(gt)[::s, ::s, ::s]
    z, y, x = gt_f.shape
    print(f"== raw rows (stride-{s} statistics, no percentile stretch) ==")
    inp_f = to_f32(raw_in)[::s, ::s, ::s][:z, :y, :x]
    rows["input"] = report("input", inp_f, gt_f, args.thresh)
    del inp_f
    out_f = to_f32(out)[::s, ::s, ::s][:z, :y, :x]
    rows["output"] = report("output", out_f, gt_f, args.thresh)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
