"""Quality diagnostics for the simulation study: the port of
``scripts/diagnose_quality.py``.  It decomposes where the output differs
from the ground truth, beyond the single PSNR of ``test_dice``.

Reports, for input against ground truth and output against ground truth:
  * protocol PSNR (standardize, then min-max to uint8, twice, as the
    original ``test_dice`` does) and the affine-optimal PSNR (the best
    a*x+b fit: the bound any global intensity correction could reach);
  * the per-axis gradient energy (axial/lateral sharpness isotropy; the
    ground truth's ratio is ~1.0);
  * the Pearson correlation with the ground truth;
  * foreground and background RMS (the ground truth above ``--thresh`` is
    the foreground): hallucination and noise, bead fidelity.

    python -m neuroclear_tpu_torch.scripts.diagnose_quality --input <in.tif> \
        --output <out.tif> --gt <gt.tif> [--thresh 0.05] [--stride 0]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..utils import imageops, tiffio


def to_f32(v):
    v = np.asarray(v)
    if np.issubdtype(v.dtype, np.integer):
        return v.astype(np.float32) / np.iinfo(v.dtype).max
    return v.astype(np.float32)


def protocol_psnr(a, b):
    """The original repository's metric protocol: standardize + min-max to
    uint8, twice, then PSNR at data range 255."""
    for _ in range(2):
        a = imageops.normalize(imageops.standardize(a), data_type=np.uint8)
        b = imageops.normalize(imageops.standardize(b), data_type=np.uint8)
    return imageops.get_psnr(a, b, 255)


def affine_optimal_psnr(x, gt):
    """PSNR after the globally optimal affine map a*x+b -> gt (least
    squares): structural error apart from intensity drift."""
    x = x.ravel().astype(np.float64)
    g = gt.ravel().astype(np.float64)
    vx = x.var()
    a = ((x * g).mean() - x.mean() * g.mean()) / max(vx, 1e-12)
    b = g.mean() - a * x.mean()
    mse = np.mean((a * x + b - g) ** 2)
    rng = g.max() - g.min()
    return 10 * np.log10(rng * rng / max(mse, 1e-20))


def gradient_energy(v):
    """Mean squared finite difference along each axis (z, y, x)."""
    return [float(np.mean(np.diff(v, axis=ax) ** 2)) for ax in range(3)]


def report(tag, x, gt, thresh):
    pp = protocol_psnr(x, gt)
    ap = affine_optimal_psnr(x, gt)
    corr = float(np.corrcoef(x.ravel(), gt.ravel())[0, 1])
    gz, gy, gx = gradient_energy(x)
    iso = gz / (0.5 * (gy + gx) + 1e-20)
    fg = gt > thresh
    bg_rms = float(np.sqrt(np.mean((x[~fg] - gt[~fg]) ** 2)))
    fg_rms = float(np.sqrt(np.mean((x[fg] - gt[fg]) ** 2))) if fg.any() else 0.0
    print(f"{tag:>8}: protocolPSNR {pp:6.2f}  affine-optPSNR {ap:6.2f}  "
          f"corr {corr:.4f}  axial/lateral-grad {iso:.3f}  "
          f"bgRMS {bg_rms:.4f}  fgRMS {fg_rms:.4f}  "
          f"[mean {x.mean():.4f} std {x.std():.4f}]", flush=True)
    return {"protocol_psnr": pp, "affine_psnr": ap, "corr": corr, "iso": iso,
            "bg_rms": bg_rms, "fg_rms": fg_rms}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Quality diagnostics against a ground truth.")
    ap.add_argument("--input", required=False)
    ap.add_argument("--output", required=True)
    ap.add_argument("--gt", required=True)
    ap.add_argument("--thresh", type=float, default=0.05)
    ap.add_argument("--stride", type=int, default=0,
                    help="subsample stride for the statistics (0 = auto: "
                         "2 for volumes over 400^3); PSNRs remain "
                         "representative, not bit-identical to test_dice")
    return ap


def main(argv=None) -> dict:
    """Print the rows; returns {"input": report or None, "output": report}."""
    args = build_parser().parse_args(argv)
    gt = to_f32(tiffio.imread(args.gt))
    out = to_f32(tiffio.imread(args.output))
    z, y, x = (min(a, b) for a, b in zip(gt.shape, out.shape))
    s = args.stride or (2 if min(z, y, x) > 400 else 1)
    if s > 1:
        print(f"(stride-{s} subsample for statistics)")
    gt = gt[:z:s, :y:s, :x:s]
    out = out[:z:s, :y:s, :x:s]
    z, y, x = gt.shape
    gt_c = gt[:z, :y, :x]
    print(f"volumes: gt {gt.shape} out {out.shape} -> compared {(z, y, x)}")
    ggz, ggy, ggx = gradient_energy(gt_c)
    print(f"      gt: axial/lateral-grad {ggz / (0.5 * (ggy + ggx)):.3f}  "
          f"[mean {gt_c.mean():.4f} std {gt_c.std():.4f}]", flush=True)
    rows = {"input": None}
    if args.input:
        inp = to_f32(tiffio.imread(args.input))
        inp = inp[:inp.shape[0]:s, :inp.shape[1]:s, :inp.shape[2]:s][:z, :y, :x]
        rows["input"] = report("input", inp, gt_c, args.thresh)
    rows["output"] = report("output", out[:z, :y, :x], gt_c, args.thresh)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
