"""Generate a synthetic bead simulation dataset (input, ground truth and
rotated volumes): the port of ``scripts/generate_synthetic.py``, with its
flags and defaults.

    python -m neuroclear_tpu_torch.scripts.generate_synthetic --out <dir> \
        --size 300 --seed 0 [--preset s4] [--mode artifact]

writes ``<out>/input/bead_input.tif`` (the blurred and noisy training
volume), ``<out>/gt/bead_gt.tif`` (the sharp isotropic ground truth) and
``<out>/rotated/bead_rotated.tif`` (the ground truth rotated by 90 degrees),
uint16, through the port's numpy TIFF writer.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..utils import tiffio
from ..utils.synthetic import generate_artifact_volume, generate_bead_volume

FILES = (("input", "bead_input.tif"), ("gt", "bead_gt.tif"), ("rotated", "bead_rotated.tif"))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--mode", choices=["bead", "artifact"], default="bead",
                    help="bead: axially blurred+noisy volume (apollo/dryops "
                         "isotropization study); artifact: per-plane jitter"
                         "+flicker OT-LSM calibration damage (athena study)")
    ap.add_argument("--size", type=int, default=300)
    ap.add_argument("--n_beads", type=int, default=None)
    ap.add_argument("--axial_sigma", type=float, default=None,
                    help="PSF sigma_z (default 6.0 bead / 2.0 artifact)")
    ap.add_argument("--jitter_px", type=float, default=2.0,
                    help="artifact mode: max per-plane translation (px)")
    ap.add_argument("--flicker_sigma", type=float, default=0.15,
                    help="artifact mode: per-plane gain sigma")
    ap.add_argument("--gauss_noise", type=float, default=0.01,
                    help="read-noise sigma (fraction of full scale)")
    ap.add_argument("--poisson_peak", type=float, default=200.0,
                    help="photon count at intensity 1.0 (higher = less shot noise)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--preset", choices=["s4"], default=None,
                    help="named study recipe (overrides individual knobs): s4 = sigma_z=4 / "
                         "2x bead density / half read noise / 2x photon count")
    return ap


def generate(args):
    """(input, ground truth, rotated) uint16 volumes for parsed ``args``,
    the s4 preset and the bead-count rule applied as the JAX script applies
    them."""
    if args.preset == "s4":
        args.axial_sigma = 4.0
        args.gauss_noise = 0.005
        args.poisson_peak = 400.0
        if args.n_beads is None:
            args.n_beads = max(50, int(2400 * (args.size / 300) ** 3))
    n_beads = args.n_beads
    if n_beads is None:
        n_beads = max(50, int(1200 * (args.size / 300) ** 3))
    shape = (args.size,) * 3
    if args.mode == "artifact":
        return generate_artifact_volume(
            shape=shape, n_beads=n_beads,
            axial_sigma=(2.0 if args.axial_sigma is None else args.axial_sigma),
            jitter_px=args.jitter_px, flicker_sigma=args.flicker_sigma,
            gauss_noise=args.gauss_noise, poisson_peak=args.poisson_peak, seed=args.seed)
    return generate_bead_volume(
        shape=shape, n_beads=n_beads,
        axial_sigma=(6.0 if args.axial_sigma is None else args.axial_sigma),
        gauss_noise=args.gauss_noise, poisson_peak=args.poisson_peak, seed=args.seed)


def main(argv=None) -> list:
    """Generate and write the three TIFFs; returns their paths."""
    args = build_parser().parse_args(argv)
    paths = [os.path.join(args.out, sub, name) for sub, name in FILES]
    for path, vol in zip(paths, generate(args)):
        tiffio.imwrite(path, vol)
    print(f"wrote {args.size}^3 synthetic dataset to {args.out}", flush=True)
    return paths


if __name__ == "__main__":
    main(sys.argv[1:])
