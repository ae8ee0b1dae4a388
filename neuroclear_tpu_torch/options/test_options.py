"""Options of the port's ``test_dice`` entry point: the flags of the JAX
package's ``options/test_options.py`` (and the base options it reads) that
the tiled inference path uses, under the same names and defaults, plus
``--device``.  The JAX options module cannot be reused: it imports the JAX
model and dataset registries.

Flags whose paths are not ported are refused by ``check_ported`` with a
pointer to ROADMAP.md; flags the JAX CLI parses only for parity with the
original repository are accepted and change nothing here either.
"""

from __future__ import annotations

import argparse

# value flags whose other values select paths the port does not have
PORTED_VALUES = {"netG": ("unet_deconv",), "dataset_mode": ("diceImage",),
                 "image_dimension": (3,)}
# switches that select paths the port does not have
UNPORTED_SWITCHES = ("legacy_pipeline", "histogram_match")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Tiled inference with a trained generator, TIFF in and out, "
                    "PSNR/SSIM against a ground truth.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    # data and checkpoints
    p.add_argument("--dataroot", required=True,
                   help="directory holding the input volume (TIFF or .npy); the first "
                        "in sorted order is used")
    p.add_argument("--dataroot_gt", default=None,
                   help="directory with the ground-truth volume for PSNR/SSIM")
    p.add_argument("--name", default="experiment_name", help="experiment name")
    p.add_argument("--checkpoints_dir", default="./checkpoints")
    p.add_argument("--results_dir", default="./results/")
    p.add_argument("--epoch", default="latest", help="checkpoint suffix to load")
    p.add_argument("--load_iter", type=int, default=0,
                   help="when > 0, load the iter_<N> checkpoint instead of --epoch")
    p.add_argument("--model_suffix", default="",
                   help="loads [epoch]_net_G[model_suffix].npz")
    p.add_argument("--data_name", default=None,
                   help="dataset label used to compose the results folder name")
    p.add_argument("--phase", default="test", help="run phase label in the results folder")
    # the tile pipeline
    p.add_argument("--dice_size", type=int, nargs="+", default=[0, 0, 0],
                   help="tile size; the first entry is used, as in test_dice.py")
    p.add_argument("--overlap", type=int, default=0)
    p.add_argument("--border_cut", type=int, default=0)
    p.add_argument("--tile_batch", type=int, default=2)
    p.add_argument("--precision", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--repetition", action="store_true",
                   help="flip-TTA: infer flipped copies of each tile and average")
    p.add_argument("--eval", action="store_true",
                   help="eval mode (the instance-norm generator has no state it changes)")
    # post-processing and outputs
    p.add_argument("--data_type", default="uint16",
                   help="output dtype: uint16 or uint8 (anything else: float in [0, 1])")
    p.add_argument("--normalize_intensity", action="store_true",
                   help="percentile-rescale the assembled volume (see --sat_level)")
    p.add_argument("--sat_level", type=float, nargs="+", default=[0.25, 99.75],
                   help="low/high percentile saturations for --normalize_intensity")
    p.add_argument("--save_volume", action="store_true",
                   help="write the assembled 3D volume as TIFF")
    p.add_argument("--save_projections", action="store_true",
                   help="write max-intensity projections of the result")
    p.add_argument("--save_slices", action="store_true",
                   help="write every 2D slice of the result as TIFF")
    p.add_argument("--skip_real", action="store_true",
                   help="do not save the input volume/slices (metrics still use them)")
    # one generator and one dataset are ported
    p.add_argument("--netG", default="unet_deconv")
    p.add_argument("--dataset_mode", default="diceImage")
    p.add_argument("--image_dimension", type=int, default=3)
    # parsed for parity with the JAX CLI; no effect on the fused path
    p.add_argument("--preprocess", default="none",
                   help="transform chain of the per-cube loader (not used by the fused path)")
    p.add_argument("--serial_batches", action="store_true",
                   help="iterate in file order (the fused path always does)")
    # unported paths, refused
    p.add_argument("--legacy_pipeline", action="store_true",
                   help="the per-cube host loop (not ported)")
    p.add_argument("--histogram_match", action="store_true",
                   help="per-tile histogram matching (not ported)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def check_ported(opt) -> None:
    """Raise NotImplementedError for an option whose path is not ported."""
    for flag in UNPORTED_SWITCHES:
        if getattr(opt, flag):
            raise NotImplementedError(f"--{flag} is not ported yet (ROADMAP.md, queue 1 "
                                      "item 1)")
    for flag, values in PORTED_VALUES.items():
        if getattr(opt, flag) not in values:
            raise NotImplementedError(f"--{flag} {getattr(opt, flag)} is not ported yet "
                                      f"(ROADMAP.md, queue 1); the port takes {values}")
    if not opt.dice_size or opt.dice_size[0] <= 0:
        raise ValueError("--dice_size must be given, e.g. --dice_size 120 120 120")


def parse(argv=None):
    opt = build_parser().parse_args(argv)
    check_ported(opt)
    return opt
