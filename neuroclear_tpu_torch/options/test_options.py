"""Options of the port's ``test_dice`` entry point: the flags of the JAX
package's ``options/test_options.py`` (and the base options it reads) that
tiled inference uses, under the same names and defaults, plus ``--device``.
The JAX options module cannot be reused: it imports the JAX model and
dataset registries.

Every flag of JAX's ``test_dice.py`` parses, under its name and with its
default, but ``--dataset_mode``'s: JAX's ``single`` names no dataset of
either package, so the port defaults to ``diceImage``.  ``--model`` takes
JAX's ``test`` (the single generator ``G{model_suffix}``) or a GAN model's
name, with that model's test-time options in place of ``--model_suffix``
(its G_A infers; its G_B, where it has one, is loaded too), as JAX's
``test_dice.py`` does; other names are refused with a pointer to
ROADMAP.md, as are other values whose paths are not ported
(``check_ported``).  ``--add_date`` prefixes the name with the
date stamp, as every JAX test run does with it; ``--verbose`` prints the
generator; ``--batch_size`` is forced to 1 by the CLI.  Flags the JAX CLI
parses only for parity with the original repository, or that inference
does not read (the init scheme of weights that a checkpoint replaces, the
discriminator's, the crop and the training chain's), are accepted and
change nothing here either.
"""

from __future__ import annotations

import argparse
import os
import time

from .. import models
from ..models.axial_to_lateral_gan_apollo_model import GAN_NET_G
from ..nn.norms import NORMS
from ..parallel import train_parallel
from ..utils.weights import INIT_TYPES
from . import (ROADMAP, UNREAD_TEST, add_gpu_ids, add_jax_flags, apply_jax_flags, date_stamp,
               device_of, refuse_other_values)
from . import print_options as _print_options

# value flags whose other values select paths the port does not have; the
# generators are the 3D one-output nets with which the JAX test_dice.py runs
# (the GAN models' set: the two-headed, 2D and PSF nets do not run there).
# --ngf, --input_nc and --output_nc take any value: these nets read no --ngf
# and no --input_nc, and the checkpoint loaded sets the output channels, so
# JAX's test_dice.py runs them as it runs the defaults.  --image_dimension
# builds JAX's test model (2 fails on the volume's tiles); a GAN model's name
# does not read it.
PORTED_VALUES = {"netG": GAN_NET_G, "dataset_mode": ("diceImage", "simulationcrop"),
                 "image_dimension": (3,), "norm": NORMS}
# JAX's test model and the GAN models, whose names JAX's test_dice.py runs
PORTED_MODELS = {"model": ("test", *models.PORTED)}


# flags of the JAX base options that its inference path never reads
UNREAD_BY_INFERENCE = {"--init_gain": dict(type=float, default=0.02),
                       "--netD": dict(default="basic"),
                       "--ndf": dict(type=int, default=64),
                       "--n_layers_D": dict(type=int, default=3),
                       "--batch_size": dict(type=int, default=1),
                       "--crop_size": dict(type=int, nargs="+", default=[0, 0, 0]),
                       "--host_augment": dict(action="store_true"),
                       "--display_histogram": dict(action="store_true"),
                       "--profile_dir": dict(default=None)}


def build_parser(argv=None) -> argparse.ArgumentParser:
    """test_dice's parser with the options of the model ``argv``'s
    ``--model`` names, as ``TestOptions.gather_options`` adds them:
    ``--model_suffix`` for the test model, a GAN model's test-time options
    (its option setter with ``is_train`` False) for its name.  Another name
    is refused with a pointer to ROADMAP.md."""
    p = base_parser()
    known, _ = p.parse_known_args(["--dataroot", "", *(argv or [])])
    refuse_other_values(known, PORTED_MODELS)
    if known.model != "test":
        return models.get_option_setter(known.model)(p, is_train=False)
    p.add_argument("--model_suffix", default="",
                   help="loads [epoch]_net_G[model_suffix].npz")
    return p


def base_parser() -> argparse.ArgumentParser:
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
    p.add_argument("--model", default="test",
                   help="test: the single generator G[model_suffix]; or a GAN model's name: "
                        "its G_A (and its G_B, loaded too)")
    p.add_argument("--add_date", action="store_true",
                   help="prefix the name with a YYYYmmdd-HHMM stamp (the results and the "
                        "checkpoint directories move with it)")
    p.add_argument("--verbose", action="store_true", help="print the generator")
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
                   help="eval mode: a --norm batch generator normalises with its running "
                        "statistics; without it, each tile batch (or cube) by its own, so the "
                        "output depends on --tile_batch (no effect on the other norms)")
    # the per-cube host loop
    p.add_argument("--legacy_pipeline", action="store_true",
                   help="run each cube through the model on its own and assemble them on the "
                        "host (Assemble_Dice), in float32")
    p.add_argument("--histogram_match", action="store_true",
                   help="match each output cube's histogram to its input cube's (runs the "
                        "per-cube loop)")
    p.add_argument("--num_threads", type=int, default=8,
                   help="no effect: the CLI sets 0, as test_dice.py does; taken so that a "
                        "JAX command line parses")
    p.add_argument("--max_dataset_size", type=int, default=float("inf"),
                   help="at most this many cubes are loaded")
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
    p.add_argument("--aspect_ratio", type=float, default=1.0,
                   help="no effect (the JAX package does not apply it either); taken so "
                        "that a JAX command line parses")
    # the generator
    p.add_argument("--netG", default="unet_deconv",
                   help="unet_vanilla needs tiles (dice_size + 2 border_cut) that are "
                        "multiples of 8")
    p.add_argument("--norm", default="instance")
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--input_nc", type=int, default=1, help="channels of the input (unread)")
    p.add_argument("--output_nc", type=int, default=1,
                   help="channels of the output (the checkpoint sets them)")
    p.add_argument("--no_dropout", action="store_true",
                   help="no effect: the generator has no dropout; taken so that a JAX "
                        "command line parses")
    p.add_argument("--init_type", default="normal", choices=INIT_TYPES,
                   help="no effect: the checkpoint's weights replace the initial ones")
    for flag, kw in UNREAD_BY_INFERENCE.items():
        p.add_argument(flag, **kw, help="no effect on inference; taken so that a JAX command "
                                        "line parses")
    p.add_argument("--seed", type=int, default=None,
                   help="no effect: inference draws nothing; taken so that a JAX command "
                        "line parses")
    p.add_argument("--num_test", type=int, default=3000,
                   help="no effect (the JAX CLI keeps it for parity only)")
    p.add_argument("--dataset_mode", default="diceImage",
                   help="diceImage, or simulationcrop: the fixed 700^3 crop at (136, 104, 120) "
                        "of the volume")
    p.add_argument("--image_dimension", type=int, default=3)
    p.add_argument("--preprocess", default="none",
                   help="transform chain of the per-cube loader (not used by the fused path)")
    p.add_argument("--serial_batches", action="store_true",
                   help="no effect: the loader always iterates in file order (test_dice.py "
                        "sets it); taken so that a JAX command line parses")
    add_gpu_ids(p)
    add_jax_flags(p, UNREAD_TEST)
    p.set_defaults(load_size=[0, 0, 0])  # JAX's test parser: its --crop_size default
    return p


def check_ported(opt) -> None:
    """Raise NotImplementedError for an option whose path is not ported."""
    refuse_other_values(opt, {k: v for k, v in PORTED_VALUES.items()
                              if k != "image_dimension" or opt.model == "test"})
    if getattr(opt, "netG_B", GAN_NET_G[0]) not in GAN_NET_G:
        raise NotImplementedError(f"--netG_B {opt.netG_B} is not ported yet {ROADMAP}; the "
                                  f"port takes {GAN_NET_G}")
    device_of(opt)
    if not opt.dice_size or opt.dice_size[0] <= 0:
        raise ValueError("--dice_size must be given, e.g. --dice_size 120 120 120")


def parse(argv=None):
    """Parse and check: a ``--model`` the port does not run is refused
    before its flags are parsed.  ``--add_date`` prefixes the name with the date
    stamp (rank 0's where a process group is up), then ``--suffix`` extends it, and
    ``--direction`` is read by no inference path, as in JAX."""
    opt = build_parser(argv).parse_args(argv)
    check_ported(opt)
    if opt.add_date:
        opt.name = date_stamp(train_parallel.broadcast_int(int(time.time()))) + "_" + opt.name
    apply_jax_flags(opt, refuse_btoa=False)
    return opt


def print_options(opt) -> None:
    """Print the options and write them to ``{phase}_opt.txt`` under the
    results folder, as ``BaseOptions.print_options`` writes them."""
    name = opt.name if opt.data_name is None else f"{opt.data_name}_by_{opt.name}"
    _print_options(opt, build_parser(["--model", opt.model]),
                   os.path.join(opt.results_dir, name, f"{opt.phase}_opt.txt"))
