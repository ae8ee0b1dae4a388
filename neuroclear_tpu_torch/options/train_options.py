"""Options of the port's single-volume trainer: the flags of the JAX
package's ``options/base_options.py`` and ``options/train_options.py`` that
the production Apollo command and its resume use, under the same names and
defaults, plus ``--device``.  The JAX options modules cannot be reused: they
import the JAX model and dataset registries.

The defaults are the JAX CLI's, except where the port does not take the JAX
default (``--model``, ``--init_type``, ``--crop_size``, ``--preprocess``,
``--seed``): there they are the production configuration's, and a fixed
seed; ``--precision`` defaults to bfloat16, the JAX package's training
benchmark default.  Options whose paths are not ported are refused by
``check_options`` with a pointer to ROADMAP.md.
"""

from __future__ import annotations

import argparse
import datetime
import os

from ..data.singlevolume_dataset import check_preprocess

NOT_PORTED = "is not ported yet (ROADMAP.md, queue 1)"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Single-volume Apollo trainer (the port of train_onecube.py).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    # data, names and checkpoints
    p.add_argument("--dataroot", required=True,
                   help="training volume: a directory holding it (TIFF or .npy; the first "
                        "in sorted order is used), or the file itself")
    p.add_argument("--name", default="experiment_name", help="experiment name")
    p.add_argument("--checkpoints_dir", default="./checkpoints")
    p.add_argument("--add_date", action="store_true",
                   help="prefix the experiment name with a YYYYmmdd-HHMM stamp (not with "
                        "--continue_train)")
    p.add_argument("--dataset_mode", default="singlevolume")
    p.add_argument("--preprocess",
                   default="random3Drotate_randomcrop_randomflip_addColorChannel_addBatchChannel")
    p.add_argument("--crop_size", type=int, nargs=3, default=[108, 108, 108])
    p.add_argument("--batch_size", type=int, default=1)
    # the model
    p.add_argument("--model", default="axial_to_lateral_gan_apollo")
    p.add_argument("--netG", default="unet_deconv")
    p.add_argument("--netG_B", default="deep_linear_gen")
    p.add_argument("--netD", default="basic")
    p.add_argument("--norm", default="instance")
    p.add_argument("--init_type", default="kaiming")
    p.add_argument("--gan_mode", default="vanilla", help="vanilla | lsgan | wgangp")
    p.add_argument("--lambda_A", type=float, default=10.0)
    p.add_argument("--lambda_plane", type=int, nargs="+", default=[1, 1, 1])
    p.add_argument("--randomize_projection_depth", action="store_true")
    p.add_argument("--projection_depth", type=int, default=10)
    p.add_argument("--precision", default="bfloat16", choices=["float32", "bfloat16"],
                   help="compute dtype; parameters and Adam stay float32")
    # the optimizer and its schedule
    p.add_argument("--beta1", type=float, default=0.1)
    p.add_argument("--lr", type=float, default=0.0001)
    p.add_argument("--lr_policy", default="linear",
                   help="rate schedule [linear | constant | step | plateau | cosine]")
    p.add_argument("--n_epochs", type=int, default=50000000,
                   help="iterations at the initial rate before the linear decay starts")
    p.add_argument("--n_epochs_decay", type=int, default=100,
                   help="iterations over which the linear policy anneals the rate to zero")
    p.add_argument("--lr_decay_iters", type=int, default=50,
                   help="period of the step policy's 0.1x decay")
    p.add_argument("--epoch_count", type=int, default=1,
                   help="schedule position to start counting from")
    # resume
    p.add_argument("--continue_train", action="store_true",
                   help="resume from a checkpoint and its optimizer state (--epoch/--load_iter)")
    p.add_argument("--epoch", default="latest", help="checkpoint suffix to load")
    p.add_argument("--load_iter", type=int, default=0,
                   help="when > 0, load the iter_<N> checkpoint instead of --epoch")
    # the loop and its reporting
    p.add_argument("--max_iters", type=int, default=0,
                   help="stop after this many iterations (0 = run until stopped)")
    p.add_argument("--print_freq", type=int, default=500,
                   help="iterations between console loss lines (also the device sync point)")
    p.add_argument("--display_freq", type=int, default=100,
                   help="iterations between TensorBoard figure refreshes")
    p.add_argument("--display_histogram", action="store_true",
                   help="log intensity histograms of the visuals to TensorBoard")
    p.add_argument("--save_latest_freq", type=int, default=500)
    p.add_argument("--save_by_iter", action="store_true",
                   help="name checkpoints iter_<N> instead of overwriting 'latest'")
    p.add_argument("--nan_check", action="store_true",
                   help="at --print_freq, save nan_debug checkpoints and exit 3 if a loss is "
                        "not finite")
    p.add_argument("--watchdog_secs", type=int, default=0,
                   help="exit 42 if no iteration completes for this many seconds (armed "
                        "after the first); resume with --continue_train --load_iter")
    p.add_argument("--verbose", action="store_true", help="print the networks")
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the weights, the crops and the probe draws")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # not ported, refused
    p.add_argument("--remat", action="store_true", help=f"activation recomputation {NOT_PORTED}")
    p.add_argument("--grad_accum", type=int, default=1, help=f"values > 1 {NOT_PORTED}")
    return p


def check_options(opt) -> None:
    """Raise NotImplementedError for every option whose path is not ported."""
    refused = [
        (opt.model != "axial_to_lateral_gan_apollo", f"--model {opt.model}"),
        (opt.dataset_mode != "singlevolume", f"--dataset_mode {opt.dataset_mode}"),
        (opt.remat, "--remat"),
        (opt.grad_accum > 1, "--grad_accum > 1"),
        (opt.batch_size != 1, "--batch_size > 1"),
        (opt.init_type != "kaiming", f"--init_type {opt.init_type}"),
        (opt.netD != "basic", f"--netD {opt.netD}"),
        (opt.norm != "instance", f"--norm {opt.norm}"),
    ]
    for bad, what in refused:
        if bad:
            raise NotImplementedError(f"{what} {NOT_PORTED}")
    check_preprocess(opt.preprocess)


def parse(argv=None):
    """Parse and check; with ``--add_date`` (and not ``--continue_train``)
    the name gets its date prefix, as ``BaseOptions.parse`` gives it."""
    opt = build_parser().parse_args(argv)
    check_options(opt)
    if opt.add_date and not opt.continue_train:
        opt.name = datetime.datetime.now().strftime("%Y%m%d-%H%M") + "_" + opt.name
    return opt


def print_options(opt) -> None:
    """Print the options, marking those off their defaults, and write them
    to ``<checkpoints_dir>/<name>/train_opt.txt``."""
    parser = build_parser()
    lines = ["----------------- Options ---------------"]
    for k, v in sorted(vars(opt).items()):
        default = parser.get_default(k)
        comment = f"\t[default: {default}]" if v != default else ""
        lines.append("{:>25}: {:<30}{}".format(str(k), str(v), comment))
    lines.append("----------------- End -------------------")
    message = "\n".join(lines)
    print(message, flush=True)
    expr_dir = os.path.join(opt.checkpoints_dir, opt.name)
    os.makedirs(expr_dir, exist_ok=True)
    with open(os.path.join(expr_dir, "train_opt.txt"), "wt") as f:
        f.write(message + "\n")
