"""Options of the port's two trainers (``train_onecube`` and the epoch
trainer ``train``): the flags of the JAX package's
``options/base_options.py`` and ``options/train_options.py`` that they
take, under the same names and defaults, plus ``--device``; each model's own
options come through the registry's option setter
(``models.get_option_setter``), as ``BaseOptions.gather_options`` adds
them.  The JAX options modules cannot be reused: they import the JAX model
and dataset registries.

The defaults are the JAX CLI's (``--precision float32``, ``--seed`` None:
a fresh seed per run, drawn from ``os.urandom`` and written to
``train_opt.txt``; ``--init_type normal``; ``--preprocess none`` and
``--crop_size 0 0 0``, which ``train_onecube`` runs on the host chain over
the whole volume, as JAX's does; ``--no_dropout`` set by each GAN model's
option setter), except where the JAX default names a model or dataset that
neither package has (``--model cycle_gan``, ``--dataset_mode braincube``):
there they are the production configuration's.  A flag whose value selects a
path that is not ported is refused by ``check_options`` with a pointer to
ROADMAP.md; flags the JAX CLI keeps only for parity (``--num_threads``,
``--no_dropout``, the tiling flags of the inference datasets, and those it
declares and never reads, ``options.UNREAD``) are taken and change nothing.
"""

from __future__ import annotations

import argparse
import os
import time

from .. import models
from ..data.base_dataset import check_host_preprocess
from ..models.axial_to_lateral_gan_apollo_model import GAN_NET_D, GAN_NET_G
from ..nn.norms import NORMS
from ..parallel import train_parallel
from ..utils.weights import INIT_TYPES
from . import (ROADMAP, UNREAD_TRAIN, add_gpu_ids, add_jax_flags, apply_jax_flags, date_stamp,
               device_of, refuse_other_values)
from . import print_options as _print_options

NOT_PORTED = f"is not ported yet {ROADMAP}"
# value flags the production nets fix (one channel in and out: the JAX
# models fail on other counts), and the nets and norms with which the JAX
# package's GAN models run; --ndf sizes the discriminators, and --ngf and
# --image_dimension take any value, as no JAX GAN model reads them
PORTED_VALUES = {"input_nc": (1,), "output_nc": (1,), "netG": GAN_NET_G, "netD": GAN_NET_D,
                 "norm": NORMS}
# the inference datasets, whose option setters add the tiling flags: a
# trainer refuses them (check_options), after its parser has taken their flags
TILED_DATASETS = ("diceImage", "simulationcrop")


def add_tiling_flags(p: argparse.ArgumentParser) -> None:
    """``--overlap`` and ``--border_cut``, as the JAX ``diceImage`` and
    ``simulationcrop`` datasets add them."""
    p.add_argument("--overlap", type=int, default=0, help="overlap of the tiles")
    p.add_argument("--border_cut", type=int, default=0,
                   help="border cut from each tile's output")


def build_parser(argv=None) -> argparse.ArgumentParser:
    """The trainers' parser with the options of the model that ``argv``'s
    ``--model`` names (Apollo's without it), added through the registry's
    option setter, and of its ``--dataset_mode``, as
    ``BaseOptions.gather_options`` adds them."""
    p = base_parser()
    known, _ = p.parse_known_args(["--dataroot", "", *(argv or [])])
    if known.dataset_mode in TILED_DATASETS:
        add_tiling_flags(p)
    return models.get_option_setter(known.model)(p)


def base_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="The trainers of the port (train_onecube.py and train.py).",
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
    p.add_argument("--preprocess", default="none",
                   help="the augmentation chain, e.g. the production run's "
                        "random3Drotate_randomcrop_randomflip_addColorChannel_addBatchChannel; "
                        "none (train_onecube then runs the host chain over the whole volume)")
    p.add_argument("--crop_size", type=int, nargs=3, default=[0, 0, 0],
                   help="z y x, read by randomcrop; a 0 keeps the whole axis (train_onecube "
                        "then runs the host chain)")
    p.add_argument("--host_augment", action="store_true",
                   help="train_onecube: cut each crop with the host chain instead of the "
                        "device chain")
    p.add_argument("--image_dimension", type=int, default=3, help="3: volumes")
    p.add_argument("--batch_size", type=int, default=1,
                   help="train: the loader's batch, split over the ranks under torchrun; "
                        "train_onecube: counts iterations (one crop per rank a step), as in JAX")
    p.add_argument("--serial_batches", action="store_true",
                   help="the epoch trainer takes the items in order (else shuffled)")
    p.add_argument("--max_dataset_size", type=int, default=float("inf"),
                   help="the epoch trainer takes at most this many items per epoch")
    # the model
    p.add_argument("--model", default="axial_to_lateral_gan_apollo")
    p.add_argument("--netG", default="unet_deconv")
    p.add_argument("--netD", default="basic")
    p.add_argument("--input_nc", type=int, default=1)
    p.add_argument("--output_nc", type=int, default=1)
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--ndf", type=int, default=64)
    p.add_argument("--n_layers_D", type=int, default=3,
                   help="depth of the n_layers and n_layers_SN discriminators (not read by "
                        "basic, as in JAX)")
    p.add_argument("--norm", default="instance",
                   help="instance | batch (running statistics refreshed after every step) | "
                        "none | spectral (both identity)")
    p.add_argument("--init_type", default="normal", choices=INIT_TYPES,
                   help="weight init scheme")
    p.add_argument("--init_gain", type=float, default=0.02,
                   help="std or gain of the normal, xavier and orthogonal inits")
    p.add_argument("--no_dropout", action="store_true",
                   help="no effect: these generators have no dropout; taken so that a JAX "
                        "command line parses (set by the GAN models, as in JAX)")
    p.add_argument("--precision", default="float32", choices=["float32", "bfloat16"],
                   help="compute dtype; parameters and Adam stay float32")
    p.add_argument("--remat", action="store_true",
                   help="recompute the generators' activations in the G loss's backward "
                        "(per conv unit and per U-Net block; the backward generator whole)")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="crops per optimizer step: the mean of their gradients at the "
                        "pre-update parameters, under one step's probe draws, then one Adam "
                        "update; each crop is cut just before its micro-step")
    p.add_argument("--fused_accum", action="store_true",
                   help="--grad_accum over the N crops cut first and resident together "
                        "(JAX's one-program form; the same micro-steps and update)")
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
    p.add_argument("--display_id", type=int, default=1,
                   help="<= 0 turns the loss plot (TensorBoard scalars) off")
    p.add_argument("--no_html", action="store_true",
                   help="write no web/ folder: no TIFF snapshots, no HTML page")
    p.add_argument("--update_html_freq", type=int, default=1000,
                   help="iterations between refreshes of web/index.html")
    p.add_argument("--save_latest_freq", type=int, default=500)
    p.add_argument("--save_epoch_freq", type=int, default=10,
                   help="epochs between checkpoints of the epoch trainer")
    p.add_argument("--save_by_iter", action="store_true",
                   help="name checkpoints iter_<N> instead of overwriting 'latest'")
    p.add_argument("--nan_check", action="store_true",
                   help="at --print_freq, save nan_debug checkpoints and exit 3 if a loss is "
                        "not finite")
    p.add_argument("--watchdog_secs", type=int, default=0,
                   help="exit 42 if no iteration completes for this many seconds (armed "
                        "after the first); resume with --continue_train --load_iter")
    p.add_argument("--verbose", action="store_true", help="print the networks")
    p.add_argument("--phase", default="train", help="names the options dump <phase>_opt.txt")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace (Chrome JSON) of the hot loop here")
    p.add_argument("--num_threads", type=int, default=8,
                   help="the epoch trainer's loader prefetches on a thread when > 0; no effect "
                        "on train_onecube, whose crops are cut on the device")
    p.add_argument("--seed", type=int, default=None,
                   help="seeds the weights, the crops and the probe draws (a fresh one from "
                        "os.urandom when omitted)")
    add_gpu_ids(p)
    add_jax_flags(p, UNREAD_TRAIN)
    return p


def check_options(opt, dataset_modes=("singlevolume",)) -> None:
    """Raise NotImplementedError for every option whose path is not ported;
    ``dataset_modes``: the datasets of the calling trainer.  The preprocess
    tokens are the host chain's, which hold the device chain's (a chain the
    device path does not take runs on the host chain)."""
    refused = [
        (opt.dataset_mode not in dataset_modes, f"--dataset_mode {opt.dataset_mode}"),
        (getattr(opt, "netG_B", "deep_linear_gen") not in GAN_NET_G,
         f"--netG_B {getattr(opt, 'netG_B', None)}"),
    ]
    for bad, what in refused:
        if bad:
            raise NotImplementedError(f"{what} {NOT_PORTED}")
    refuse_other_values(opt, PORTED_VALUES)
    device_of(opt)
    if opt.grad_accum < 1 or opt.batch_size < 1:
        raise ValueError(f"--grad_accum {opt.grad_accum}, --batch_size {opt.batch_size}: at "
                         "least 1 each")
    check_host_preprocess(opt.preprocess)


def parse(argv=None, dataset_modes=("singlevolume",)):
    """Parse and check; under torchrun bring up the process group
    (``train_parallel.maybe_initialize_distributed``, NCCL between cards,
    gloo on the CPU).  With ``--add_date`` (and not ``--continue_train``)
    the name gets its date prefix, and then ``_<suffix>`` from ``--suffix``,
    as ``BaseOptions.parse`` gives them (``options.apply_jax_flags``).
    Without ``--seed`` a seed is drawn from ``os.urandom`` (as
    ``BaseModel.__init__`` of the JAX package draws it) and printed.  Under
    data parallelism rank 0 draws the seed and the date and every rank
    takes them; ``--grad_accum`` > 1 is refused there, as in JAX (the ranks
    are the batch)."""
    opt = build_parser(argv).parse_args(argv)
    check_options(opt, dataset_modes)
    train_parallel.maybe_initialize_distributed(device_of(opt))
    if train_parallel.world() > 1 and opt.grad_accum > 1:
        raise SystemExit(f"--grad_accum {opt.grad_accum} needs a single process; over "
                         f"{train_parallel.world()} ranks the ranks are the batch")
    if opt.seed is None:
        opt.seed = train_parallel.broadcast_int(int.from_bytes(os.urandom(4), "little"))
        if train_parallel.is_main():
            print(f"--seed not given: drew seed {opt.seed}", flush=True)
    if opt.add_date and not opt.continue_train:
        opt.name = date_stamp(train_parallel.broadcast_int(int(time.time()))) + "_" + opt.name
    apply_jax_flags(opt, refuse_btoa=True)
    return opt


def print_options(opt) -> None:
    """Print the options and write them to
    ``<checkpoints_dir>/<name>/<phase>_opt.txt``."""
    _print_options(opt, build_parser(["--model", opt.model]),
                   os.path.join(opt.checkpoints_dir, opt.name, f"{opt.phase}_opt.txt"))
