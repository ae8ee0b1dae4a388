"""Single-volume Apollo trainer on the card: the port's counterpart of
``train_onecube.py`` for the production configuration.

    python -m neuroclear_tpu_torch.train_onecube --dataroot <volume.npy or dir> \
        --name <exp> --checkpoints_dir <dir> \
        --preprocess randomcrop_randomflip_addColorChannel_addBatchChannel \
        --model axial_to_lateral_gan_apollo --netG unet_deconv \
        --netG_B deep_linear_gen --netD basic --gan_mode lsgan --init_type kaiming \
        --norm instance --lambda_A 5 --crop_size 108 108 108 --lambda_plane 1 1 1 \
        --lr_policy constant --randomize_projection_depth --projection_depth 10 \
        --precision bfloat16 --save_by_iter --save_latest_freq 500 --max_iters 1000

It reads a (z, y, x) ``.npy`` volume, keeps it on the device, and for each
iteration draws a crop (random offsets and flips), takes one Apollo step
(models/axial_to_lateral_gan_apollo_model.py), prints the eleven losses every
``--print_freq`` iterations, and every ``--save_latest_freq`` iterations and
at the end writes ``{suffix}_net_{NAME}.npz`` for the six nets in the JAX
package's format under ``<checkpoints_dir>/<name>/``.  It runs on the card
unless ``--device cpu`` is given.  Rotations in ``--preprocess``, ``--remat``,
``--grad_accum`` > 1, optimizer-state save and resume, LR policies other than
``constant``, TIFF input and models other than Apollo are not ported yet
(ROADMAP.md).  The flags' defaults are the JAX CLI's, except where the port
does not take the JAX default (``--model``, ``--init_type``, ``--lr_policy``,
``--crop_size``, ``--preprocess``): there they are the production
configuration's; ``--precision`` defaults to bfloat16, the JAX package's
training benchmark default.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from . import resolve_device
from .data.singlevolume_dataset import SingleVolumeDataset, check_preprocess
from .models.axial_to_lateral_gan_apollo_model import LOSS_NAMES, ApolloModel

NOT_PORTED = "is not ported yet (ROADMAP.md, queue 1)"


def load_volume(path: str) -> np.ndarray:
    """The (z, y, x) volume of a ``.npy`` file, or of the one ``.npy`` file
    in a directory."""
    if os.path.isdir(path):
        files = sorted(f for f in os.listdir(path) if f.endswith(".npy"))
        if len(files) != 1:
            raise FileNotFoundError(f"{path} must hold exactly one .npy volume, found {files}")
        path = os.path.join(path, files[0])
    vol = np.load(path)
    if vol.ndim != 3:
        raise ValueError(f"{path}: expected a (z, y, x) volume, got shape {vol.shape}")
    return vol


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--dataroot", required=True,
                   help="training volume: a .npy file, or a directory holding one")
    p.add_argument("--name", default="experiment_name", help="experiment name")
    p.add_argument("--checkpoints_dir", default="./checkpoints")
    p.add_argument("--dataset_mode", default="singlevolume")
    p.add_argument("--preprocess",
                   default="randomcrop_randomflip_addColorChannel_addBatchChannel")
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
    p.add_argument("--beta1", type=float, default=0.1)
    p.add_argument("--lr", type=float, default=0.0001)
    p.add_argument("--lr_policy", default="constant")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--crop_size", type=int, nargs=3, default=[108, 108, 108])
    p.add_argument("--precision", default="bfloat16", choices=["float32", "bfloat16"],
                   help="compute dtype; parameters and Adam stay float32")
    p.add_argument("--max_iters", type=int, default=0,
                   help="stop after this many iterations (0 = run until stopped)")
    p.add_argument("--print_freq", type=int, default=500)
    p.add_argument("--save_latest_freq", type=int, default=500)
    p.add_argument("--save_by_iter", action="store_true",
                   help="name checkpoints iter_<N> instead of overwriting 'latest'")
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the weights, the crops and the probe draws")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--remat", action="store_true", help=f"activation recomputation {NOT_PORTED}")
    p.add_argument("--grad_accum", type=int, default=1, help=f"values > 1 {NOT_PORTED}")
    p.add_argument("--continue_train", action="store_true",
                   help=f"optimizer-state save and resume {NOT_PORTED}")
    return p


def check_options(opt) -> None:
    """Raise NotImplementedError for every option this slice does not port."""
    refused = [
        (opt.model != "axial_to_lateral_gan_apollo", f"--model {opt.model}"),
        (opt.dataset_mode != "singlevolume", f"--dataset_mode {opt.dataset_mode}"),
        (opt.remat, "--remat"),
        (opt.grad_accum > 1, "--grad_accum > 1"),
        (opt.continue_train, "--continue_train (optimizer-state save and resume)"),
        (opt.lr_policy != "constant", f"--lr_policy {opt.lr_policy}"),
        (opt.batch_size != 1, "--batch_size > 1"),
        (opt.init_type != "kaiming", f"--init_type {opt.init_type}"),
        (opt.netD != "basic", f"--netD {opt.netD}"),
        (opt.norm != "instance", f"--norm {opt.norm}"),
    ]
    for bad, what in refused:
        if bad:
            raise NotImplementedError(f"{what} {NOT_PORTED}")
    check_preprocess(opt.preprocess)
    if str(opt.dataroot).lower().endswith((".tif", ".tiff")):
        raise NotImplementedError(f"TIFF input {NOT_PORTED}; pass a .npy volume")


def _mark(device: torch.device):
    """A point on the device's timeline, taken without a sync: a CUDA event
    on the card, the host clock on the CPU (where every op is synchronous)."""
    if device.type != "cuda":
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def _seconds(a, b) -> float:
    """Seconds from mark a to mark b (both complete)."""
    return a.elapsed_time(b) / 1e3 if isinstance(a, torch.cuda.Event) else b - a


def main(argv=None) -> dict:
    """Train.  The losses are read back (a device sync) only every
    ``--print_freq`` iterations and at the end, so the host queues a step
    while the card runs the one before.  With ``--max_iters`` N, returns
    {"losses": one {name: float} per iteration, "step_seconds": seconds of
    each iteration on the device's clock (from the end of one to the end of
    the next), "checkpoints": paths written, "device": the device}; without
    it the run keeps no history and does not return."""
    opt = build_parser().parse_args(argv)
    check_options(opt)
    device = resolve_device(opt.device)
    # f32 convs in full f32, as the JAX package's HIGHEST precision
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    vol = load_volume(opt.dataroot)
    dataset = SingleVolumeDataset(vol, opt.crop_size, opt.preprocess, device)
    model = ApolloModel(opt, device)
    model.init_weights(opt.seed)
    model.print_networks()
    gen = torch.Generator().manual_seed(opt.seed)
    print(f"volume {vol.shape} {vol.dtype} on {device}; crops {tuple(opt.crop_size)} "
          f"{opt.precision}", flush=True)

    # with --max_iters, each step's losses and end mark, kept without a sync
    log = torch.empty((opt.max_iters, len(LOSS_NAMES)), device=device)
    marks = [_mark(device)]
    window, window_it, paths = marks[0], 0, []
    it = 0
    while not opt.max_iters or it < opt.max_iters:
        real = dataset.sample(gen)
        draws = model.draw_probes(opt.crop_size, gen)
        step_losses, _, _ = model.optimize_parameters(real, draws)
        values = torch.stack([step_losses[n] for n in LOSS_NAMES])
        end = _mark(device)
        if opt.max_iters:
            log[it] = values
            marks.append(end)
        it += 1
        last = it == opt.max_iters
        if it % opt.print_freq == 0 or last:
            msg = " ".join(f"{k}: {v:.4g}" for k, v in zip(LOSS_NAMES, values.tolist()))
            per_step = _seconds(window, end) / (it - window_it)
            print(f"(iters: {it}, time: {per_step:.3f}) {msg}", flush=True)
            window, window_it = end, it
        if it % opt.save_latest_freq == 0 or last:
            suffix = f"iter_{it}" if opt.save_by_iter else "latest"
            paths += model.save_networks(suffix)
            print(f"saving the model at iteration {it} ({suffix})", flush=True)
    losses = [dict(zip(LOSS_NAMES, row)) for row in log.tolist()]
    secs = [_seconds(a, b) for a, b in zip(marks, marks[1:])]
    return {"losses": losses, "step_seconds": secs, "checkpoints": paths, "device": device}


if __name__ == "__main__":
    main(sys.argv[1:])
