"""Tiled ("dice") inference with a trained generator, on the card: the port's
counterpart of ``test_dice.py::run_fused``.

    python -m neuroclear_tpu_torch.infer --dataroot <volume.npy or dir> \
        --name <exp> --checkpoints_dir <dir> --load_iter <N> --model_suffix _A \
        --dice_size 120 120 120 --overlap 15 --border_cut 10 --tile_batch 2 \
        --precision bfloat16 --data_type uint16 --results_dir <dir>

It reads a (z, y, x) ``.npy`` volume, loads ``{suffix}_net_G{model_suffix}.npz``
from ``<checkpoints_dir>/<name>/`` (the JAX package's checkpoint format), runs
the tile pipeline and writes the output volume as ``.npy`` under
``<results_dir>/<name>/test_<epoch>[_iter<N>]/volumes/``.  It runs on the card
unless ``--device cpu`` is given.  TIFF I/O and the PSNR/SSIM metrics are not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from . import resolve_device
from .data.dicing import DiceGrid
from .models.test_model import TestModel
from .parallel.dice_infer import DiceInferencePipeline
from .utils.imageops import dtype_inv_scale, pad_for_dicing


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--dataroot", required=True,
                   help="input volume: a .npy file, or a directory holding one")
    p.add_argument("--name", default="experiment_name", help="experiment name")
    p.add_argument("--checkpoints_dir", default="./checkpoints")
    p.add_argument("--epoch", default="latest", help="checkpoint suffix to load")
    p.add_argument("--load_iter", type=int, default=0,
                   help="when > 0, load the iter_<N> checkpoint instead of --epoch")
    p.add_argument("--model_suffix", default="",
                   help="loads [epoch]_net_G[model_suffix].npz")
    p.add_argument("--dice_size", type=int, nargs="+", default=[64, 64, 64],
                   help="tile size; the first entry is used, as in test_dice.py")
    p.add_argument("--overlap", type=int, default=0)
    p.add_argument("--border_cut", type=int, default=0)
    p.add_argument("--tile_batch", type=int, default=2)
    p.add_argument("--precision", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--repetition", action="store_true",
                   help="flip-TTA: infer flipped copies of each tile and average")
    p.add_argument("--data_type", default="uint16",
                   help="output dtype: uint16 or uint8 (anything else: float32 in [0, 1])")
    p.add_argument("--results_dir", default="./results/")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def load_volume(path: str) -> np.ndarray:
    if os.path.isdir(path):
        files = sorted(f for f in os.listdir(path) if f.endswith(".npy"))
        if len(files) != 1:
            raise FileNotFoundError(f"{path} must hold exactly one .npy volume, found {files}")
        path = os.path.join(path, files[0])
    vol = np.load(path)
    if vol.ndim != 3:
        raise ValueError(f"{path}: expected a (z, y, x) volume, got shape {vol.shape}")
    return vol


def output_path(opt) -> str:
    web_dir = os.path.join(opt.results_dir, opt.name, f"test_{opt.epoch}")
    if opt.load_iter > 0:
        web_dir = f"{web_dir}_iter{opt.load_iter}"
        tag = f"iter-{opt.load_iter}"
    else:
        tag = f"epoch-{opt.epoch}"
    return os.path.join(web_dir, "volumes", f"output_volume_xy-view_{tag}.npy")


def main(argv=None) -> dict:
    """Run inference.  Returns {"output": path of the written volume,
    "seconds": pipeline wall time, "voxels": voxels of the input volume}."""
    opt = build_parser().parse_args(argv)
    device = resolve_device(opt.device)
    # f32 convs in full f32, as the JAX package's HIGHEST precision
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    vol = load_volume(opt.dataroot)
    roi = opt.dice_size[0]
    vol_padded = pad_for_dicing(vol, roi, overlap=opt.overlap)
    grid = DiceGrid(vol_padded.shape, roi, opt.overlap, opt.border_cut)
    print(f"volume {vol.shape} {vol.dtype}, padded {vol_padded.shape}, {len(grid)} tiles "
          f"of {roi + 2 * opt.border_cut}^3 on {device}", flush=True)

    model = TestModel(opt, device)
    model.setup(opt)
    pipe = DiceInferencePipeline(
        model.netG, grid, dtype_inv_scale(vol_padded.dtype), tile_batch=opt.tile_batch,
        repetition=opt.repetition, precision=opt.precision,
        out_dtype={"uint8": np.uint8, "uint16": np.uint16}.get(opt.data_type),
        orig_shape=vol.shape, device=device)

    t0 = time.perf_counter()
    fake = pipe.run_streaming(vol_padded)
    dt = time.perf_counter() - t0
    n_vox = vol.size
    print(f"Inference+assembly: {dt:.3f}s ({n_vox / max(dt, 1e-9):.4g} voxel/s, "
          f"{device})", flush=True)

    out = output_path(opt)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.save(out, fake)
    print(f"Output volume {fake.shape} {fake.dtype} saved to {out}", flush=True)
    return {"output": out, "seconds": dt, "voxels": n_vox}


if __name__ == "__main__":
    main(sys.argv[1:])
