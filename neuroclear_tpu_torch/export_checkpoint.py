"""Convert checkpoints between the JAX flat ``.npz`` format, which both
packages read and write, and the original PyTorch NeuroClear's ``.pth`` state
dicts (the same ``{suffix}_net_{NAME}`` naming), with the flags of the JAX
package's ``scripts/export_checkpoint.py``.

    python -m neuroclear_tpu_torch.export_checkpoint --mode export \\
        --arch unet_deconv --src ck/iter_11000_net_G_A.npz --dst ck/iter_11000_net_G_A.pth
    python -m neuroclear_tpu_torch.export_checkpoint --mode import \\
        --arch unet_deconv --src ref/latest_net_G_A.pth --dst ck/latest_net_G_A.npz

Archs: unet_deconv, deep_linear_gen, basic.  Runs on the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .utils import torch_export as tx
from .utils.weights import load_npz


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=["export", "import"], required=True)
    ap.add_argument("--arch", choices=sorted(tx.NET_MAPS), required=True)
    ap.add_argument("--src", required=True)
    ap.add_argument("--dst", required=True)
    args = ap.parse_args(argv)
    if args.mode == "export":
        tx.export_pth(load_npz(args.src), args.arch, args.dst)
    else:
        with open(args.dst, "wb") as f:  # a file handle: savez appends no '.npz'
            np.savez(f, **tx.import_pth(args.src, args.arch))
    print(f"{args.mode}ed {args.src} -> {args.dst}")


if __name__ == "__main__":
    main(sys.argv[1:])
