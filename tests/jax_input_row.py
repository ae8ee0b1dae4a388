"""The 700^3 s4 eval's input row through the JAX package's own code on the
CPU, for the record beside ``chip_smoke.py --quality700``.

    JAX_PLATFORMS=cpu python tests/jax_input_row.py DIR

DIR holds the ``--size 700 --seed 0 --preset s4`` trio (``input/``, ``gt/``),
or receives it from the JAX package's ``scripts/generate_synthetic.py``.
The input row is the eval's "Network Input vs. Groundtruth" block, which no
net touches: the input volume as ``test_dice.run_fused`` hands it on (the
diceImage dataset's padded volume, scaled to [0, 1] in float32), stretched
by ``test_dice._postprocess`` (``--normalize_intensity --sat_level 0.25
99.75``, uint16), then held against the ground truth by
``parallel/metrics.py::protocol_metrics`` (the device path, here on JAX's
CPU backend) and by ``compute_gt_metrics``' host path
(``NEUROCLEAR_DEVICE_METRICS=0``: float64 standardize and normalize, twice,
then ``get_psnr`` and ``get_ssim``).  It does this twice: with this numpy's
promotion rules (numpy 2: the stretch's float64 percentiles make it
float64) and with numpy 1's value-based casting (``np._set_promotion_state
("legacy")``: the stretch stays float32).  Then the port's path on the
same volumes (``neuroclear_tpu_torch.test_dice``'s dataset, ``_postprocess``
and both metric paths, on the CPU), its stretched input held against JAX's
bit for bit.  Memory: ~12 GB at the peak.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# the study's eval flags (scripts/run_quality_study.sh's eval_at), without a net
EVAL_ARGS = ["--serial_batches", "--preprocess", "addColorChannel", "--dataset_mode",
             "diceImage", "--netG", "unet_deconv", "--overlap", "15", "--dice_size", "120",
             "120", "120", "--normalize_intensity", "--sat_level", "0.25", "99.75",
             "--image_dimension", "3", "--model_suffix", "_A", "--border_cut", "10",
             "--skip_real"]


def generate(out: str) -> None:
    if os.path.isdir(os.path.join(out, "input")):
        return
    subprocess.run([sys.executable, os.path.join(REPO, "scripts", "generate_synthetic.py"),
                    "--out", out, "--size", "700", "--seed", "0", "--preset", "s4"],
                   check=True)


def input_volume(jax_cli, opt) -> np.ndarray:
    """The input volume after ``run_fused``'s scaling and ``_postprocess``,
    under the promotion state in force."""
    from neuroclear_tpu import data
    from neuroclear_tpu.ops.augment import dtype_inv_scale

    probe = data.find_dataset_using_name(opt.dataset_mode)(opt)
    raw, b = probe.cube.image, opt.border_cut
    vol_padded = raw[b:-b, b:-b, b:-b] if b > 0 else raw
    real = np.asarray(vol_padded, np.float32) * dtype_inv_scale(vol_padded.dtype)
    print(f"  percentiles {describe(np.percentile(real, tuple(opt.sat_level)))}", flush=True)
    return jax_cli._postprocess(real, opt, probe.size_original())


def describe(p: np.ndarray) -> str:
    return f"{[float(v) for v in p]} ({p.dtype})"


def digest(vol: np.ndarray) -> str:
    return hashlib.sha256(vol.tobytes()).hexdigest()


def host_row(jax_cli, opt, real: np.ndarray) -> tuple:
    """``compute_gt_metrics``' host path on (real, real): its input row."""
    os.environ["NEUROCLEAR_DEVICE_METRICS"] = "0"
    web = os.path.join(opt.results_dir, "host")
    os.makedirs(web, exist_ok=True)
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            jax_cli.compute_gt_metrics(opt, web, {"real": real, "fake": real})
    finally:
        del os.environ["NEUROCLEAR_DEVICE_METRICS"]
    m = re.search(r"Input vs\. Groundtruth\n\(psnr: ([0-9.]+)\) \n\(ssim: ([0-9.]+)\)",
                  printed.getvalue())
    return float(m.group(1)), float(m.group(2))


def port_rows(argv: list, gt: np.ndarray, jax_real: np.ndarray) -> None:
    """The port's input row on the CPU from the same argv, and its stretched
    input against JAX's."""
    import torch

    from neuroclear_tpu_torch import test_dice as port_cli
    from neuroclear_tpu_torch.data import find_dataset_using_name
    from neuroclear_tpu_torch.options import test_options
    from neuroclear_tpu_torch.parallel import metrics as port_metrics
    from neuroclear_tpu_torch.utils import imageops

    with contextlib.redirect_stdout(io.StringIO()):
        opt = test_options.parse([*argv, "--device", "cpu"])
    ds = find_dataset_using_name(opt.dataset_mode)(opt)
    vol = ds.volume
    real = np.asarray(vol, np.float32) * imageops.dtype_inv_scale(vol.dtype)
    print(f"port: percentiles {describe(np.percentile(real, tuple(opt.sat_level)))}",
          flush=True)
    real = port_cli._postprocess(real, opt, ds.size_original())
    print(f"port: stretched input sha256 {digest(real)}; mean, std of it and of the ground "
          f"truth {[float(f(v)) for v in (real, gt) for f in (np.mean, np.std)]}", flush=True)
    del vol, ds
    diff = np.abs(real.astype(np.int64) - jax_real.astype(np.int64))
    print(f"port's stretched input against JAX's: {int((diff > 0).sum())} voxels differ, "
          f"max {int(diff.max())} LSB", flush=True)
    del diff
    dev = port_metrics.protocol_metrics(real, real, gt, device=torch.device("cpu"))
    host = port_cli.host_metrics(real, real, gt)
    print(f"port: protocol_metrics psnr {dev['psnr_input']:.4f} ssim {dev['ssim_input']:.4f}; "
          f"host_metrics psnr {host['psnr_input']:.4f} ssim {host['ssim_input']:.4f}",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dir")
    a = ap.parse_args(argv)
    generate(a.dir)
    sys.argv = ["test_dice.py", "--dataroot", os.path.join(a.dir, "input"), "--dataroot_gt",
                os.path.join(a.dir, "gt"), "--results_dir", os.path.join(a.dir, "results"),
                "--name", "input_row", *EVAL_ARGS]
    import test_dice as jax_cli
    from neuroclear_tpu.options.test_options import TestOptions
    from neuroclear_tpu.parallel import metrics as device_metrics
    from neuroclear_tpu.utils import tiffio

    with contextlib.redirect_stdout(io.StringIO()):
        opt = TestOptions().parse()
    gt = tiffio.imread(os.path.join(a.dir, "gt", "bead_gt.tif"))
    print(f"numpy {np.__version__}; gt {gt.shape} {gt.dtype}", flush=True)
    real64 = None
    for label, state in (("float64 stretch (numpy 2 promotion)", "weak"),
                         ("float32 stretch (numpy 1 value-based casting)", "legacy")):
        np._set_promotion_state(state)
        try:
            t0 = time.perf_counter()
            real = input_volume(jax_cli, opt)
        finally:
            np._set_promotion_state("weak")
        dev = device_metrics.protocol_metrics(real, real, gt)
        t1 = time.perf_counter()
        host = host_row(jax_cli, opt, real)
        print(f"{label}: protocol_metrics psnr {dev['psnr_input']:.4f} ssim "
              f"{dev['ssim_input']:.4f}; host path psnr {host[0]:.4f} ssim {host[1]:.4f} "
              f"({t1 - t0:.0f} s, {time.perf_counter() - t1:.0f} s); stretched input sha256 "
              f"{digest(real)}", flush=True)
        if real64 is None:
            real64 = real
        del real
    port_rows(sys.argv[1:], gt, real64)
    return 0


if __name__ == "__main__":
    sys.exit(main())
