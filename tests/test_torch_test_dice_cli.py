"""The port's ``test_dice`` CLI (neuroclear_tpu_torch/test_dice.py) against the
JAX package's ``test_dice.py``, both in f32 on the CPU, on the same TIFF
volume, ground truth and JAX-initialised ``.npz`` checkpoint: the written
output volumes, the projections and ``metrics.txt``.

Bounds on the volumes: GEN_LSB uint16 LSB, the generator's own f32 bound
(tests/test_torch_unet.py: rtol 1e-4 and atol 1e-4, so 2e-4 of an output in
[0, 1], 13.1 LSB) plus 1 for the truncating cast.  It is needed: the JAX
package's jitted tile pipeline differs from its own op-by-op
``UNetDeconv.apply`` on the same tile by up to 10.6 LSB at these weights,
while the port lies within 0.4 LSB of the op-by-op apply (measured on the
CPU).  An output in uint8 or float is the same value on another grid.  With
--normalize_intensity the percentile stretch multiplies the difference by
1 / (p99.75 - p0.25) of the output, and the two percentiles move by as much,
so the bound grows by three times the stretch.

Bounds on the metrics, 1e-3 dB PSNR and 1e-4 SSIM, the device metrics' own
bound against the host path (tests/test_device_metrics.py), plus half a unit
of the 4th decimal that ``metrics.txt`` rounds to: the input's metrics
against the JAX CLI's file (the same volumes on both sides), and the
output's against the JAX CLI's own ``compute_gt_metrics`` run on the port's
output.  The two CLIs' output volumes differ by a few LSB, which the
protocol's uint8 quantisation turns into bin flips on a 1,080-voxel volume.
"""

import os
import re
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from neuroclear_tpu.nn.core import flatten_params
from neuroclear_tpu.nn.generators import UNetDeconv as JaxUNetDeconv
from neuroclear_tpu.ops import pallas_wconv
from neuroclear_tpu.utils import tiffio as jax_tiffio
from neuroclear_tpu_torch import test_dice as port_cli

GEN_LSB = 14
SHAPE = (12, 10, 9)  # one 24^3 tile: dice 16, overlap 0, border_cut 4
PSNR_TOL, SSIM_TOL = 1e-3, 1e-4
METRIC_RE = re.compile(r"\((psnr|ssim): ([-0-9.]+)\)")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    params = JaxUNetDeconv(1, 1).init(jax.random.PRNGKey(3), "kaiming", 0.02)
    (root / "exp").mkdir()
    np.savez(root / "exp" / "iter_5_net_G_A.npz", **flatten_params(params))
    return str(root)


def _volumes(in_dtype, root):
    """An input volume of in_dtype and a uint16 ground truth, from a seed."""
    rng = np.random.default_rng({"uint16": 1, "uint8": 2, "float32": 3}[in_dtype])
    z, y, x = np.meshgrid(*(np.arange(n, dtype=np.float64) for n in SHAPE), indexing="ij")
    field = 0.5 + 0.3 * np.sin(z / 3.0) * np.cos(y / 4.0) * np.sin(x / 2.5 + 1.0)
    gt = np.clip(field, 0, 1)
    vol = np.clip(gt + rng.normal(0, 0.08, SHAPE), 0, 1)
    if in_dtype == "uint16":
        vol = (vol * 65535).astype(np.uint16)
    elif in_dtype == "uint8":
        vol = (vol * 255).astype(np.uint8)
    else:
        vol = vol.astype(np.float32)
    jax_tiffio.imwrite(str(root / "input" / "vol.tif"), vol)
    jax_tiffio.imwrite(str(root / "gt" / "vol.tif"), (gt * 65535).astype(np.uint16))


def _args(root, ckpt, results, data_type, normalize, extra=()):
    args = ["--dataroot", str(root / "input"), "--dataroot_gt", str(root / "gt"),
            "--name", "exp", "--checkpoints_dir", ckpt, "--results_dir", str(results),
            "--model_suffix", "_A", "--load_iter", "5", "--serial_batches",
            "--preprocess", "addColorChannel", "--dataset_mode", "diceImage",
            "--netG", "unet_deconv", "--image_dimension", "3",
            "--dice_size", "16", "16", "16", "--overlap", "0", "--border_cut", "4",
            "--precision", "float32", "--data_type", data_type,
            "--save_volume", "--save_projections"]
    return args + (["--normalize_intensity"] if normalize else []) + list(extra)


def _run_jax_cli(argv, monkeypatch):
    """The JAX package's test_dice.main in this process (JAX on the CPU, as
    the test configuration sets it), restoring the W-pair switch it turns
    on."""
    import test_dice as jax_cli

    monkeypatch.setattr(sys, "argv", ["test_dice.py"] + argv)
    enabled = pallas_wconv.ENABLED
    try:
        jax_cli.main()
    finally:
        pallas_wconv.ENABLED = enabled


def _read_outputs(web_dir):
    """{path relative to web_dir: array} of every TIFF the CLI wrote."""
    return {os.path.relpath(os.path.join(root, f), web_dir): jax_tiffio.imread(
                os.path.join(root, f))
            for root, _, files in sorted(os.walk(web_dir)) for f in sorted(files)
            if f.endswith(".tif")}


SLICES = ["--skip_real", "--save_slices", "--data_name", "vol"]


@pytest.mark.parametrize("in_dtype, data_type, normalize, extra", [
    ("uint16", "uint16", False, ()),   # the shipped path: streamed TIFF write
    ("uint16", "uint16", True, ()),
    ("uint8", "uint8", False, ()),
    ("uint8", "float", True, ()),
    ("float32", "float", False, ()),
    ("float32", "uint16", True, ()),
    ("uint16", "uint8", False, SLICES),
])
def test_port_cli_matches_jax_cli(tmp_path, monkeypatch, checkpoint, in_dtype, data_type,
                                  normalize, extra):
    _volumes(in_dtype, tmp_path)
    _run_jax_cli(_args(tmp_path, checkpoint, tmp_path / "jax", data_type, normalize, extra),
                 monkeypatch)
    res = port_cli.main(_args(tmp_path, checkpoint, tmp_path / "port", data_type, normalize,
                              extra) + ["--device", "cpu"])

    web = os.path.join("vol_by_exp" if extra else "exp", "test_latest_iter5")
    assert res["web_dir"] == os.path.join(str(tmp_path / "port"), web)
    ref, got = _read_outputs(str(tmp_path / "jax" / web)), _read_outputs(res["web_dir"])
    assert list(got) == list(ref)
    # the output volume and its three projections; without --skip_real the
    # input's too; with --save_slices every slice along each axis
    assert len(got) == (4 + sum(SHAPE) if extra else 8)

    out_ref = ref[os.path.join("volumes", "output_volume_xy-view_iter-5.tif")]
    full = {"uint16": 65535.0, "uint8": 255.0}.get(data_type, 1.0)
    step = 1.0 / 65535  # one uint16 LSB of a [0, 1] output
    bound = (GEN_LSB - 1) * step
    if normalize:
        p1, p99 = np.percentile(out_ref.astype(np.float64) / full, (0.25, 99.75))
        bound *= 3.0 / (p99 - p1)
    # plus one unit of the output grid for the truncating cast
    tol = bound * full + (1.0 if data_type in ("uint8", "uint16") else 0.0)
    for path, r in ref.items():
        g = got[path]
        assert g.dtype == r.dtype and g.shape == r.shape, (path, g.dtype, r.dtype)
        err = np.abs(g.astype(np.float64) - r.astype(np.float64)).max()
        assert err <= tol, (path, err, tol)
    written = got[os.path.join("volumes", "output_volume_xy-view_iter-5.tif")]
    assert np.array_equal(res["fake"].astype(written.dtype), written)
    assert res["fake"].shape == SHAPE and res["fake"].std() > 0
    streamed = data_type in ("uint8", "uint16") and not normalize
    assert (res["fake_streamed"] is not None) == streamed

    # the JAX CLI's own metrics code on the port's volumes
    import test_dice as jax_cli

    jax_cli.compute_gt_metrics(SimpleNamespace(dataroot_gt=str(tmp_path / "gt"), name="exp"),
                               str(tmp_path), {"fake": res["fake"], "real": res["real"]})
    texts = {}
    for label, path in (("jax", tmp_path / "jax" / web / "metrics.txt"),
                        ("port", os.path.join(res["web_dir"], "metrics.txt")),
                        ("jax on port", tmp_path / "metrics.txt")):
        with open(path) as f:
            texts[label] = f.read()
    assert METRIC_RE.sub("", texts["port"]) == METRIC_RE.sub("", texts["jax"])
    ref = dict(zip(("psnr_input", "ssim_input"),
                   [float(v) for _, v in METRIC_RE.findall(texts["jax"])][:2]))
    ref.update(zip(("psnr_output", "ssim_output"),
                   [float(v) for _, v in METRIC_RE.findall(texts["jax on port"])][2:]))
    for key, r in ref.items():
        tol = (PSNR_TOL if key.startswith("psnr") else SSIM_TOL) + 5e-5
        assert abs(res["metrics"][key] - r) <= tol, (key, res["metrics"][key], r)


@pytest.mark.parametrize("flags, error", [
    (["--legacy_pipeline"], NotImplementedError),
    (["--histogram_match"], NotImplementedError),
    (["--netG", "resnet_9blocks"], NotImplementedError),
    (["--dataset_mode", "cube"], NotImplementedError),
    (["--image_dimension", "2"], NotImplementedError),
    (["--dice_size", "0"], ValueError),
])
def test_port_cli_refuses_unported_options(tmp_path, flags, error):
    """What the port does not have is refused before anything is read or
    written, with a pointer to ROADMAP.md for the unported paths."""
    argv = ["--dataroot", str(tmp_path / "missing"), "--results_dir", str(tmp_path / "res"),
            "--dice_size", "16", "--device", "cpu"] + flags
    with pytest.raises(error, match="ROADMAP" if error is NotImplementedError else "dice_size"):
        port_cli.main(argv)
    assert not any(tmp_path.iterdir())
