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
import torch

from neuroclear_tpu.nn.core import flatten_params
from neuroclear_tpu.nn.generators import UNetDeconv as JaxUNetDeconv
from neuroclear_tpu.ops import pallas_wconv
from neuroclear_tpu.utils import tiffio as jax_tiffio
from neuroclear_tpu_torch import test_dice as port_cli
from neuroclear_tpu_torch.options import device_of, test_options

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


def _options_dump(path) -> dict:
    """{option: printed value} of a ``*_opt.txt``."""
    with open(path) as f:
        return {m.group(1): m.group(2).rstrip() for m in
                (re.match(r"^ *(\w+): (.*?)(\t\[default: .*\])?$", line.rstrip("\n"))
                 for line in f) if m}


def _read_outputs(web_dir):
    """{path relative to web_dir: array} of every TIFF the CLI wrote."""
    return {os.path.relpath(os.path.join(root, f), web_dir): jax_tiffio.imread(
                os.path.join(root, f))
            for root, _, files in sorted(os.walk(web_dir)) for f in sorted(files)
            if f.endswith(".tif")}


def _check_galleries(jax_web, res, skip_real):
    """The fused path writes the galleries too: both pages as the JAX CLI's
    text, the same thumbnails, each pixel-equal to what the JAX package's
    ``populate_webpages`` writes from the port's volumes."""
    import tempfile

    import test_dice as jax_cli
    from PIL import Image

    from neuroclear_tpu.utils import html as jax_html

    def pngs(root):
        return sorted(os.path.relpath(os.path.join(r, f), root)
                      for r, _, fs in os.walk(root) for f in fs if f.endswith(".png"))

    def pixels(path):
        with Image.open(path) as im:
            return np.asarray(im)

    for page in ("index.html", "index_wholeimg.html"):
        with open(os.path.join(jax_web, page)) as a, open(os.path.join(res["web_dir"], page)) as b:
            assert a.read() == b.read(), page
    assert pngs(res["web_dir"]) == pngs(str(jax_web))
    with tempfile.TemporaryDirectory() as ref_dir:
        opt = SimpleNamespace(skip_real=skip_real, aspect_ratio=1.0, name="exp", phase="test",
                              epoch="latest")
        jax_cli.populate_webpages(opt, ref_dir, jax_html.HTML(ref_dir, "t"),
                                  {"fake": res["fake"], "real": res["real"]})
        assert pngs(ref_dir) == pngs(res["web_dir"])
        for f in pngs(ref_dir):
            assert np.array_equal(pixels(os.path.join(res["web_dir"], f)),
                                  pixels(os.path.join(ref_dir, f))), f


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
    _check_galleries(tmp_path / "jax" / web, res, "--skip_real" in extra)
    # the options dump of BaseOptions.print_options, where the JAX CLI writes
    # it: every option both CLIs take with the same value (but the folder)
    jax_opts, port_opts = (_options_dump(tmp_path / side / os.path.dirname(web) / "test_opt.txt")
                           for side in ("jax", "port"))
    common = (set(jax_opts) & set(port_opts)) - {"results_dir"}
    assert {"dataroot", "dice_size", "gpu_ids", "seed", "precision", "norm"} <= common
    assert {k: port_opts[k] for k in common} == {k: jax_opts[k] for k in common}
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


@pytest.mark.parametrize("switch", ["--legacy_pipeline", "--histogram_match"])
def test_port_cli_runs_the_per_cube_switches(tmp_path, checkpoint, switch):
    """Both switches run the per-cube loop (no longer refused): the output
    volume within GEN_LSB of the fused path's in f32 (the loop's generator
    sees the cubes in f32 too; normalize_dtype's float64 division and the
    per-cube assembly order move no voxel by a whole LSB on their own), and
    the galleries and volumes written.  tests/test_torch_legacy.py holds the
    loop against the JAX CLI."""
    _volumes("uint16", tmp_path)
    fused = port_cli.main(_args(tmp_path, checkpoint, tmp_path / "fused", "uint16", False)
                          + ["--device", "cpu"])
    res = port_cli.main(_args(tmp_path, checkpoint, tmp_path / "loop", "uint16", False,
                              [switch]) + ["--device", "cpu"])
    assert res["fake_streamed"] is None and fused["fake_streamed"] is not None
    assert res["fake"].shape == SHAPE and res["fake"].dtype == np.uint16
    for page in ("index.html", "index_wholeimg.html"):
        assert os.path.isfile(os.path.join(res["web_dir"], page))
    d = np.abs(res["fake"].astype(np.int64) - fused["fake"].astype(np.int64))
    if switch == "--legacy_pipeline":
        assert d.max() <= GEN_LSB, d.max()
    else:  # matched onto each input cube's histogram: the input's values
        assert np.isin(res["fake"], np.unique(res["real"])).mean() > 0.5
    assert np.array_equal(_read_outputs(res["web_dir"])[
        os.path.join("volumes", "output_volume_xy-view_iter-5.tif")], res["fake"])


@pytest.mark.parametrize("flags, error", [
    (["--netG", "resnet_9blocks"], NotImplementedError),
    (["--dataset_mode", "cube"], NotImplementedError),
    (["--image_dimension", "2"], NotImplementedError),
    (["--dice_size", "0"], ValueError),
    (["--norm", "batch"], NotImplementedError),
    (["--ngf", "32"], NotImplementedError),
    (["--gpu_ids", "0,1"], NotImplementedError),
])
def test_port_cli_refuses_unported_options(tmp_path, flags, error):
    """What the port does not have is refused before anything is read or
    written, with a pointer to ROADMAP.md for the unported paths."""
    argv = ["--dataroot", str(tmp_path / "missing"), "--results_dir", str(tmp_path / "res"),
            "--dice_size", "16", "--device", "cpu"] + flags
    with pytest.raises(error, match="ROADMAP" if error is NotImplementedError else "dice_size"):
        port_cli.main(argv)
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("flags, device", [
    (["--gpu_ids", "0"], "cuda:0"), (["--gpu_ids", "-1"], "cpu"), (["--norm", "instance"], None),
    (["--ngf", "64"], None), (["--no_dropout"], None), (["--init_type", "normal"], None),
    (["--seed", "1"], None), (["--num_test", "5"], None)])
def test_port_cli_parses_the_jax_flags(tmp_path, flags, device):
    """The flags a JAX test_dice command line carries, at the values the
    port runs, parse; the options dump lands where the JAX CLI writes it."""
    argv = ["--dataroot", str(tmp_path), "--results_dir", str(tmp_path / "res"), "--name", "e",
            "--dice_size", "16", *flags]
    if device is not None:
        assert device_of(test_options.parse(argv)) == device
    opt = port_cli.parse_options(argv + ["--device", "cpu"])
    assert opt.device == torch.device("cpu")
    dump = _options_dump(tmp_path / "res" / "e" / "test_opt.txt")
    assert dump[flags[0][2:]] == (flags[1] if len(flags) > 1 else "True")


TRAINED_G_A = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "study_state", "apollo148s4", "iter_11000_net_G_A.npz")


def test_trained_generator_matches_jax_cli(tmp_path, monkeypatch):
    """The JAX study's trained Apollo G_A (iteration 11000) through both
    CLIs on a 48^3 volume (dice 32, overlap 8: eight 40^3 tiles), f32: the
    output within GEN_LSB, the bound set at random weights."""
    rng = np.random.default_rng(8)
    shape = (48, 48, 48)
    z, y, x = np.meshgrid(*(np.arange(n, dtype=np.float64) for n in shape), indexing="ij")
    field = 0.4 + 0.25 * np.sin(z / 5.0) * np.cos(y / 6.0) * np.sin(x / 4.0 + 1.0)
    vol = (np.clip(field + rng.normal(0, 0.05, shape), 0, 1) * 65535).astype(np.uint16)
    for sub in ("input", "gt"):
        os.makedirs(tmp_path / sub)
    jax_tiffio.imwrite(str(tmp_path / "input" / "vol.tif"), vol)
    jax_tiffio.imwrite(str(tmp_path / "gt" / "vol.tif"), (np.clip(field, 0, 1) * 65535)
                       .astype(np.uint16))
    os.makedirs(tmp_path / "ck" / "exp")
    os.symlink(TRAINED_G_A, tmp_path / "ck" / "exp" / "iter_5_net_G_A.npz")
    extra = ["--dice_size", "32", "32", "32", "--overlap", "8"]
    _run_jax_cli(_args(tmp_path, str(tmp_path / "ck"), tmp_path / "jax", "uint16", False,
                       extra), monkeypatch)
    res = port_cli.main(_args(tmp_path, str(tmp_path / "ck"), tmp_path / "port", "uint16",
                              False, extra) + ["--device", "cpu"])
    web = os.path.join("exp", "test_latest_iter5")
    ref = _read_outputs(str(tmp_path / "jax" / web))[
        os.path.join("volumes", "output_volume_xy-view_iter-5.tif")]
    assert res["fake"].shape == shape and res["fake"].std() > 0
    d = np.abs(res["fake"].astype(np.int64) - ref.astype(np.int64))
    assert d.max() <= GEN_LSB, d.max()


def test_simulationcrop_matches_jax_cli(tmp_path, monkeypatch, checkpoint):
    """``--dataset_mode simulationcrop``: the fixed crop before dicing, as the
    JAX CLI cuts it (both datasets' crop moved to fit a small volume; the
    shipped 700^3 at (136, 104, 120) is checked by
    tests/test_torch_host_chain.py)."""
    from neuroclear_tpu.data.simulationcrop_dataset import SimulationCropDataSet as JaxSimCrop
    from neuroclear_tpu_torch.data.simulationcrop_dataset import SimulationCropDataSet

    for cls in (JaxSimCrop, SimulationCropDataSet):
        monkeypatch.setattr(cls, "CROP_OFFSET", (2, 1, 3))
        monkeypatch.setattr(cls, "CROP_SIZE", 12)
    rng = np.random.default_rng(9)
    for sub in ("input", "gt"):
        os.makedirs(tmp_path / sub)
    jax_tiffio.imwrite(str(tmp_path / "input" / "vol.tif"),
                       rng.integers(20000, 40000, (16, 15, 17)).astype(np.uint16))
    jax_tiffio.imwrite(str(tmp_path / "gt" / "vol.tif"),
                       rng.integers(20000, 40000, (12, 12, 12)).astype(np.uint16))
    args = [a if a != "diceImage" else "simulationcrop"
            for a in _args(tmp_path, checkpoint, tmp_path / "jax", "uint16", False)]
    _run_jax_cli(args, monkeypatch)
    res = port_cli.main([a if a != str(tmp_path / "jax") else str(tmp_path / "port")
                         for a in args] + ["--device", "cpu"])
    ref = _read_outputs(str(tmp_path / "jax" / "exp" / "test_latest_iter5"))[
        os.path.join("volumes", "output_volume_xy-view_iter-5.tif")]
    assert res["fake"].shape == ref.shape == (12, 12, 12)
    assert np.abs(res["fake"].astype(np.int64) - ref.astype(np.int64)).max() <= GEN_LSB
