"""The port's per-cube loop (``test_dice --legacy_pipeline``, and
``--histogram_match``, which runs it) against the JAX package's ``test_dice.py``,
both on the CPU, on the same TIFF volume, ground truth and JAX-initialised
checkpoint: 8 cubes of 24^3 (dice 16, overlap 4, border_cut 4) in float32.

Each case runs both CLIs once (a module-scoped fixture) and is checked for:
  * the same files under the results folder (volumes, projections, the two
    HTML galleries, their PNG thumbnails, metrics.txt);
  * the input volume and its projections bitwise equal (the same host code on
    the same cubes);
  * the output volume within GEN_LSB uint16 LSB, the generator's own f32
    bound (tests/test_torch_test_dice_cli.py), grown by the percentile
    stretch as there; with --histogram_match a voxel whose output lies
    within that bound of another's may swap ranks with it, and then takes
    the input cube's value at the other rank: measured on these weights, 7%
    of voxels move, 3.2% by more than GEN_LSB, the mean by 1.8-2.5 LSB and
    the worst by 262-766 LSB.  Bound: at most HIST_FRAC_OVER of voxels off
    by more than GEN_LSB and a mean of at most HIST_MEAN_LSB;
  * the two HTML pages identical text, and every PNG pixel-equal to what the
    JAX package's own ``populate_webpages`` writes from the port's volumes
    (decoded with PIL here only), and the input thumbnails pixel-equal to the
    JAX CLI's (the output thumbnails follow from the output volume's bound
    through that same code);
  * metrics.txt: the input's metrics against the JAX CLI's file, the
    output's against the JAX CLI's own ``compute_gt_metrics`` on the port's
    volumes, within the bounds of tests/test_torch_test_dice_cli.py.
"""

import os
import re
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
from PIL import Image

from neuroclear_tpu.nn.core import flatten_params
from neuroclear_tpu.nn.generators import UNetDeconv as JaxUNetDeconv
from neuroclear_tpu.ops import pallas_wconv
from neuroclear_tpu.utils import html as jax_html
from neuroclear_tpu.utils import tiffio as jax_tiffio
from neuroclear_tpu_torch import test_dice as port_cli

GEN_LSB = 14
HIST_FRAC_OVER, HIST_MEAN_LSB = 0.05, 4.0
PSNR_TOL, SSIM_TOL = 1e-3, 1e-4
METRIC_RE = re.compile(r"\((psnr|ssim): ([-0-9.]+)\)")
SHAPE = (14, 12, 10)  # padded to 28^3: 2 x 2 x 2 cubes
WEB = os.path.join("exp", "test_latest_iter5")
OUT = os.path.join("volumes", "output_volume_xy-view_iter-5.tif")

CASES = {
    "plain": (["--legacy_pipeline"], "uint16"),
    "repetition": (["--legacy_pipeline", "--repetition"], "uint16"),
    "histogram_match": (["--histogram_match"], "uint16"),
    "histogram_match_repetition": (["--histogram_match", "--repetition"], "uint16"),
    "normalize_intensity": (["--legacy_pipeline", "--normalize_intensity"], "uint16"),
    "uint8": (["--legacy_pipeline", "--save_slices"], "uint8"),
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("legacy")
    params = JaxUNetDeconv(1, 1).init(jax.random.PRNGKey(3), "kaiming", 0.02)
    (root / "ckpt" / "exp").mkdir(parents=True)
    np.savez(root / "ckpt" / "exp" / "iter_5_net_G_A.npz", **flatten_params(params))
    rng = np.random.default_rng(1)
    z, y, x = np.meshgrid(*(np.arange(n, dtype=np.float64) for n in SHAPE), indexing="ij")
    gt = np.clip(0.5 + 0.3 * np.sin(z / 3.0) * np.cos(y / 4.0) * np.sin(x / 2.5 + 1.0), 0, 1)
    vol = np.clip(gt + rng.normal(0, 0.08, SHAPE), 0, 1)
    for sub, arr in (("input", vol), ("gt", gt)):
        (root / sub).mkdir()
        jax_tiffio.imwrite(str(root / sub / "vol.tif"), (arr * 65535).astype(np.uint16))
    return root


def cli_args(root, results, flags, data_type):
    return ["--dataroot", str(root / "input"), "--dataroot_gt", str(root / "gt"),
            "--name", "exp", "--checkpoints_dir", str(root / "ckpt"),
            "--results_dir", str(results), "--model_suffix", "_A", "--load_iter", "5",
            "--serial_batches", "--preprocess", "addColorChannel", "--dataset_mode", "diceImage",
            "--netG", "unet_deconv", "--image_dimension", "3", "--dice_size", "16", "16", "16",
            "--overlap", "4", "--border_cut", "4", "--data_type", data_type, "--save_volume",
            "--save_projections", *flags]


def run_jax_cli(argv):
    """The JAX package's test_dice.main in this process (JAX on the CPU),
    restoring the W-pair switch it turns on."""
    import test_dice as jax_cli

    enabled = pallas_wconv.ENABLED
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["test_dice.py"] + argv)
        try:
            jax_cli.main()
        finally:
            pallas_wconv.ENABLED = enabled


def files_under(web_dir) -> list:
    return sorted(os.path.relpath(os.path.join(r, f), web_dir)
                  for r, _, fs in os.walk(web_dir) for f in fs)


def read_png(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, inputs):
    """Both CLIs on one case: (flags, data_type, the JAX CLI's results folder,
    the port's result)."""
    name = request.param
    flags, data_type = CASES[name]
    out = inputs / name
    run_jax_cli(cli_args(inputs, out / "jax", flags, data_type))
    res = port_cli.main(cli_args(inputs, out / "port", flags, data_type) + ["--device", "cpu"])
    assert res["web_dir"] == str(out / "port" / WEB)
    return flags, data_type, str(out / "jax" / WEB), res


def test_legacy_volumes_match_jax(case):
    flags, data_type, jax_web, res = case
    files = files_under(res["web_dir"])
    assert files == files_under(jax_web)
    assert {"index.html", "index_wholeimg.html", "metrics.txt", OUT} <= set(files)
    ref = {f: jax_tiffio.imread(os.path.join(jax_web, f)) for f in files if f.endswith(".tif")}
    got = {f: jax_tiffio.imread(os.path.join(res["web_dir"], f)) for f in ref}
    for f in ref:
        assert got[f].dtype == ref[f].dtype and got[f].shape == ref[f].shape, f
        if "input" in f or "real" in f:
            assert np.array_equal(got[f], ref[f]), f
    assert np.array_equal(got[OUT], res["fake"]) and res["fake"].shape == SHAPE
    assert res["fake_streamed"] is None and res["fake"].std() > 0

    full = {"uint16": 65535.0, "uint8": 255.0}[data_type]
    bound = (GEN_LSB - 1) / 65535
    if "--normalize_intensity" in flags:
        p1, p99 = np.percentile(ref[OUT].astype(np.float64) / full, (0.25, 99.75))
        bound *= 3.0 / (p99 - p1)
    tol = bound * full + 1.0  # plus one unit for the truncating cast
    for f in ref:
        if "input" in f or "real" in f:
            continue
        d = np.abs(got[f].astype(np.float64) - ref[f].astype(np.float64))
        if "--histogram_match" in flags:
            assert (d > tol).mean() <= HIST_FRAC_OVER and d.mean() <= HIST_MEAN_LSB, (f, d.max())
        else:
            assert d.max() <= tol, (f, d.max(), tol)


def test_legacy_galleries_match_jax(case, tmp_path):
    """The pages as identical text; every thumbnail pixel-equal to the JAX
    package's own gallery code on the port's volumes; the input thumbnails
    pixel-equal to the JAX CLI's."""
    import test_dice as jax_cli

    flags, data_type, jax_web, res = case
    opt = SimpleNamespace(skip_real=False, aspect_ratio=1.0, name="exp", phase="test",
                          epoch="latest")
    page = jax_html.HTML(str(tmp_path), "Experiment = exp, Phase = test, Epoch = latest")
    jax_cli.populate_webpages(opt, str(tmp_path), page, {"fake": res["fake"], "real": res["real"]})
    pngs = [f for f in files_under(res["web_dir"]) if f.endswith(".png")]
    assert pngs == [f for f in files_under(str(tmp_path)) if f.endswith(".png")]
    assert len(pngs) == 2 * len(range(0, SHAPE[0], max(1, SHAPE[0] // 16))) + 6
    for page_name in ("index.html", "index_wholeimg.html"):
        with open(os.path.join(res["web_dir"], page_name)) as a, \
                open(os.path.join(jax_web, page_name)) as b, \
                open(os.path.join(tmp_path, page_name)) as c:
            text = a.read()
            assert text == b.read() == c.read(), page_name
    for f in pngs:
        got = read_png(os.path.join(res["web_dir"], f))
        assert got.dtype == np.uint8 and got.ndim == 2
        assert np.array_equal(got, read_png(os.path.join(tmp_path, f))), f
        if "/input_" in f:
            assert np.array_equal(got, read_png(os.path.join(jax_web, f))), f


def test_legacy_metrics_match_jax(case, inputs, tmp_path):
    import test_dice as jax_cli

    flags, data_type, jax_web, res = case
    jax_cli.compute_gt_metrics(SimpleNamespace(dataroot_gt=str(inputs / "gt"), name="exp"),
                               str(tmp_path), {"fake": res["fake"], "real": res["real"]})
    texts = {}
    for label, path in (("jax", os.path.join(jax_web, "metrics.txt")),
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


def test_legacy_skip_real_with_ground_truth_fails_as_in_jax(inputs, tmp_path):
    """--skip_real leaves 'real' unassembled and the metrics read it: both
    CLIs raise a KeyError (the JAX behaviour, copied)."""
    argv = cli_args(inputs, tmp_path / "jax", ["--legacy_pipeline", "--skip_real"], "uint16")
    with pytest.raises(KeyError, match="real"):
        run_jax_cli(argv)
    argv = cli_args(inputs, tmp_path / "port", ["--legacy_pipeline", "--skip_real"], "uint16")
    with pytest.raises(KeyError, match="real"):
        port_cli.main(argv + ["--device", "cpu"])
    # without a ground truth both write the output and galleries of the output only
    for side in ("jax", "port"):
        argv = cli_args(inputs, tmp_path / f"{side}_nogt", ["--legacy_pipeline", "--skip_real"],
                        "uint16")
        i = argv.index("--dataroot_gt")
        del argv[i:i + 2]
        if side == "jax":
            run_jax_cli(argv)
        else:
            port_cli.main(argv + ["--device", "cpu"])
    ours = files_under(str(tmp_path / "port_nogt" / WEB))
    assert ours == files_under(str(tmp_path / "jax_nogt" / WEB))
    assert OUT in ours and not any("input" in f for f in ours)
