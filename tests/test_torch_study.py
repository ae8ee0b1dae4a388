"""The simulation quality study's host tools in the port
(``neuroclear_tpu_torch/utils/synthetic.py`` and
``neuroclear_tpu_torch/scripts/``) against the JAX package's
``utils/synthetic.py`` and ``scripts/*.py`` on the same inputs: the
generators bit for bit (functions and CLIs, bead and artifact volumes, the
s4 preset, the 300^3 s4 trio's sha256 that ``chip_smoke.py`` checks on the
card), the diagnostics and the saved-volume eval printing the same lines,
and the checkpoint selection writing the same ``selected.txt`` bytes."""

import contextlib
import importlib.util
import io
import os
import runpy
import sys

import numpy as np
import pytest

import chip_smoke
from neuroclear_tpu.utils import synthetic as jax_synthetic
from neuroclear_tpu.utils import tiffio as jax_tiffio
from neuroclear_tpu_torch.scripts import (diagnose_quality, eval_saved_volumes,
                                          generate_synthetic, select_checkpoint)
from neuroclear_tpu_torch.utils import synthetic, tiffio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")


def _jax_script(name: str):
    """The JAX package's ``scripts/<name>.py`` as a module (its ``__main__``
    block not run)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, SCRIPTS)  # eval_saved_volumes imports diagnose_quality
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(SCRIPTS)
    return mod


def _run_jax_script(name: str, argv: list) -> str:
    """Run ``scripts/<name>.py argv`` in this process; its standard output."""
    out, old = io.StringIO(), sys.argv
    sys.argv = [name, *argv]
    sys.path.insert(0, SCRIPTS)
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(os.path.join(SCRIPTS, f"{name}.py"), run_name="__main__")
    finally:
        sys.argv = old
        sys.path.remove(SCRIPTS)
    return out.getvalue()


def _stdout(fn, *args) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue()


@pytest.mark.parametrize("shape, kw", [
    ((40, 40, 40), dict(n_beads=50, seed=0)),
    ((48, 48, 48), dict(n_beads=120, axial_sigma=4.0, gauss_noise=0.005, poisson_peak=400.0,
                        seed=3)),
    ((40, 48, 44), dict(n_beads=80, bead_sigma_range=(0.5, 2.0), seed=11))])
def test_bead_volumes_are_jaxs_bit_for_bit(shape, kw):
    ours = synthetic.generate_bead_volume(shape=shape, **kw)
    ref = jax_synthetic.generate_bead_volume(shape=shape, **kw)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.uint16 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert ours[0].any() and ours[1].any()


@pytest.mark.parametrize("shape, kw", [((40, 40, 40), dict(n_beads=50, seed=0)),
                                       ((48, 48, 48), dict(n_beads=90, jitter_px=3.0,
                                                           flicker_sigma=0.3, seed=5))])
def test_artifact_volumes_are_jaxs_bit_for_bit(shape, kw):
    ours = synthetic.generate_artifact_volume(shape=shape, **kw)
    ref = jax_synthetic.generate_artifact_volume(shape=shape, **kw)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("flags", [["--size", "40", "--seed", "0"],
                                   ["--size", "48", "--seed", "1", "--preset", "s4"],
                                   ["--size", "40", "--seed", "2", "--mode", "artifact"],
                                   ["--size", "48", "--seed", "0", "--mode", "artifact",
                                    "--preset", "s4", "--n_beads", "70"]])
def test_cli_writes_the_jax_clis_volumes(tmp_path, flags):
    """Both CLIs with the same flags: the three TIFFs read back (each
    package's reader on each file) hold the same volumes."""
    paths = generate_synthetic.main(["--out", str(tmp_path / "port"), *flags])
    _run_jax_script("generate_synthetic", ["--out", str(tmp_path / "jax"), *flags])
    assert [os.path.relpath(p, tmp_path / "port") for p in paths] == \
        ["input/bead_input.tif", "gt/bead_gt.tif", "rotated/bead_rotated.tif"]
    for p in paths:
        q = str(tmp_path / "jax" / os.path.relpath(p, tmp_path / "port"))
        ours, ref = tiffio.imread(p), tiffio.imread(q)
        assert ours.dtype == np.uint16 and ours.shape == (int(flags[1]),) * 3
        np.testing.assert_array_equal(ours, ref)
        np.testing.assert_array_equal(jax_tiffio.imread(p), ref)


def test_the_300_cube_s4_trio_has_the_jax_digest_and_the_smokes():
    """The port's ``--size 300 --preset s4 --seed 0`` trio, the JAX
    generator's with the preset's knobs, and ``chip_smoke.SYNTH_S4_300``
    (the constant the card run checks its own trio against) agree."""
    args = generate_synthetic.build_parser().parse_args(
        ["--out", "unused", "--size", "300", "--seed", "0", "--preset", "s4"])
    ours = synthetic.digest(generate_synthetic.generate(args))
    ref = synthetic.digest(jax_synthetic.generate_bead_volume(
        shape=(300,) * 3, n_beads=2400, axial_sigma=4.0, gauss_noise=0.005,
        poisson_peak=400.0, seed=0))
    assert ours == ref == chip_smoke.SYNTH_S4_300


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    """A small input / output / ground-truth trio written as TIFFs: the
    ground truth and input of a bead volume, and an output between them."""
    tmp = tmp_path_factory.mktemp("trio")
    noisy, gt, _ = synthetic.generate_bead_volume(shape=(36, 40, 38), n_beads=60, seed=4)
    rng = np.random.default_rng(5)
    out = (0.6 * gt + 0.4 * noisy + rng.normal(0, 900, gt.shape)).clip(0, 65535)
    paths = {}
    for name, vol in (("input", noisy), ("output", out.astype(np.uint16)), ("gt", gt)):
        paths[name] = str(tmp / f"{name}.tif")
        tiffio.imwrite(paths[name], vol)
    return paths


def test_report_prints_the_jax_scripts_line(trio):
    jax_dq = _jax_script("diagnose_quality")
    gt = diagnose_quality.to_f32(tiffio.imread(trio["gt"]))
    for tag in ("input", "output"):
        x = diagnose_quality.to_f32(tiffio.imread(trio[tag]))
        np.testing.assert_array_equal(x, jax_dq.to_f32(tiffio.imread(trio[tag])))
        ours = _stdout(diagnose_quality.report, tag, x, gt, 0.05)
        ref = _stdout(jax_dq.report, tag, x, gt, 0.05)
        assert ours == ref and ours.startswith(f"{tag:>8}: protocolPSNR")


@pytest.mark.parametrize("stride", ["0", "2"])
def test_diagnose_quality_prints_the_jax_scripts_rows(trio, stride):
    argv = ["--input", trio["input"], "--output", trio["output"], "--gt", trio["gt"],
            "--stride", stride]
    ours = _stdout(diagnose_quality.main, argv)
    assert ours == _run_jax_script("diagnose_quality", argv)
    assert len(ours.splitlines()) == 4 + (stride == "2")


def test_eval_saved_volumes_prints_the_jax_scripts_rows(trio):
    argv = ["--input", trio["input"], "--output", trio["output"], "--gt", trio["gt"]]
    ours = _stdout(eval_saved_volumes.main, argv)
    ref = _run_jax_script("eval_saved_volumes", argv)
    assert ours == ref
    lines = ours.splitlines()
    assert lines[0].startswith("== protocol rows") and lines[3].startswith("== raw rows")
    assert len(lines) == 6


def _write_logs(d) -> None:
    """The eval logs of ``tests/test_utils_misc.py``'s selection test."""
    def write_log(it, in_psnr, out_psnr, ssim=None):
        body = ("Network Input vs. Groundtruth\n(psnr: %.4f) \n"
                "---\nNetwork Output vs. Groundtruth\n(psnr: %.4f) \n" % (in_psnr, out_psnr))
        if ssim is not None:
            body += "(ssim: %.4f) \n" % ssim
        (d / f"eval_{it}.log").write_text(body)

    write_log(3000, 20.34, 20.10)
    write_log(6000, 20.34, 20.64, ssim=0.61)
    write_log(9000, 20.34, 20.64)  # a tie with 6000: the earlier wins
    write_log(11000, 20.34, 20.01)
    (d / "eval_999.log").write_text("no metrics here")  # skipped
    (d / "eval_final.log").write_text("(psnr: 99.0)")  # not an iteration


def test_select_checkpoint_selects_and_writes_as_jax(tmp_path):
    jax_sel = _jax_script("select_checkpoint")
    ours_dir, ref_dir = tmp_path / "port", tmp_path / "jax"
    for d in (ours_dir, ref_dir):
        d.mkdir()
        _write_logs(d)
    rows = select_checkpoint.scan(str(ours_dir))
    assert rows == jax_sel.scan(str(ref_dir))
    assert [r[0] for r in rows] == [3000, 6000, 9000, 11000]
    assert select_checkpoint.select(rows) == jax_sel.select(rows)
    assert select_checkpoint.select(rows)[0] == 6000
    ours = _stdout(select_checkpoint.main, [str(ours_dir), "--write"])
    assert ours == _stdout(jax_sel.main, [str(ref_dir), "--write"])
    assert (ours_dir / "selected.txt").read_bytes() == (ref_dir / "selected.txt").read_bytes()
    assert (ours_dir / "selected.txt").read_text().startswith("selected: iter 6000 ")
    for d in (tmp_path / "empty_port", tmp_path / "empty_jax"):
        d.mkdir()
    assert select_checkpoint.main([str(tmp_path / "empty_port")]) == 1
    assert jax_sel.main([str(tmp_path / "empty_jax")]) == 1
    assert not (tmp_path / "empty_port" / "selected.txt").exists()
