"""The port's trainer CLI (``python -m neuroclear_tpu_torch.train_onecube``)
end to end on the CPU: a few Apollo steps on a small volume, checkpoints in
the JAX package's format that both packages' inference runs, the crop and
flip sampler against the JAX package's, the JAX study's two command lines
(``scripts/run_quality_study.sh``: ``--remat``, and ``--grad_accum``), the
JAX CLI's defaults and flags, the profiler trace and the HTML page, and the
options the port does not have refused."""

import glob
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from neuroclear_tpu.nn.core import unflatten_params
from neuroclear_tpu.nn.generators import UNetDeconv as JaxUNetDeconv
from neuroclear_tpu.ops.augment import sample_rotated_crop
from neuroclear_tpu_torch import test_dice, train_onecube
from neuroclear_tpu_torch.data.singlevolume_dataset import SingleVolumeDataset
from neuroclear_tpu_torch.models.axial_to_lateral_gan_apollo_model import LOSS_NAMES, MODEL_NAMES
from neuroclear_tpu_torch.nn.generators import UNetDeconv
from neuroclear_tpu_torch.ops.augment import crop_draws, sample_crop
from neuroclear_tpu_torch.options import device_of, train_options
from neuroclear_tpu_torch.utils.visualizer import Visualizer
from neuroclear_tpu_torch.utils.weights import load_npz, params_from_numpy

ARGS = ["--model", "axial_to_lateral_gan_apollo", "--netG", "unet_deconv",
        "--netG_B", "deep_linear_gen", "--netD", "basic", "--gan_mode", "lsgan",
        "--init_type", "kaiming", "--norm", "instance", "--lambda_A", "5",
        "--lambda_plane", "1", "1", "1", "--lr_policy", "constant",
        "--randomize_projection_depth", "--projection_depth", "4",
        "--preprocess", "randomcrop_randomflip_addColorChannel_addBatchChannel"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    rng = np.random.default_rng(0)
    field = np.linspace(0, 1, 40, dtype=np.float32)
    vol = (20000 + 15000 * field[:, None, None] * field[None, :, None]
           + rng.normal(0, 3000, (40, 40, 40))).clip(0, 65535).astype(np.uint16)
    os.makedirs(tmp / "data")
    np.save(tmp / "data" / "volume.npy", vol)
    res = train_onecube.main(["--dataroot", str(tmp / "data"), "--name", "cli",
                              "--checkpoints_dir", str(tmp / "ckpt"), "--device", "cpu",
                              "--crop_size", "24", "24", "24", "--max_iters", "2",
                              "--save_latest_freq", "1", "--save_by_iter", "--print_freq", "1",
                              "--precision", "float32", "--seed", "3", *ARGS])
    return tmp, vol, res


def test_losses_are_finite_and_move(trained):
    _, _, res = trained
    assert len(res["losses"]) == 2 and len(res["step_seconds"]) == 2
    for step in res["losses"]:
        assert list(step) == LOSS_NAMES
        assert all(np.isfinite(v) for v in step.values())
    assert any(res["losses"][0][k] != res["losses"][1][k] for k in LOSS_NAMES)


def test_checkpoints_are_written_for_the_six_nets(trained):
    """The six nets and the optimizer state at every save (iteration 2 is
    written twice, at --save_latest_freq and at --max_iters, as the JAX
    trainer writes it)."""
    tmp, _, res = trained
    names = sorted({os.path.basename(p) for p in res["checkpoints"]})
    assert names == sorted([f"iter_{i}_net_{n}.npz" for i in (1, 2) for n in MODEL_NAMES]
                           + [f"iter_{i}_optim.npz" for i in (1, 2)])
    assert not glob.glob(str(tmp / "ckpt" / "cli" / "*.tmp"))


def test_checkpoint_runs_in_jax_and_in_the_port(trained):
    """The written G_A gives the same f32 output through the JAX package's
    UNetDeconv.apply as through the port (rtol 1e-4, the U-Net's bar), and
    the port's inference CLI reads it."""
    tmp, vol, _ = trained
    flat = load_npz(str(tmp / "ckpt" / "cli" / "iter_2_net_G_A.npz"))
    x = (vol[:16, :16, :16].astype(np.float32) / 65535.0)[None, ..., None]
    ref = np.asarray(JaxUNetDeconv(1, 1).apply(unflatten_params(flat), jnp.asarray(x)))
    net = UNetDeconv(1, 1)
    net.load_state_dict(params_from_numpy(flat, net))
    with torch.no_grad():
        y = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    out = test_dice.main(["--dataroot", str(tmp / "data"), "--name", "cli",
                          "--checkpoints_dir", str(tmp / "ckpt"), "--load_iter", "2",
                          "--model_suffix", "_A", "--dice_size", "24", "24", "24",
                          "--overlap", "4", "--border_cut", "2", "--precision", "float32",
                          "--results_dir", str(tmp / "results"), "--device", "cpu"])
    written = out["fake"]
    assert written.shape == vol.shape and written.dtype == np.uint16 and written.std() > 0


@pytest.mark.parametrize("flips", [(False, False, False), (True, False, True),
                                   (False, True, False), (True, True, True)])
def test_crop_sampler_matches_jax(flips):
    """Given the same offsets and flips: vol[crop] / 65535, as JAX's
    sample_rotated_crop(rotate=False) followed by augment_core's flips."""
    rng = np.random.default_rng(7)
    vol = rng.integers(0, 65535, (20, 18, 22), dtype=np.uint16)
    offsets, crop, inv = (3, 1, 5), (12, 16, 10), 1.0 / 65535.0
    ref = sample_rotated_crop(jnp.asarray(vol), 0.0, offsets, crop, inv, rotate=False)
    for axis, f in enumerate(flips):
        if f:
            ref = jnp.flip(ref, axis)
    got = sample_crop(torch.from_numpy(vol.astype(np.int32)), offsets, crop, inv, flips)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_crop_draws_cover_the_inclusive_range():
    """Offsets uniform on [0, extent - crop], both ends reached; flips
    about half the time."""
    gen = torch.Generator().manual_seed(0)
    seen, flips = set(), []
    for _ in range(400):
        (z0, y0, x0), f = crop_draws((10, 12, 9), (8, 12, 9), gen)
        seen.add(z0)
        assert y0 == 0 and x0 == 0
        flips.append(f)
    assert seen == {0, 1, 2}
    assert 0.4 < np.mean(flips) < 0.6
    ds = SingleVolumeDataset(np.zeros((10, 12, 9), np.uint16), (8, 12, 9),
                             "randomcrop_randomflip_addColorChannel_addBatchChannel", "cpu")
    sample = ds.sample(gen)
    assert sample.shape == (1, 8, 12, 9, 1) and sample.dtype == torch.float32


@pytest.mark.parametrize("extra", [
    ["--grad_accum", "2", "--dataset_mode", "cube"], ["--netG", "VGG"],
    ["--netG_B", "unet_twoouts"]])
def test_options_not_ported_are_refused(tmp_path, extra):
    argv = ["--dataroot", str(tmp_path / "missing.npy"), "--device", "cpu", *ARGS, *extra]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_onecube.main(argv)


def test_refuses_without_cuda_unless_the_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs a machine without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_onecube.main(["--dataroot", str(tmp_path / "missing.npy"), *ARGS])


@pytest.fixture
def one_cpu_thread():
    """One CPU thread for torch and BLAS: with a thread per core in each of
    the suite's six workers these steps run tens of times slower than alone
    (a 24^3 bf16 study step: 250 s against 5 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


# scripts/run_quality_study.sh's TRAIN_FLAGS with its default MODEL_FLAGS,
# SAVE_FREQ, PRINT_FREQ and WATCHDOG, verbatim but for the crop (CROP=148)
STUDY = ["--dataset_mode", "singlevolume",
         "--preprocess", "random3Drotate_randomcrop_randomflip_addColorChannel_addBatchChannel",
         "--model", "axial_to_lateral_gan_apollo", "--lambda_plane", "1", "1", "1",
         "--randomize_projection_depth", "--projection_depth", "10",
         "--netG", "unet_deconv", "--netG_B", "deep_linear_gen", "--netD", "basic",
         "--gan_mode", "lsgan", "--init_type", "kaiming", "--norm", "instance",
         "--batch_size", "1", "--lambda_A", "5", "--crop_size", "24", "24", "24",
         "--lr_policy", "constant", "--precision", "bfloat16", "--remat", "--save_by_iter",
         "--save_latest_freq", "50", "--print_freq", "25", "--display_freq", "1000000",
         "--seed", "0", "--watchdog_secs", "300"]


def _volume_dir(tmp):
    rng = np.random.default_rng(4)
    os.makedirs(tmp / "data", exist_ok=True)
    np.save(tmp / "data" / "v.npy",
            (20000 + rng.normal(0, 3000, (40, 40, 40))).clip(0, 65535).astype(np.uint16))
    return str(tmp / "data")


@pytest.mark.usefixtures("one_cpu_thread")
@pytest.mark.parametrize("accum", [[], ["--grad_accum", "2"]])
def test_study_command_lines_run(tmp_path, accum):
    """The study's command (its s4 run) and its ga8 run's (with
    ``--grad_accum``, 2 here) train two iterations: bf16 visuals of one crop
    (the last one with accumulation), finite losses that move, and the
    checkpoint at --max_iters."""
    res = train_onecube.main(["--dataroot", _volume_dir(tmp_path), "--checkpoints_dir",
                              str(tmp_path / "ck"), "--name", "study", *STUDY, *accum,
                              "--max_iters", "2", "--device", "cpu"])
    model = res["model"]
    assert model.cfg.remat and model.cfg.precision == "bfloat16"
    assert res["total_iters"] == 2 and len(res["losses"]) == 2
    assert all(np.isfinite(v) for step in res["losses"] for v in step.values())
    assert any(res["losses"][0][k] != res["losses"][1][k] for k in LOSS_NAMES)
    assert model.visuals["fake"].shape == (1, 24, 24, 24, 1)
    assert model.visuals["fake"].dtype == torch.bfloat16
    assert sorted({os.path.basename(p).split("_net_")[0].split("_optim")[0]
                   for p in res["checkpoints"]}) == ["iter_2"]
    assert all(float(s["step"]) == 2.0 for s in model.optim_g.state.values())


def test_defaults_are_the_jax_clis(tmp_path, capsys):
    """Without --precision, --seed and --init_type: float32, a seed drawn
    per run (printed, and written to train_opt.txt), normal init; and the
    device from --gpu_ids 0."""
    opts = [train_options.parse(["--dataroot", "x", "--checkpoints_dir", str(tmp_path),
                                 "--name", f"run{i}"]) for i in range(2)]
    printed = re.findall(r"drew seed (\d+)", capsys.readouterr().out)
    assert printed == [str(o.seed) for o in opts]
    assert opts[0].seed != opts[1].seed and all(0 <= o.seed < 2 ** 32 for o in opts)
    for o in opts:
        assert (o.precision, o.init_type, o.init_gain) == ("float32", "normal", 0.02)
        assert device_of(o) == "cuda:0"
        train_options.print_options(o)
        text = (tmp_path / o.name / "train_opt.txt").read_text()
        assert re.search(rf"^ +seed: {o.seed} +\t\[default: None\]$", text, re.M)


@pytest.mark.parametrize("flags, device", [
    (["--gpu_ids", "-1"], "cpu"), (["--gpu_ids", "2"], "cuda:2"),
    (["--gpu_ids", "1", "--device", "cpu"], "cpu"), (["--ngf", "64", "--ndf", "64"], None),
    (["--input_nc", "1", "--output_nc", "1"], None), (["--n_layers_D", "5"], None),
    (["--no_dropout"], None), (["--num_threads", "4"], None), (["--display_id", "0"], None),
    (["--no_html", "--update_html_freq", "10"], None),
    (["--init_gain", "0.1", "--init_type", "xavier"], None), (["--profile_dir", "p"], None),
    (["--fused_accum", "--grad_accum", "8"], None), (["--host_augment"], None),
    (["--preprocess",
      "random3Drotate_random90rotate_randomcrop_randomflip_addColorChannel_addBatchChannel"],
     None)])
def test_jax_flags_are_accepted(flags, device):
    opt = train_options.parse(["--dataroot", "x", "--seed", "1", *flags])
    if device is not None:
        assert device_of(opt) == device


@pytest.mark.parametrize("flags", [
    ["--gpu_ids", "0,1"], ["--input_nc", "2"], ["--output_nc", "3"],
    ["--netG", "resnet_6blocks"]])
def test_jax_flag_values_not_ported_are_refused(flags):
    """Values the JAX trainer fails on (two input or three output channels:
    its convs get one-channel crops) or that select paths the port has not."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_options.parse(["--dataroot", "x", "--seed", "1", *flags])


@pytest.mark.parametrize("model, flags", [
    ("axial_to_lateral_gan_apollo", ["--ngf", "32"]),
    ("axial_to_lateral_gan_apollo", ["--ndf", "128"]),
    ("axial_to_lateral_gan_apollo", ["--image_dimension", "2"]),
    ("axial_to_lateral_gan_athena", ["--ndf", "128"]),
    ("axial_to_lateral_gan_dryops", ["--ndf", "32"])])
def test_jax_flag_values_run_as_in_jax(tmp_path, model, flags):
    """Values the JAX trainer runs: ``--ndf`` sizes the discriminators,
    ``--ngf`` and ``--image_dimension`` are read by no GAN model's net.  The
    port's model from the argv holds JAX's model's nets (every parameter's
    name and shape), and on the JAX model's weights its first discriminator
    gives JAX's output on a slice (rtol 1e-4)."""
    from neuroclear_tpu import models as jax_models
    from neuroclear_tpu.nn.core import flatten_params
    from neuroclear_tpu.options.train_options import TrainOptions
    from neuroclear_tpu_torch import models

    argv = ["--dataroot", "x", "--seed", "1", "--model", model, "--dataset_mode",
            "singlevolume", "--checkpoints_dir", str(tmp_path), *flags]
    jax_opt = TrainOptions().gather_options(argv)
    jax_opt.isTrain = True
    jax_model = jax_models.create_model(jax_opt)
    port = models.create_model(train_options.parse([*argv, "--device", "cpu"]), "cpu")
    flats = {n: {k: np.asarray(v) for k, v in flatten_params(p).items()}
             for n, p in jax_model.params.items()}
    assert sorted(flats) == sorted(port.model_names)
    for name, flat in flats.items():
        net = port.nets[name]
        ours = {}
        for pn, p in net.named_parameters():
            prefix, leaf = pn.rsplit(".", 1)
            w = net.get_submodule(prefix).weight_to_jax(p) if leaf == "weight" else p
            ours[f"{prefix}.{'w' if leaf == 'weight' else 'b'}"] = tuple(w.shape)
        assert ours == {k: v.shape for k, v in flat.items()}, name
    port.load_flats(flats)
    d = port.D_NAMES[0]
    x = np.random.default_rng(3).random((1, 32, 32, 1)).astype(np.float32)
    ref = np.asarray(jax_model.nets[d].apply(jax_model.params[d], jnp.asarray(x)))
    with torch.no_grad():
        got = port.nets[d](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.mark.usefixtures("one_cpu_thread")
@pytest.mark.parametrize("init_type", ["normal", "xavier", "orthogonal"])
def test_init_types_build_the_nets(tmp_path, init_type):
    """Each scheme through the trainer's set-up: weights drawn, biases zero,
    every net's weights different from the kaiming ones."""
    argv = ["--dataroot", _volume_dir(tmp_path), "--checkpoints_dir", str(tmp_path / "ck"),
            "--crop_size", "24", "24", "24", "--seed", "0", "--device", "cpu"]
    _, _, model = train_onecube.setup(train_options.parse([*argv, "--init_type", init_type]))
    _, _, kaiming = train_onecube.setup(train_options.parse([*argv, "--init_type", "kaiming"]))
    for name in model.nets:
        for (pn, p), q in zip(model.nets[name].named_parameters(),
                              kaiming.nets[name].parameters()):
            if pn.endswith("bias"):
                assert not p.any()
            else:
                assert p.abs().max() > 0 and not torch.equal(p, q), (name, pn)


def _one_step(tmp_path, *flags):
    return train_onecube.main(["--dataroot", _volume_dir(tmp_path), "--checkpoints_dir",
                               str(tmp_path / "ck"), "--name", "n", *ARGS,
                               "--crop_size", "24", "24", "24", "--max_iters", "1",
                               "--print_freq", "1", "--save_latest_freq", "1",
                               "--update_html_freq", "1", "--device", "cpu", *flags])


@pytest.mark.usefixtures("one_cpu_thread")
def test_profile_trace_and_html_page_with_the_default_precision_and_seed(tmp_path, monkeypatch,
                                                                         capsys):
    """A run without --precision and --seed computes in float32 under the
    seed it prints and writes; --profile_dir holds a Chrome trace of the
    loop; web/index.html shows each visual's PNG; the losses are plotted."""
    plotted = []
    monkeypatch.setattr(Visualizer, "plot_current_losses",
                        lambda self, n, losses: plotted.append(n))
    res = _one_step(tmp_path, "--profile_dir", str(tmp_path / "prof"))
    assert res["model"].visuals["fake"].dtype == torch.float32
    seed = re.search(r"drew seed (\d+)", capsys.readouterr().out).group(1)
    assert f"seed: {seed}" in (tmp_path / "ck" / "n" / "train_opt.txt").read_text()
    with open(tmp_path / "prof" / "trace.json") as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    page = (tmp_path / "ck" / "n" / "web" / "index.html").read_text()
    for label in ("real", "fake", "rec"):
        assert f"images/iter1_{label}.png" in page
        with open(tmp_path / "ck" / "n" / "web" / "images" / f"iter1_{label}.png", "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert plotted == [1] and len(res["visuals"]) == 3


@pytest.mark.usefixtures("one_cpu_thread")
def test_no_html_and_display_id_0_write_no_page_and_plot_nothing(tmp_path, monkeypatch):
    plotted = []
    monkeypatch.setattr(Visualizer, "plot_current_losses",
                        lambda self, n, losses: plotted.append(n))
    res = _one_step(tmp_path, "--no_html", "--display_id", "0", "--seed", "2")
    assert not os.path.exists(tmp_path / "ck" / "n" / "web")
    assert res["visuals"] == [] and plotted == []
    assert (tmp_path / "ck" / "n" / "loss_log.txt").exists()
