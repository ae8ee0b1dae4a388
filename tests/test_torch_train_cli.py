"""The port's trainer CLI (``python -m neuroclear_tpu_torch.train_onecube``)
end to end on the CPU: a few Apollo steps on a small volume, checkpoints in
the JAX package's format that both packages' inference runs, the crop and
flip sampler against the JAX package's, and the options the port does not
have refused."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroclear_tpu.nn.core import unflatten_params
from neuroclear_tpu.nn.generators import UNetDeconv as JaxUNetDeconv
from neuroclear_tpu.ops.augment import sample_rotated_crop
from neuroclear_tpu_torch import test_dice, train_onecube
from neuroclear_tpu_torch.data.singlevolume_dataset import SingleVolumeDataset
from neuroclear_tpu_torch.models.axial_to_lateral_gan_apollo_model import LOSS_NAMES, MODEL_NAMES
from neuroclear_tpu_torch.nn.generators import UNetDeconv
from neuroclear_tpu_torch.ops.augment import crop_draws, sample_crop
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
    ["--remat"], ["--grad_accum", "2"],
    ["--model", "axial_to_lateral_gan_athena"], ["--netD", "n_layers"],
    ["--preprocess",
     "random3Drotate_random90rotate_randomcrop_randomflip_addColorChannel_addBatchChannel"]])
def test_options_not_ported_are_refused(tmp_path, extra):
    argv = ["--dataroot", str(tmp_path / "missing.npy"), "--device", "cpu", *ARGS, *extra]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_onecube.main(argv)


def test_refuses_without_cuda_unless_the_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs a machine without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_onecube.main(["--dataroot", str(tmp_path / "missing.npy"), *ARGS])
