"""The port's tile pipeline (neuroclear_tpu_torch/parallel/dice_infer.py) and
its entry point against the JAX package's ``run_streaming``, on the CPU.

Both pipelines blend in f32 and cast to uint16 on the device; the bound is 1
uint16 LSB, for a sum order that differs in the last f32 bit before the
truncating cast."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neuroclear_tpu.data.dicing import DiceGrid as JaxDiceGrid
from neuroclear_tpu.nn.core import unflatten_params
from neuroclear_tpu.nn.generators import UNetDeconv as JaxUNetDeconv
from neuroclear_tpu.parallel.dice_infer import DiceInferencePipeline as JaxPipeline
from neuroclear_tpu.utils.imageops import pad_for_dicing as jax_pad_for_dicing
from neuroclear_tpu_torch import test_dice
from neuroclear_tpu_torch.data.dicing import DiceGrid
from neuroclear_tpu_torch.nn.generators import UNetDeconv
from neuroclear_tpu_torch.parallel.dice_infer import DiceInferencePipeline
from neuroclear_tpu_torch.utils import tiffio
from neuroclear_tpu_torch.utils.imageops import pad_for_dicing
from neuroclear_tpu_torch.utils.weights import kaiming_flat

LSB = 1
# the whole slice with the real UNetDeconv: the generator's own f32 bound
# (rtol 1e-4 of an output in [0, 1], test_torch_unet.py) is 6.6 LSB, plus the
# 1 LSB of the truncating cast
E2E_LSB = 8


def _jax_g(params, x):
    """A cheap stand-in generator: sigmoid of a 3x3x3 conv with an
    asymmetric kernel, so flips and borders show."""
    y = jax.lax.conv_general_dilated(x, params["w"], (1, 1, 1), ((1, 1),) * 3,
                                     dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
                                     precision=jax.lax.Precision.HIGHEST)
    return jax.nn.sigmoid(4.0 * y - 1.0)


class _TorchG(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.from_numpy(w).permute(4, 3, 0, 1, 2)  # (O, I, k, k, k)

    def forward(self, x):
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), self.w.to(x.dtype), padding=1)
        return torch.sigmoid(4.0 * y.permute(0, 2, 3, 4, 1) - 1.0)


@pytest.mark.parametrize("size, roi, overlap, b, repetition", [
    (28, 16, 4, 4, False),   # 8 tiles, slabs stitched from z-chunks
    (28, 16, 4, 4, True),    # the same with flip-TTA
    (24, 16, 8, 4, False),   # heavy overlap: the whole-volume branch
])
def test_run_streaming_matches_jax(size, roi, overlap, b, repetition):
    rng = np.random.default_rng(size + overlap + repetition)
    vol = rng.integers(0, 65535, (size, size, size)).astype(np.uint16)
    w = (rng.normal(size=(3, 3, 3, 1, 1)) * 0.5).astype(np.float32)
    orig = (size - 2, size - 1, size - 3)
    assert len(DiceGrid(vol.shape, roi, overlap, b)) == 8
    ref = JaxPipeline(_jax_g, {"w": jnp.asarray(w)}, JaxDiceGrid(vol.shape, roi, overlap, b),
                      1 / 65535.0, tile_batch=2, repetition=repetition,
                      out_dtype=np.uint16, orig_shape=orig).run_streaming(vol)
    rows = []
    out = DiceInferencePipeline(_TorchG(w), DiceGrid(vol.shape, roi, overlap, b),
                                1 / 65535.0, tile_batch=2, repetition=repetition,
                                out_dtype=np.uint16, orig_shape=orig,
                                device="cpu").run_streaming(vol, on_rows=rows.append)
    assert out.dtype == np.uint16 and out.shape == ref.shape == orig
    assert np.array_equal(np.concatenate(rows), out)
    assert np.abs(out.astype(np.int64) - ref.astype(np.int64)).max() <= LSB
    assert out.std() > 0


def test_pad_for_dicing_matches_jax():
    vol = np.arange(7 * 9 * 11, dtype=np.uint16).reshape(7, 9, 11)
    assert np.array_equal(pad_for_dicing(vol, 16, 4), jax_pad_for_dicing(vol, 16, 4))


def test_infer_main_end_to_end_matches_jax(tmp_path):
    """The inference entry point (``test_dice.main``) with a ``.npy`` volume
    and a JAX-format checkpoint: the real UNetDeconv on one 24^3 tile, f32,
    against the JAX pipeline and generator; the written TIFF is the volume
    it returns."""
    rng = np.random.default_rng(21)
    vol = rng.integers(0, 65535, (8, 8, 8)).astype(np.uint16)
    data = tmp_path / "data"
    data.mkdir()
    np.save(data / "vol.npy", vol)
    flat = kaiming_flat(UNetDeconv(1, 1), 5)
    ckpt = tmp_path / "ckpt" / "exp"
    ckpt.mkdir(parents=True)
    np.savez(ckpt / "iter_7_net_G_A.npz", **flat)

    result = test_dice.main([
        "--dataroot", str(data), "--name", "exp", "--checkpoints_dir", str(tmp_path / "ckpt"),
        "--load_iter", "7", "--model_suffix", "_A", "--dice_size", "16", "16", "16",
        "--overlap", "0", "--border_cut", "4", "--tile_batch", "2", "--precision", "float32",
        "--data_type", "uint16", "--results_dir", str(tmp_path / "res"), "--save_volume",
        "--device", "cpu"])
    out_path = os.path.join(str(tmp_path / "res"), "exp", "test_latest_iter7", "volumes",
                            "output_volume_xy-view_iter-7.tif")
    assert result["voxels"] == vol.size and result["seconds"] > 0
    assert result["fake_streamed"] == out_path
    out = result["fake"]
    assert np.array_equal(tiffio.imread(out_path), out)

    vp = jax_pad_for_dicing(vol, 16, 0)
    ref = JaxPipeline(JaxUNetDeconv(1, 1).apply, unflatten_params(flat),
                      JaxDiceGrid(vp.shape, 16, 0, 4), 1 / 65535.0, tile_batch=2,
                      out_dtype=np.uint16, orig_shape=vol.shape).run_streaming(vp)
    assert out.dtype == np.uint16 and out.shape == ref.shape == vol.shape
    assert np.abs(out.astype(np.int64) - ref.astype(np.int64)).max() <= E2E_LSB
    assert out.std() > 0
