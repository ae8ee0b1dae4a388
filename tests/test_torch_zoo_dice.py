"""``test_dice`` with the zoo's generators and norms, the port's CLI
(neuroclear_tpu_torch/test_dice.py) against the JAX package's
``test_dice.py`` run in this process, both in f32 on the CPU, on the same
uint16 TIFF and the same ``.npz`` checkpoint (weights by the port's numpy
init, random biases, batch-norm offsets and running statistics):

  * ``--netG unet_vanilla`` (24^3 tiles: dice 16, border_cut 4, a multiple
    of 8 as the net needs);
  * ``--norm batch`` without ``--eval``: each tile batch normalised by its
    own statistics, as in JAX, so the output depends on ``--tile_batch``
    (two tiles, in one batch and in two), and with ``--eval``: the
    checkpoint's running statistics, whatever the batch; the per-cube loop
    with ``--eval`` too.

The referee is the port's own pipeline with the generator run in float64
(``DiceInferencePipeline._generate`` on a float64 copy of the net, the
tiles, assembly and cast unchanged): the port's f32 output within
PORT_LSB of it; the JAX CLI's within JAX_LSB of it, and the port within the
JAX CLI's distance from it plus PORT_LSB, so the two CLIs compute the same
function up to the JAX CLI's own f32 error.  That error is large here: with
these weights (random biases, offsets and running statistics) the JAX
package's jitted f32 tile pipeline lies up to 24 uint16 LSB from the
float64 run (vanilla; 20 with batch norm), the port's within 1 (measured on
the CPU); the JAX net's own op-by-op apply lies within 1.5 of the port on
random tiles.  PORT_LSB 2: one LSB of f32 noise and one of the truncating
cast.  JAX_LSB 32, the JAX pipeline's measured 24 with a margin."""

import copy
import os
import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from neuroclear_tpu.ops import pallas_wconv
from neuroclear_tpu.utils import tiffio as jax_tiffio
from neuroclear_tpu_torch import test_dice as port_cli
from neuroclear_tpu_torch.nn import factory
from neuroclear_tpu_torch.parallel.dice_infer import DiceInferencePipeline
from neuroclear_tpu_torch.utils.weights import init_flat

PORT_LSB, JAX_LSB = 2, 32
SHAPE = (12, 10, 28)  # two 24^3 tiles along x (dice 16, overlap 0, border_cut 4)
OUT = os.path.join("volumes", "output_volume_xy-view_iter-5.tif")


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo_dice")
    rng = np.random.default_rng(1)
    z, y, x = np.meshgrid(*(np.arange(n, dtype=np.float64) for n in SHAPE), indexing="ij")
    field = 0.5 + 0.3 * np.sin(z / 3.0) * np.cos(y / 4.0) * np.sin(x / 2.5 + 1.0)
    vol = np.clip(field + rng.normal(0, 0.08, SHAPE), 0, 1)
    jax_tiffio.imwrite(str(root / "input" / "vol.tif"), (vol * 65535).astype(np.uint16))
    for name, netG, norm in (("vanilla", "unet_vanilla", "instance"),
                             ("batch", "unet_deconv", "batch")):
        flat = init_flat(factory.define_G(1, 1, 64, netG, norm), "kaiming", 0.02, 3)
        for k, v in flat.items():
            if k.endswith((".b", ".offset", ".running_mean")):
                flat[k] = (rng.normal(size=v.shape) * 0.1).astype(np.float32)
            elif k.endswith(".running_var"):
                flat[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        (root / name).mkdir()
        np.savez(root / name / "iter_5_net_G_A.npz", **flat)
    return root


def _args(root, name, results, extra=()):
    netG, norm = {"vanilla": ("unet_vanilla", "instance"), "batch": ("unet_deconv", "batch")}[name]
    return ["--dataroot", str(root / "input"), "--name", name, "--checkpoints_dir", str(root),
            "--results_dir", str(results), "--model_suffix", "_A", "--load_iter", "5",
            "--serial_batches", "--preprocess", "addColorChannel", "--dataset_mode",
            "diceImage", "--netG", netG, "--norm", norm, "--image_dimension", "3",
            "--dice_size", "16", "16", "16", "--overlap", "0", "--border_cut", "4",
            "--tile_batch", "2", "--precision", "float32", "--data_type", "uint16",
            "--save_volume", *extra]


def _jax_cli(argv, monkeypatch):
    import test_dice as jax_cli

    monkeypatch.setattr(sys, "argv", ["test_dice.py"] + argv)
    enabled = pallas_wconv.ENABLED
    try:
        jax_cli.main()
    finally:
        pallas_wconv.ENABLED = enabled


def _lsb(a, b) -> int:
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def _float64_run(argv, monkeypatch):
    """The port's CLI with the generator in float64 (the tile batches cast
    to float64 and the output back to f32)."""
    generate = DiceInferencePipeline._generate

    def generate64(self, x):
        net, self.net = self.net, copy.deepcopy(self.net).double()
        try:
            return generate(self, x.double()).float()
        finally:
            self.net = net

    with monkeypatch.context() as mp:
        mp.setattr(DiceInferencePipeline, "_generate", generate64)
        return port_cli.main(argv)["fake"]


@pytest.mark.parametrize("name, extra", [("vanilla", ()), ("batch", ()), ("batch", ("--eval",)),
                                         ("batch", ("--eval", "--legacy_pipeline"))])
def test_port_cli_matches_jax_cli(data, tmp_path, monkeypatch, name, extra):
    _jax_cli(_args(data, name, tmp_path / "jax", extra), monkeypatch)
    res = port_cli.main(_args(data, name, tmp_path / "port", extra) + ["--device", "cpu"])
    web = os.path.join(name, "test_latest_iter5")
    ref = jax_tiffio.imread(str(tmp_path / "jax" / web / OUT))
    got = jax_tiffio.imread(os.path.join(res["web_dir"], OUT))
    assert got.shape == ref.shape == SHAPE and got.dtype == np.uint16
    assert got.std() > 0
    if "--legacy_pipeline" not in extra:
        exact = _float64_run(_args(data, name, tmp_path / "f64", extra) + ["--device", "cpu"],
                             monkeypatch)
        assert _lsb(got, exact) <= PORT_LSB
        assert _lsb(ref, exact) <= JAX_LSB
        assert _lsb(got, ref) <= _lsb(ref, exact) + PORT_LSB
    else:  # the loop's cubes alone, in f32, against the fused path's float64
        assert _lsb(got, ref) <= PORT_LSB
    if name == "batch" and "--legacy_pipeline" not in extra:
        # one tile per batch: the same output (but for the convs' sum order
        # at another batch size) only with the running statistics
        one = port_cli.main(_args(data, name, tmp_path / "one", (*extra, "--tile_batch", "1"))
                            + ["--device", "cpu"])
        d = _lsb(one["fake"], res["fake"])
        assert d <= PORT_LSB if "--eval" in extra else d > 100 * JAX_LSB
