"""``--fused_accum`` in the port (``BaseModel.optimize_parameters_batch``:
the N crops of a ``--grad_accum`` step cut first, from the device volume,
and resident together, then the per-crop form's micro-steps and its one
update) on the CPU at 24^3 with the production nets: bit for bit the
per-crop form on the same crops and draws for Apollo, Athena and Dryops,
and through ``train_onecube``.  Against the JAX package's fused steps:
tests/test_torch_fused_accum_jax.py (Apollo), tests/test_torch_athena_more.py
and tests/test_torch_dryops_accum.py (Athena and Dryops, whose JAX steps take
only this form, beside their accumulation cases, sharing their compiled JAX
steps)."""

import shutil
import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from neuroclear_tpu_torch import train_onecube
from neuroclear_tpu_torch.models import create_model
from neuroclear_tpu_torch.options import train_options

CROP, DEPTH, LAMBDA_A = 24, 4, 5.0


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _crops(seed, n=2):
    return torch.from_numpy(
        np.random.default_rng(seed).random((n, CROP, CROP, CROP, 1)).astype(np.float32))


MODELS = {"apollo": ["--model", "axial_to_lateral_gan_apollo", "--randomize_projection_depth",
                     "--projection_depth", str(DEPTH)],
          "athena": ["--model", "axial_to_lateral_gan_athena", "--conversion_plane", "yz",
                     "xy"],
          "dryops": ["--model", "axial_to_lateral_gan_dryops"]}


def _model(name, precision):
    argv = ["--dataroot", "unused", *MODELS[name], "--gan_mode", "lsgan", "--lambda_A",
            str(LAMBDA_A), "--precision", precision, "--grad_accum", "2", "--init_type",
            "kaiming"]
    model = create_model(train_options.build_parser(argv).parse_args(argv), "cpu")
    model.init_weights(7, "kaiming")
    return model


def _state(model) -> list:
    out = [p.detach().clone() for p in model.g_params + model.d_params]
    for optim in (model.optim_g, model.optim_d):
        for p in optim.param_groups[0]["params"]:
            out += [optim.state[p]["exp_avg"].clone(), optim.state[p]["exp_avg_sq"].clone()]
    return out


@pytest.mark.parametrize("name, precision", [("apollo", "float32"), ("apollo", "bfloat16"),
                                             ("athena", "float32"), ("dryops", "float32")])
def test_fused_form_is_the_per_crop_form_bit_for_bit(name, precision):
    """One step each way from the same weights: the same crops, the same
    draws, the same sums in the same order, so the same losses, outputs,
    parameters and Adam moments, bit for bit."""
    per_crop, fused = _model(name, precision), _model(name, precision)
    crops = _crops(10)
    draws = per_crop.draw_probes((CROP,) * 3, torch.Generator().manual_seed(3))
    a = per_crop.optimize_parameters_accum(lambda i: crops[i:i + 1].clone(), 2, draws)
    b = fused.optimize_parameters_batch(crops, draws)
    for k in per_crop.LOSS_NAMES:
        assert torch.equal(a[0][k], b[0][k]), k
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)
    for x, y in zip(_state(per_crop), _state(fused)):
        assert torch.equal(x, y)


def test_trainer_fused_accum_is_the_device_volume_form(tmp_path, monkeypatch):
    """``train_onecube --grad_accum 2 --fused_accum`` (the crops cut first,
    resident together) against ``NEUROCLEAR_ACCUM_DEVICE_VOL=1`` (each cut
    just before its micro-step): the same run, bit for bit."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    (tmp_path / "data").mkdir()
    rng = np.random.default_rng(4)
    np.save(tmp_path / "data" / "v.npy",
            (20000 + rng.normal(0, 3000, (40, 40, 40))).clip(0, 65535).astype(np.uint16))
    argv = ["--dataroot", str(tmp_path / "data"), "--checkpoints_dir", str(tmp_path / "ck"),
            "--preprocess",
            "random3Drotate_randomcrop_randomflip_addColorChannel_addBatchChannel",
            "--crop_size", "24", "24", "24", "--seed", "0", "--device", "cpu", "--no_html",
            "--display_id", "0", "--gan_mode", "lsgan", "--lambda_A", "5", "--init_type",
            "kaiming", "--max_iters", "2", "--grad_accum", "2"]
    fused = train_onecube.main([*argv, "--name", "f", "--fused_accum"])
    monkeypatch.setenv("NEUROCLEAR_ACCUM_DEVICE_VOL", "1")
    per_crop = train_onecube.main([*argv, "--name", "p"])
    assert fused["form"] == "device volume, resident batch"
    assert per_crop["form"] == "device volume, per crop"
    assert fused["losses"] == per_crop["losses"]
    for x, y in zip(_state(fused["model"]), _state(per_crop["model"])):
        assert torch.equal(x, y)
    shutil.rmtree(tmp_path / "ck")  # two 220 MB checkpoint sets
