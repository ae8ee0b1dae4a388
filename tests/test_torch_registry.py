"""The port's model registry and the trainers' options around it
(``neuroclear_tpu_torch/models/__init__.py``, ``options/train_options.py``),
Athena's all-slices probe against the JAX package's (``ops/sampling.py``),
and the statistics kernel's plans at every discriminator norm shape of an
Athena step at 128^3 and 148^3 crops (each probe a batch of every slice), on
the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroclear_tpu.models import find_model_using_name as jax_find_model
from neuroclear_tpu.ops.sampling import all_slices as jax_all_slices
from neuroclear_tpu_torch import models
from neuroclear_tpu_torch.models import gan_common as gc
from neuroclear_tpu_torch.models.axial_to_lateral_gan_apollo_model import ApolloModel
from neuroclear_tpu_torch.models.axial_to_lateral_gan_athena_model import AthenaModel
from neuroclear_tpu_torch.models.axial_to_lateral_gan_dryops_model import DryopsModel
from neuroclear_tpu_torch.ops import inorm
from neuroclear_tpu_torch.ops.sampling import all_slices
from neuroclear_tpu_torch.options import train_options

MODELS = {"axial_to_lateral_gan_apollo": ApolloModel, "axial_to_lateral_gan_athena": AthenaModel,
          "axial_to_lateral_gan_dryops": DryopsModel}


@pytest.mark.parametrize("name", list(MODELS))
def test_registry_finds_each_model_by_the_jax_convention(name):
    """``--model foo`` -> module ``foo_model``, class ``FooModel``, as JAX
    resolves the same name."""
    assert models.find_model_using_name(name) is MODELS[name]
    assert jax_find_model(name).__name__.lower() == name.replace("_", "") + "model"


@pytest.mark.parametrize("name", ["cycle_gan", "axial_to_lateral_gan", "test"])
def test_registry_refuses_what_is_not_ported(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        models.find_model_using_name(name)


# The options each model adds (its modify_commandline_options in JAX)
OWN = {"axial_to_lateral_gan_apollo": {"lambda_A", "gan_mode", "lambda_plane",
                                       "randomize_projection_depth", "projection_depth",
                                       "min_projection_depth", "netG_B"},
       "axial_to_lateral_gan_athena": {"lambda_A", "pool_size", "gan_mode", "conversion_plane",
                                       "lambda_plane", "netG_B"},
       "axial_to_lateral_gan_dryops": {"lambda_A", "gan_mode", "lambda_plane",
                                       "randomize_projection_depth", "projection_depth",
                                       "min_projection_depth"}}


@pytest.mark.parametrize("name", list(MODELS))
def test_each_model_adds_its_own_options(name):
    base = set(vars(train_options.base_parser().parse_args(["--dataroot", "x"])))
    argv = ["--dataroot", "x", "--model", name]
    opt = train_options.build_parser(argv).parse_args(argv)
    assert set(vars(opt)) - base == OWN[name]


def test_options_of_another_model_are_rejected():
    """Athena has no MIP probe: its parser takes no --projection_depth or
    --min_projection_depth, as the JAX CLI's does not; Dryops no
    --conversion_plane."""
    for name, flag in (("axial_to_lateral_gan_athena", "--projection_depth"),
                       ("axial_to_lateral_gan_athena", "--min_projection_depth"),
                       ("axial_to_lateral_gan_dryops", "--conversion_plane")):
        argv = ["--dataroot", "x", "--model", name, flag, "4"]
        with pytest.raises(SystemExit):
            train_options.build_parser(argv).parse_args(argv)


def test_study_athena_command_parses_through_the_registry():
    """The JAX study's Athena command (scripts/run_study_queue.sh:74-80 with
    run_quality_study.sh's TRAIN_FLAGS)."""
    argv = ["--dataroot", "x", "--dataset_mode", "singlevolume", "--preprocess",
            "random3Drotate_randomcrop_randomflip_addColorChannel_addBatchChannel",
            "--model", "axial_to_lateral_gan_athena", "--conversion_plane", "yz", "xy",
            "--lambda_plane", "1", "1", "1", "--netG", "unet_deconv", "--netG_B",
            "deep_linear_gen", "--netD", "basic", "--gan_mode", "lsgan", "--init_type",
            "kaiming", "--norm", "instance", "--batch_size", "1", "--lambda_A", "5",
            "--crop_size", "128", "128", "128", "--lr_policy", "constant", "--precision",
            "bfloat16", "--remat", "--save_by_iter", "--seed", "0", "--device", "cpu"]
    opt = train_options.parse(argv)
    assert opt.conversion_plane == ["yz", "xy"] and opt.remat and opt.lambda_A == 5
    assert opt.crop_size == [128, 128, 128] and opt.pool_size == 50


@pytest.mark.parametrize("extra", [["--netG", "unet_twoouts"], ["--netG_B", "resnet_9blocks"],
                                   ["--model", "cycle_gan"]])
def test_what_is_not_ported_is_refused_for_athena(extra):
    argv = ["--dataroot", "x", "--model", "axial_to_lateral_gan_athena", "--device", "cpu",
            *extra]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_options.parse(argv)


@pytest.mark.parametrize("model, per_crop", [("axial_to_lateral_gan_apollo", True),
                                             ("axial_to_lateral_gan_athena", False),
                                             ("axial_to_lateral_gan_dryops", False)])
@pytest.mark.parametrize("fused", [False, True])
def test_the_accumulation_form_is_jaxs(model, per_crop, fused):
    """``--grad_accum 2`` with and without ``--fused_accum``: only Apollo
    without it takes its crops one at a time from a sampler (JAX's
    ``supports_input_sampler``); Athena and Dryops take the resident batch,
    as their JAX steps do (tests/test_torch_fused_accum.py runs the forms)."""
    argv = ["--dataroot", "x", "--model", model, "--device", "cpu", "--grad_accum", "2",
            *(["--fused_accum"] if fused else [])]
    opt = train_options.parse(argv)
    assert opt.fused_accum == fused
    assert models.create_model(opt, "cpu").supports_input_sampler == (per_crop and not fused)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_all_slices_matches_jax_on_a_non_cubic_volume(axis):
    vol = np.random.default_rng(axis).random((2, 5, 6, 7, 3)).astype(np.float32)
    got = all_slices(torch.from_numpy(vol), axis)
    want = np.asarray(jax_all_slices(jnp.asarray(vol), axis))
    assert got.shape == want.shape and got.is_contiguous()
    assert np.array_equal(got.numpy(), want)


def test_probe_all_slices_feeds_the_discriminator_every_slice():
    seen = []
    vol = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5, 1)
    gc.probe_all_slices(vol, 2, lambda x: seen.append(x) or x)
    assert seen[0].shape == (2 * 5, 3, 4, 1)
    assert torch.equal(seen[0][7], vol[1, :, :, 2])


def _d_norm_shapes(crop: int) -> list:
    """(N, R, C) of the three instance norms of a ``basic`` discriminator
    applied to every slice of a crop^3 volume: k4 convs, stride 2, 2, 2, 1,
    padding 1."""
    h, shapes = crop, []
    for layer, (stride, c) in enumerate(((2, 64), (2, 128), (2, 256), (1, 512))):
        h = (h + 2 - 4) // stride + 1
        if layer:
            shapes.append((crop, h * h, c))
    return shapes


# {crop: {itemsize: [(slab, slabs, chunks) per norm]}}, from stats_plan
PLANS = {128: {2: [(32, 4, 1), (64, 4, 1), (128, 4, 1)],
               4: [(128, 1, 3), (64, 4, 1), (512, 1, 3)]},
         148: {2: [(128, 1, 2), (256, 1, 2), (512, 1, 2)],
               4: [(128, 1, 2), (256, 1, 2), (512, 1, 2)]}}


@pytest.mark.parametrize("crop", [128, 148])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_stats_plans_at_athenas_discriminator_shapes(crop, itemsize):
    """Every D norm of an Athena step at 128^3 and 148^3 (N = crop slices):
    the plan's tickets within the counters, the blocks tiling the rows, a
    one-chunk plan within one block's read, and at 148^3 D.conv1's output
    (148, 37^2, 128) streaming in two chunks per group."""
    shapes = _d_norm_shapes(crop)
    assert shapes == ([(128, 32 ** 2, 128), (128, 16 ** 2, 256), (128, 15 ** 2, 512)]
                      if crop == 128 else
                      [(148, 37 ** 2, 128), (148, 18 ** 2, 256), (148, 17 ** 2, 512)])
    got = []
    for n, rows, c in shapes:
        plan = inorm.stats_plan(n, rows, c, itemsize)
        got.append((plan.slab, plan.slabs, plan.chunks))
        assert plan.slab * plan.slabs == c
        ranges = [plan.chunk_rows(k, rows) for k in range(plan.chunks)]
        assert ranges[0].start == 0 and ranges[-1].stop == rows
        assert all(a.stop == b.start and len(a) > 0 for a, b in zip(ranges, ranges[1:]))
        if plan.chunks == 1:
            assert rows * plan.slab * itemsize <= inorm._ONE_BLOCK_BYTES
            assert plan.tickets == 0 and plan.scratch == 0
        else:
            assert plan.tickets == n * plan.slabs <= inorm._MAX_TICKETS
    assert got == PLANS[crop][itemsize]


@pytest.mark.parametrize("model, flags", [
    ("axial_to_lateral_gan_athena", ["--conversion_plane", "yz", "xy"]),
    ("axial_to_lateral_gan_dryops", ["--randomize_projection_depth", "--projection_depth", "4"])])
def test_train_onecube_runs_each_model_with_accum_and_remat(tmp_path, model, flags):
    """The study's flags (bf16, --remat) with --grad_accum 2 through the
    single-volume trainer: the model's own losses, each net's checkpoint
    and the optimizer state, the last crop's visuals."""
    from threadpoolctl import threadpool_limits

    from neuroclear_tpu_torch import train_onecube

    rng = np.random.default_rng(4)
    (tmp_path / "data").mkdir()
    np.save(tmp_path / "data" / "v.npy",
            (20000 + rng.normal(0, 3000, (40, 40, 40))).clip(0, 65535).astype(np.uint16))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            res = train_onecube.main([
                "--dataroot", str(tmp_path / "data"), "--checkpoints_dir", str(tmp_path / "ck"),
                "--name", "m", "--model", model, *flags, "--gan_mode", "lsgan", "--lambda_A",
                "5", "--preprocess",
                "random3Drotate_randomcrop_randomflip_addColorChannel_addBatchChannel",
                "--crop_size", "24", "24", "24", "--precision", "bfloat16", "--remat",
                "--grad_accum", "2", "--max_iters", "2", "--save_by_iter", "--seed", "0",
                "--device", "cpu", "--init_type", "kaiming"])
    finally:
        torch.set_num_threads(n)
    m = res["model"]
    assert list(res["losses"][0]) == m.loss_names == MODELS[model].LOSS_NAMES
    assert all(np.isfinite(v) for step in res["losses"] for v in step.values())
    assert set(m.visuals) == set(m.visual_names)
    assert m.visuals["fake"].shape == (1, 24, 24, 24, 1)
    written = sorted(p.name for p in (tmp_path / "ck" / "m").iterdir() if p.suffix == ".npz")
    assert written == sorted([f"iter_2_net_{n}.npz" for n in m.model_names]
                             + ["iter_2_optim.npz"])
