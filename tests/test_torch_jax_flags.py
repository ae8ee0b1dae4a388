"""The JAX CLI's flags that the port's two parsers (the trainers' and
``test_dice``'s) used to reject: ``--suffix`` with JAX's name template, the
flags JAX declares and never reads (taken with JAX's defaults, changing
nothing), ``--direction AtoB``; and the two refused with a pointer to
ROADMAP.md: ``--direction BtoA`` where the step would read a B volume that
the port's datasets do not hold (the trainers; JAX's ``test_dice`` reads no
direction), and ``--debug`` (JAX's ``jax.profiler`` server).

Then every option string of JAX's train parser (each GAN model, each
dataset mode) and test parser against the port's: the same dest and default
(but the deviations named here), or refused with a pointer to ROADMAP.md,
never expanded by prefix into another port flag (``--model test`` once
parsed as ``--model_suffix test``); the fourteen flags of JAX's
``test_dice.py`` the port used to refuse, parsed by both; the trainers'
defaults (``--preprocess none --crop_size 0 0 0``, ``--no_dropout``)
against JAX's; and ``--min_projection_depth`` in the depth draws and in one
Apollo step held against JAX's step on the same draws."""

import argparse
import datetime
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from neuroclear_tpu import data as jax_data
from neuroclear_tpu import models as jax_models
from neuroclear_tpu.data.singlevolume_dataset import SingleVolumeDataset as JaxSingleVolume
from neuroclear_tpu.models import gan_common as jgc
from neuroclear_tpu.models.axial_to_lateral_gan_apollo_model import make_apollo_step
from neuroclear_tpu.nn import factory as jax_factory
from neuroclear_tpu.nn.core import flatten_params
from neuroclear_tpu.options.test_options import TestOptions
from neuroclear_tpu.options.train_options import TrainOptions
from neuroclear_tpu_torch import models, train, train_onecube
from neuroclear_tpu_torch.data.singlevolume_dataset import HostVolumeDataset
from neuroclear_tpu_torch.models.axial_to_lateral_gan_apollo_model import (
    D_NAMES, D_PROBES, G_NAMES, G_PROBES, LOSS_NAMES, MODEL_NAMES, ApolloModel, ProbeDraws)
from neuroclear_tpu_torch.models.test_model import TestModel
from neuroclear_tpu_torch.nn.generators import UNetDeconv
from neuroclear_tpu_torch.options import test_options, train_options
from neuroclear_tpu_torch.utils.weights import init_flat
from test_torch_train_step import (BETA1, CROP, G_A_REL_L2, LAMBDA_A, LR, _assert_grads,
                                   _jax_flat, _port_flat)

TRAIN = ["--dataroot", "x", "--seed", "1", "--device", "cpu", "--name", "run"]
TEST = ["--dataroot", "x", "--device", "cpu", "--dice_size", "16", "16", "16", "--name", "run"]
UNREAD = {"both": [["--load_size", "300"], ["--no_pin_memory"], ["--display_winsize", "128"],
                   ["--server", "lab-3"]],
          "train": [["--momentum", "0.5"], ["--display_ncols", "2"],
                    ["--display_server", "http://h"], ["--display_env", "e"],
                    ["--display_port", "9000"], ["--dice_size", "8", "8", "8"],
                    ["--image_dimension", "3"], ["--phase", "train"]],
          "test": [["--ntest", "4"], ["--background_threshold", "0.1", "0.2"],
                   ["--reference_slice_range", "3", "9"], ["--compare_with_gt"]]}
CASES = ([("train", f) for f in UNREAD["both"] + UNREAD["train"]]
         + [("test", f) for f in UNREAD["both"] + UNREAD["test"]])


def _jax_defaults(options) -> dict:
    p = options().initialize(argparse.ArgumentParser())
    return {a.dest: a.default for a in p._actions}


@pytest.mark.parametrize("parser, flags", [
    *CASES, ("train", ["--direction", "AtoB"]), ("test", ["--direction", "AtoB"]),
    ("test", ["--direction", "BtoA"]), ("train", ["--suffix", "{netG}_{crop_size}"]),
    ("test", ["--suffix", "{netG}_{dice_size}"]),
    ("train", ["--direction", "BtoA"]), ("train", ["--debug"]), ("test", ["--debug"])])
def test_jax_flags(parser, flags):
    mod, base = (train_options, TRAIN) if parser == "train" else (test_options, TEST)
    refused = flags == ["--debug"] or (parser == "train" and flags[-1] == "BtoA")
    if refused:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            mod.parse([*base, *flags])
        return
    opt = mod.parse([*base, *flags])
    plain = mod.parse(base)
    jax_defaults = _jax_defaults(TrainOptions if parser == "train" else TestOptions)
    dest = flags[0][2:]
    assert mod.build_parser(*([["--model", opt.model]] if parser == "train" else [])) \
        .get_default(dest) == jax_defaults[dest]
    if dest == "suffix":
        template = flags[1].format(**{k: v for k, v in vars(opt).items()})
        assert opt.name == "run_" + template
        assert opt.name == ("run_unet_deconv_[0, 0, 0]" if parser == "train"
                            else "run_unet_deconv_[16, 16, 16]")
        return
    # the flag changes nothing else the port reads
    assert {k: v for k, v in vars(opt).items() if k != dest} == \
        {k: v for k, v in vars(plain).items() if k != dest}


GAN_MODELS = ("axial_to_lateral_gan_apollo", "axial_to_lateral_gan_athena",
              "axial_to_lateral_gan_dryops")
DATASET_MODES = ("singlevolume", "cube", "diceImage", "simulationcrop")
# the port's own flags, which JAX's parsers do not have
PORT_ONLY = {"train": {"--device"}, "test": {"--device", "--legacy_pipeline"}}
# defaults the port keeps where JAX's name nothing either package has
# (ROADMAP.md's deviations): --model cycle_gan and --dataset_mode braincube
# for the trainers, --dataset_mode single (braincube under a GAN model's
# name) for test_dice
DEVIATIONS = {"train": {"--model": "axial_to_lateral_gan_apollo",
                        "--dataset_mode": "singlevolume"},
              "test": {"--dataset_mode": "diceImage"}}
# the test parser's fourteen flags, each with a value to parse
TEST_FLAGS = [["--model", "test"], ["--add_date"], ["--batch_size", "4"],
              ["--crop_size", "8", "8", "8"], ["--display_histogram"], ["--host_augment"],
              ["--init_gain", "0.1"], ["--input_nc", "1"], ["--output_nc", "1"],
              ["--n_layers_D", "5"], ["--ndf", "32"], ["--netD", "n_layers"],
              ["--profile_dir", "p"], ["--verbose"]]
JAX_TEST = ["--dataroot", "x", "--dataset_mode", "diceImage", "--dice_size", "16", "16", "16",
            "--name", "run"]


def _jax_parser(kind: str, model: str, mode: str) -> argparse.ArgumentParser:
    """JAX's parser as ``BaseOptions.gather_options`` builds it for
    ``--model model --dataset_mode mode``."""
    options = TrainOptions() if kind == "train" else TestOptions()
    p = options.initialize(argparse.ArgumentParser())
    p = jax_models.get_option_setter(model)(p, options.isTrain)
    return jax_data.get_option_setter(mode)(p, options.isTrain)


def _strings(p: argparse.ArgumentParser) -> dict:
    """{option string: (dest, default)} but --help."""
    return {s: (a.dest, p.get_default(a.dest)) for a in p._actions for s in a.option_strings
            if s not in ("-h", "--help")}


def _value(action: argparse.Action) -> list:
    """A value for the option (none for a switch)."""
    if action.nargs == 0:
        return []
    values = action.default if isinstance(action.default, list) else [action.default]
    values = [str(v) for v in values if v not in (None, float("inf"))] or ["1", "2"]
    return values if action.nargs else values[:1]


@pytest.mark.parametrize("kind, model, mode", [
    *[("train", m, d) for m in GAN_MODELS for d in DATASET_MODES],
    *[("test", m, d) for m in ("test", *GAN_MODELS) for d in DATASET_MODES]])
def test_every_jax_option_string(kind, model, mode):
    """For each option string of JAX's parser (this model, this dataset):
    the port's parser has it, with JAX's dest and default (but the listed
    deviations), or parsing it is refused with a pointer to ROADMAP.md; so
    no JAX flag expands by prefix into another port flag.  The port's own
    flags are the listed ones."""
    jax_p = _jax_parser(kind, model, mode)
    jax_s = _strings(jax_p)
    argv = ["--model", model, "--dataset_mode", mode]
    port_p = (train_options if kind == "train" else test_options).build_parser(argv)
    port_s = _strings(port_p)
    base = (["--dataroot", "x", "--seed", "1", "--device", "cpu", *argv] if kind == "train"
            else ["--dataroot", "x", "--device", "cpu", "--dice_size", "16", *argv])
    parse = train_options.parse if kind == "train" else test_options.parse
    refused = kind == "test" and mode not in test_options.PORTED_VALUES["dataset_mode"]
    for s, (dest, default) in jax_s.items():
        if refused:
            value = {"--model": [model], "--dataset_mode": [mode]}.get(
                s, _value(jax_p._option_string_actions[s]))
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                parse([*base, s, *value])
            continue
        assert s in port_s, s
        want = (dest, DEVIATIONS[kind].get(s, default))
        assert port_s[s] == want, (s, port_s[s], want)
    if not refused:
        assert set(port_s) - set(jax_s) == PORT_ONLY[kind] | (
            {"--overlap", "--border_cut"} if kind == "test" and mode in DATASET_MODES[:2]
            else set())


@pytest.mark.parametrize("flags", TEST_FLAGS)
def test_test_dice_takes_the_jax_flag(flags, tmp_path):
    """Each of the fourteen flags of JAX's ``test_dice.py`` that the port
    used to refuse: the same value from the same argv, and JAX's default
    without it; ``--add_date`` prefixes the name with the stamp and
    ``--batch_size`` is forced to 1 by the CLI, as in JAX."""
    dest = flags[0][2:]
    jax_opt = TestOptions().gather_options([*JAX_TEST, *flags])
    jax_plain = TestOptions().gather_options(JAX_TEST)
    port = test_options.parse([*JAX_TEST, "--device", "cpu", *flags])
    plain = test_options.parse([*JAX_TEST, "--device", "cpu"])
    assert getattr(port, dest) == getattr(jax_opt, dest)
    assert getattr(plain, dest) == getattr(jax_plain, dest)
    if dest == "add_date":
        assert re.fullmatch(r"\d{8}-\d{4}_run", port.name)
        stamp = datetime.datetime.strptime(port.name[:13], "%Y%m%d-%H%M")
        assert abs((datetime.datetime.now() - stamp).total_seconds()) < 180
        return
    assert port.name == "run"
    if dest == "batch_size":
        from neuroclear_tpu_torch import test_dice
        opt = test_dice.parse_options([*JAX_TEST, "--device", "cpu", *flags, "--results_dir",
                                       str(tmp_path)])
        assert opt.batch_size == 1


@pytest.mark.parametrize("flags", [["--model", "cycle_gan"], ["--model", "axial_to_lateral_gan"],
                                   ["--model", "axial_to_lateral_gan_apollo", "--netG_B",
                                    "resnet_9blocks"], ["--image_dimension", "2"],
                                   ["--model", "axial_to_lateral_gan_dryops", "--netG",
                                    "resnet_9blocks"]])
def test_test_dice_refuses_what_is_not_ported(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        test_options.parse([*JAX_TEST, "--device", "cpu", *flags])


def test_suffix_formats_the_crop_size():
    """A ``--suffix`` naming ``{crop_size}`` formats as JAX's does (the
    port's test parser had no crop size)."""
    argv = [*JAX_TEST, "--suffix", "{netG}_{crop_size}"]
    jax_opt = TestOptions().gather_options(argv)
    port = test_options.parse([*argv, "--device", "cpu"])
    assert port.name == "run_" + "{netG}_{crop_size}".format(**vars(jax_opt))
    assert port.name == "run_unet_deconv_[0, 0, 0]"


@pytest.mark.parametrize("extra, suffix", [([], ""), (["--model_suffix", "_A"], "_A"),
                                           (["--model_suffix", "_A", "--model", "test"], "_A")])
def test_model_test_is_not_a_suffix(tmp_path, extra, suffix):
    """``--model test`` is the model, never ``--model_suffix`` by prefix:
    the CLI loads ``latest_net_G{model_suffix}.npz``, as JAX's TestModel
    names it, not the ``latest_net_Gtest.npz`` beside it."""
    argv = [*JAX_TEST, "--model", "test", *extra]
    jax_opt = TestOptions().gather_options(argv)
    opt = test_options.parse([*argv, "--device", "cpu", "--checkpoints_dir", str(tmp_path)])
    assert (opt.model, opt.model_suffix) == (jax_opt.model, jax_opt.model_suffix) == ("test",
                                                                                    suffix)
    os.makedirs(tmp_path / "run")
    flat = init_flat(UNetDeconv(1, 1), seed=0)
    for name in (f"latest_net_G{suffix}.npz", "latest_net_Gtest.npz"):
        np.savez(tmp_path / "run" / name, **flat)
    model = TestModel(opt, "cpu")
    model.setup(opt)
    assert model.model_names == ["G" + suffix]
    assert model.loaded == [str(tmp_path / "run" / f"latest_net_G{suffix}.npz")]


def test_verbose_prints_the_generator(tmp_path, capsys):
    os.makedirs(tmp_path / "run")
    np.savez(tmp_path / "run" / "latest_net_G.npz", **init_flat(UNetDeconv(1, 1), seed=0))
    for verbose in (False, True):
        opt = test_options.parse([*JAX_TEST, "--device", "cpu", "--checkpoints_dir",
                                  str(tmp_path), *(["--verbose"] if verbose else [])])
        TestModel(opt, "cpu").setup(opt)
        out = capsys.readouterr().out
        assert ("UNetDeconv(" in out) == verbose
        assert "[Network G] Total number of parameters" in out


@pytest.mark.parametrize("model", GAN_MODELS)
@pytest.mark.parametrize("trainer", ["train_onecube", "train"])
def test_trainer_defaults_are_jaxs(model, trainer):
    """The same argv through JAX's parser and the port's trainer: every
    option both have takes the same value (--preprocess none, --crop_size
    0 0 0, the GAN models' --no_dropout among them)."""
    mode = "singlevolume" if trainer == "train_onecube" else "cube"
    argv = ["--dataroot", "x", "--model", model, "--dataset_mode", mode, "--seed", "1"]
    jax_opt = TrainOptions().gather_options(argv)
    port = (train_options.parse if trainer == "train_onecube" else train.parse)(
        [*argv, "--device", "cpu"])
    assert (port.preprocess, port.crop_size, port.no_dropout) == ("none", [0, 0, 0], True)
    shared = set(vars(jax_opt)) & set(vars(port))
    assert shared >= {"preprocess", "crop_size", "no_dropout", "batch_size", "lr"}
    assert {k: getattr(port, k) for k in shared} == {k: getattr(jax_opt, k) for k in shared}


@pytest.mark.usefixtures("one_thread")
def test_the_default_argv_trains_on_the_whole_volume(tmp_path, monkeypatch):
    """Without --preprocess and --crop_size the trainer takes JAX's defaults:
    the host chain, whose item is the whole volume, JAX's item."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    (tmp_path / "data").mkdir()
    vol = np.random.default_rng(2).integers(0, 60000, (20, 24, 28), np.uint16)
    np.save(tmp_path / "data" / "v.npy", vol)
    argv = ["--dataroot", str(tmp_path / "data"), "--checkpoints_dir", str(tmp_path / "ck"),
            "--model", "axial_to_lateral_gan_apollo", "--dataset_mode", "singlevolume",
            "--seed", "0"]
    _, dataset, _ = train_onecube.setup(train_options.parse([*argv, "--device", "cpu"]))
    assert isinstance(dataset, HostVolumeDataset)
    jax_opt = TrainOptions().gather_options(argv)
    jax_opt.isTrain = True
    ours, ref = dataset[0]["A"], JaxSingleVolume(jax_opt)[0]["A"]
    assert np.array_equal(ours, ref) and np.asarray(ours).shape == vol.shape


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


MIN_DEPTH, MAX_DEPTH = 5, 8


@pytest.mark.parametrize("model", ["axial_to_lateral_gan_apollo", "axial_to_lateral_gan_dryops"])
def test_min_projection_depth_bounds_the_draws(model):
    """``--min_projection_depth`` reaches the step's config and the depth is
    drawn on [max(2, min), projection_depth], every value of it taken."""
    argv = ["--dataroot", "x", "--model", model, "--randomize_projection_depth",
            "--projection_depth", str(MAX_DEPTH), "--min_projection_depth", str(MIN_DEPTH)]
    m = models.create_model(train_options.build_parser(argv).parse_args(argv), "cpu")
    assert m.cfg.min_projection_depth == MIN_DEPTH
    gen = torch.Generator().manual_seed(0)
    depths = {m.draw_probes((CROP,) * 3, gen).depth for _ in range(200)}
    assert depths == set(range(MIN_DEPTH, MAX_DEPTH + 1))
    argv[-1] = "1"  # below 2: the bound is 2, as in JAX
    m = models.create_model(train_options.build_parser(argv).parse_args(argv), "cpu")
    assert {m.draw_probes((CROP,) * 3, gen).depth for _ in range(200)} == set(
        range(2, MAX_DEPTH + 1))


@pytest.mark.usefixtures("one_thread")
def test_a_step_with_min_projection_depth_matches_jax():
    """One Apollo step with ``--randomize_projection_depth
    --min_projection_depth 5 --projection_depth 8`` against JAX's step
    (``host_step._micro`` of ``make_apollo_step``) on the same crop and
    draws, the depth drawn by JAX's ``sample_projection_depth``: the bounds
    of tests/test_torch_train_step.py (losses, fake and rec rtol 1e-4; D and
    G_B gradients 1e-3 relative L2, G_A 1e-2)."""
    nets = {"G_A": jax_factory.define_G(1, 1, 64, "unet_deconv", "instance", dimension=3),
            "G_B": jax_factory.define_G(1, 1, 64, "deep_linear_gen", "instance", dimension=3)}
    for name in D_NAMES:
        nets[name] = jax_factory.define_D(1, 64, "basic", 3, "instance", dimension=2)
    keys = jax.random.split(jax.random.PRNGKey(3), len(MODEL_NAMES) + 1)
    params = {n: nets[n].init(keys[i], "kaiming", 0.02) for i, n in enumerate(MODEL_NAMES)}
    cfg = jgc.GanStepConfig(gan_mode="lsgan", lambda_A=LAMBDA_A, lambda_plane=(1, 1, 1),
                            randomize_projection_depth=True, projection_depth=MAX_DEPTH,
                            min_projection_depth=MIN_DEPTH, beta1=BETA1, precision="float32",
                            grad_accum=2, accum_host=True)
    host_step = make_apollo_step(nets, jgc.make_adam(BETA1), cfg)
    rng = keys[-1]
    real = np.random.default_rng(5).random((1, CROP, CROP, CROP, 1)).astype(np.float32)
    gp = {k: params[k] for k in G_NAMES}
    dp = {k: params[k] for k in D_NAMES}
    zeros = lambda t: jax.tree.map(jnp.zeros_like, t)  # noqa: E731
    g_acc, d_acc, aux, fake, rec = host_step._micro(gp, dp, zeros(gp), zeros(dp), rng,
                                                    jnp.asarray(real))
    k_depth, k_g, k_d = jax.random.split(rng, 3)
    depth = int(jgc.sample_projection_depth(k_depth, cfg))
    assert MIN_DEPTH <= depth <= MAX_DEPTH

    def draw(plan, ks):
        return tuple(int(jax.random.randint(k, (), 0, CROP - depth if kind == "proj" else CROP))
                     for (kind, _, _, _), k in zip(plan, ks))

    draws = ProbeDraws(depth, draw(G_PROBES, jax.random.split(k_g, 6)),
                       draw(D_PROBES, jax.random.split(k_d, 12)))
    argv = ["--dataroot", "unused", "--gan_mode", "lsgan", "--lambda_A", str(LAMBDA_A),
            "--randomize_projection_depth", "--projection_depth", str(MAX_DEPTH),
            "--min_projection_depth", str(MIN_DEPTH), "--lr", str(LR), "--beta1", str(BETA1)]
    model = ApolloModel(train_options.build_parser(argv).parse_args(argv), "cpu")
    model.load_flats({n: flatten_params(params[n]) for n in MODEL_NAMES})
    losses, pfake, prec, gg, dg = model.gradients(torch.from_numpy(real), draws)
    for name in LOSS_NAMES:
        assert float(losses[name]) == pytest.approx(float(aux[name]), rel=1e-4), name
    for port, ref in ((pfake.numpy(), np.asarray(fake)), (prec.numpy(), np.asarray(rec))):
        np.testing.assert_allclose(port, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    _assert_grads(_port_flat(model, D_NAMES, dg), _jax_flat(d_acc, D_NAMES), 1e-3)
    pg, jg = _port_flat(model, G_NAMES, gg), _jax_flat(g_acc, G_NAMES)
    for net, bar in (("G_B.", 1e-3), ("G_A.", G_A_REL_L2)):
        _assert_grads({k: v for k, v in pg.items() if k.startswith(net)},
                      {k: v for k, v in jg.items() if k.startswith(net)}, bar)
