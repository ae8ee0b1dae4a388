"""Resume and reporting of the port's trainer on the CPU: the optimizer
state in the JAX layout read and written both ways, the production command
run unchanged (but for a small crop) from a TIFF and resumed, the checkpoint
names of a resumed run against the JAX trainer's, ``--nan_check``, the
watchdog, and the reports (``loss_log.txt``, ``train_opt.txt``, the TIFF
snapshots)."""

import argparse
import contextlib
import glob
import io
import os
import re
import runpy
import sys
import time

import jax
import numpy as np
import pytest
import torch

from neuroclear_tpu.models import gan_common as jgc
from neuroclear_tpu.models.base_model import BaseModel as JaxBaseModel
from neuroclear_tpu.nn.core import flatten_params, unflatten_params
from neuroclear_tpu.nn.schedulers import LRController as JaxLRController
from neuroclear_tpu_torch import train_onecube
from neuroclear_tpu_torch.models import base_model
from neuroclear_tpu_torch.models.axial_to_lateral_gan_apollo_model import (
    D_NAMES, G_NAMES, MODEL_NAMES, ApolloModel)
from neuroclear_tpu_torch.nn.schedulers import LRController
from neuroclear_tpu_torch.options import train_options
from neuroclear_tpu_torch.utils import tiffio
from neuroclear_tpu_torch.utils.weights import flat_from_module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, BETA1 = 1e-4, 0.1
# train_onecube.py's production command, verbatim
PRODUCTION = [
    "--dataset_mode", "singlevolume",
    "--preprocess", "random3Drotate_randomcrop_randomflip_addColorChannel_addBatchChannel",
    "--model", "axial_to_lateral_gan_apollo", "--netG", "unet_deconv",
    "--netG_B", "deep_linear_gen", "--netD", "basic", "--gan_mode", "lsgan",
    "--init_type", "kaiming", "--norm", "instance", "--batch_size", "1", "--lambda_A", "5",
    "--crop_size", "108", "108", "108", "--lambda_plane", "1", "1", "1", "--save_by_iter",
    "--save_latest_freq", "500", "--lr_policy", "constant", "--randomize_projection_depth",
    "--projection_depth", "10", "--display_histogram", "--add_date"]
# the CPU's cut: a 24^3 crop (the smallest the discriminators take)
SMALL = ["--crop_size", "24", "24", "24", "--device", "cpu"]
RESUME = ["--continue_train", "--load_iter", "2", "--max_iters", "2", "--save_latest_freq", "2",
          "--print_freq", "1", "--nan_check"]


class _JaxCheckpoints(JaxBaseModel):
    """The JAX package's checkpoint code (``BaseModel.save_networks``,
    ``load_networks``, ``_save_optim``, ``_load_optim``, which its Apollo
    model inherits unchanged) around the Apollo model's state: the six nets'
    parameter trees, ``opt_state = {"G": ..., "D": ...}`` from its Adam, and
    two LR controllers, without building and initialising the nets."""

    def __init__(self, tmp, flats: dict, **kw):
        opt = argparse.Namespace(isTrain=True, image_dimension=3, checkpoints_dir=str(tmp),
                                 name="exp", seed=0, lr_policy="linear", n_epochs=1,
                                 n_epochs_decay=10, epoch_count=1, lr_decay_iters=50, **kw)
        JaxBaseModel.__init__(self, opt)
        self.model_names = list(MODEL_NAMES)
        self.params = {n: unflatten_params(flats[n]) for n in MODEL_NAMES}
        self.optim = jgc.make_adam(BETA1)
        init = jax.jit(self.optim.init)
        self.opt_state = {"G": init({n: self.params[n] for n in G_NAMES}),
                          "D": init({n: self.params[n] for n in D_NAMES})}
        self.lr_controllers = [JaxLRController(opt.lr_policy, opt) for _ in range(2)]

    set_input = forward = optimize_parameters = None


def _port_model(tmp):
    opt = train_options.build_parser().parse_args(
        ["--dataroot", "unused", "--checkpoints_dir", str(tmp), "--name", "exp",
         "--lr_policy", "linear", "--n_epochs", "1", "--n_epochs_decay", "10",
         "--lr", str(LR), "--beta1", str(BETA1), "--precision", "float32"])
    model = ApolloModel(opt, "cpu")
    model.init_weights(1)
    model.setup(opt)
    return model


def _flats(model) -> dict:
    return {n: flat_from_module(model.nets[n]) for n in MODEL_NAMES}


def _random_grads(model, seed):
    rng = np.random.default_rng(seed)
    return [[torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)) for p in params]
            for params in (model.g_params, model.d_params)]


def _jax_tree(net, grads_by_param: dict) -> dict:
    """Port gradients {torch param name: tensor} -> the JAX nested tree."""
    flat = {}
    for pn, g in grads_by_param.items():
        prefix, leaf = pn.rsplit(".", 1)
        layer = net.get_submodule(prefix)
        flat[f"{prefix}.{'w' if leaf == 'weight' else 'b'}"] = \
            (layer.weight_to_jax(g) if leaf == "weight" else g).numpy()
    return unflatten_params(flat)


def test_jax_optimizer_state_resumes_in_the_port(tmp_path):
    """A ``{suffix}_optim.npz`` and nets written by the JAX checkpoint code
    load in the port: the same parameters, the same Adam state (leaf for
    leaf, conv moments in torch's layout) and the same schedule position;
    the port's next Adam update from it equals optax's on identical
    gradients."""
    model = _port_model(tmp_path)
    jm = _JaxCheckpoints(tmp_path, _flats(model))
    rng = np.random.default_rng(0)
    leaves, treedef = jax.tree_util.tree_flatten(jm.opt_state)
    filled = [np.asarray(3, l.dtype) if l.ndim == 0 else
              np.abs(rng.standard_normal(l.shape)).astype(np.float32) * 1e-3 for l in leaves]
    jm.opt_state = jax.tree_util.tree_unflatten(treedef, [jax.numpy.asarray(x) for x in filled])
    for _ in range(4):
        jm.update_learning_rate()
    model.init_weights(2)  # other weights: the load must replace them
    jm.save_networks("iter_3")

    model.load_networks("iter_3")
    for name in MODEL_NAMES:
        flat = flat_from_module(model.nets[name])
        ref = flatten_params(jm.params[name])
        assert set(flat) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(flat[k], np.asarray(ref[k]), err_msg=k)
    arrays = base_model.optim_arrays(model._optim_groups(), model.lr_controllers)
    assert len([k for k in arrays if not k.startswith("__lr")]) == len(filled)
    for i, ref in enumerate(filled):
        np.testing.assert_array_equal(arrays[str(i)], ref, err_msg=str(i))
    for port_c, jax_c in zip(model.lr_controllers, jm.lr_controllers):
        assert port_c.state() == jax_c.state()
    assert model.lr_scale == jm.lr_scale < 1.0

    # the next update from the loaded state, port against optax
    g_grads, d_grads = _random_grads(model, 1)
    model.apply_gradients(g_grads, d_grads)
    step = jax.jit(lambda p, g, s, lr: _optax_step(jm.optim, p, g, s, lr))
    for names, grads, key in ((G_NAMES, g_grads, "G"), (D_NAMES, d_grads, "D")):
        params = [(n, pn) for n in names for pn, _ in model.nets[n].named_parameters()]
        by_net = {n: {} for n in names}
        for (n, pn), g in zip(params, grads):
            by_net[n][pn] = g
        jax_grads = {n: _jax_tree(model.nets[n], by_net[n]) for n in names}
        new = step({n: jm.params[n] for n in names}, jax_grads, jm.opt_state[key],
                   np.float32(LR * jm.lr_scale))
        # optax takes Adam's bias corrections in float32, where 1 - 0.999**4
        # keeps ~1.5e-5 relative; torch takes them in float64: the updates
        # (of order lr) agree within 2e-5 * lr
        for n in names:
            got = flat_from_module(model.nets[n])
            for k, ref in flatten_params(new[n]).items():
                np.testing.assert_allclose(got[k], np.asarray(ref), rtol=1e-6, atol=2e-5 * LR,
                                           err_msg=f"{n}.{k}")


def _optax_step(optim, params, grads, state, lr):
    updates, _ = optim.update(grads, state)
    return jgc.apply_updates(params, updates, lr)


def test_port_optimizer_state_resumes_in_jax(tmp_path):
    """The port's ``{suffix}_optim.npz`` after two updates loads through the
    JAX checkpoint code, which reports it restored, with equal arrays and
    the same schedule position."""
    model = _port_model(tmp_path)
    for seed in (2, 3):
        model.apply_gradients(*_random_grads(model, seed))
        model.update_learning_rate()
    model.save_networks("iter_2")
    arrays = base_model.optim_arrays(model._optim_groups(), model.lr_controllers)

    other = _port_model(tmp_path)
    other.init_weights(4)
    jm = _JaxCheckpoints(tmp_path, _flats(other), continue_train=True, load_iter=2,
                         epoch="latest", verbose=False)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jm.setup(jm.opt)
    assert "restored optimizer state" in out.getvalue()
    assert "does not match" not in out.getvalue()
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jm.opt_state)]
    assert len(leaves) == len([k for k in arrays if not k.startswith("__lr")])
    assert int(leaves[0]) == 2  # D's count
    for i, leaf in enumerate(leaves):
        np.testing.assert_array_equal(leaf, arrays[str(i)], err_msg=str(i))
    for port_c, jax_c in zip(model.lr_controllers, jm.lr_controllers):
        assert port_c.state() == jax_c.state()
    for name in MODEL_NAMES:
        for k, v in flatten_params(jm.params[name]).items():
            np.testing.assert_array_equal(np.asarray(v), flat_from_module(model.nets[name])[k])


@pytest.fixture(scope="module")
def production(tmp_path_factory):
    """The production command on a 40^3 uint16 TIFF for two iterations,
    then resumed from iter_2 for two more (numbered 4 and 5, as the JAX
    trainer counts them)."""
    tmp = tmp_path_factory.mktemp("prod")
    rng = np.random.default_rng(0)
    vol = (20000 + rng.normal(0, 3000, (40, 40, 40))).clip(0, 65535).astype(np.uint16)
    tiffio.imwrite(str(tmp / "data" / "stack.tif"), vol)
    base = ["--dataroot", str(tmp / "data"), "--name", "prod", "--checkpoints_dir",
            str(tmp / "ck"), *PRODUCTION, "--seed", "0"]
    first = train_onecube.main([*base, "--max_iters", "2", *SMALL])
    name = os.path.basename(os.path.dirname(first["checkpoints"][0]))
    resume_argv = [*base, *SMALL, "--name", name, *RESUME]
    loaded = train_onecube.setup(train_options.parse(resume_argv))[2]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        second = train_onecube.main(resume_argv)
    return dict(tmp=tmp, first=first, second=second, loaded=loaded, name=name,
                stdout=out.getvalue())


def _suffixes(paths) -> list:
    return sorted({os.path.basename(p).split("_net_")[0].split("_optim")[0] for p in paths})


def test_production_command_runs_from_a_tiff_and_resumes(production):
    first, second = production["first"], production["second"]
    assert re.fullmatch(r"\d{8}-\d{4}_prod", production["name"])
    for res in (first, second):
        assert len(res["losses"]) == 2
        assert all(np.isfinite(v) for step in res["losses"] for v in step.values())
        assert res["model"].visuals["fake"].shape == (1, 24, 24, 24, 1)
        assert res["model"].visuals["fake"].dtype == torch.float32  # the default precision
    assert _suffixes(first["checkpoints"]) == ["iter_2"]
    assert _suffixes(second["checkpoints"]) == ["iter_4", "iter_5"]
    assert "restored optimizer state" in production["stdout"]
    ck = production["tmp"] / "ck" / production["name"]
    for suffix in ("iter_2", "iter_4", "iter_5"):
        written = sorted(os.path.basename(p) for p in glob.glob(str(ck / f"{suffix}_*")))
        assert written == sorted([f"{suffix}_net_{n}.npz" for n in MODEL_NAMES]
                                 + [f"{suffix}_optim.npz"])


def test_resume_restores_what_was_in_memory(production):
    """The resumed model holds the first run's parameters, Adam state and
    schedule position at its last save, exactly."""
    a, b = production["first"]["model"], production["loaded"]
    for name in MODEL_NAMES:
        for (pn, p), q in zip(a.nets[name].named_parameters(), b.nets[name].parameters()):
            assert torch.equal(p, q), (name, pn)
    for oa, ob in ((a.optim_g, b.optim_g), (a.optim_d, b.optim_d)):
        for group_a, group_b in zip(oa.param_groups, ob.param_groups):
            for p, q in zip(group_a["params"], group_b["params"]):
                sa, sb = oa.state[p], ob.state[q]
                assert float(sa["step"]) == float(sb["step"]) == 2.0
                assert torch.equal(sa["exp_avg"], sb["exp_avg"])
                assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
    assert [c.state() for c in a.lr_controllers] == [c.state() for c in b.lr_controllers]


def test_reports_of_the_resumed_run(production):
    """loss_log.txt: the header of each run, then the JAX trainer's line per
    --print_freq; train_opt.txt; the visuals as uint8 TIFF at the save;
    TensorBoard's files where it imports."""
    ck = production["tmp"] / "ck" / production["name"]
    text = (ck / "loss_log.txt").read_text()
    assert text.count("================ Training Loss (") == 2
    lines = re.findall(r"^\(epoch: 1, epoch_progress: (\d+)%, iter time: [0-9.]+, data load "
                       r"time: [0-9.]+\) D_A_lateral: [0-9.]+ .*G_B_axial: [0-9.]+ $", text, re.M)
    assert lines == ["4", "5"]
    opts = (ck / "train_opt.txt").read_text()
    assert "continue_train: True" in opts and "display_histogram: True" in opts
    for label in ("real", "fake", "rec"):
        img = tiffio.imread(str(ck / "web" / "images" / f"4_{label}.tif"))
        assert img.shape == (24, 24, 24) and img.dtype == np.uint8
    assert sorted(production["second"]["visuals"]) == sorted(
        str(ck / "web" / "images" / f"4_{label}.tif") for label in ("real", "fake", "rec"))
    try:
        import torch.utils.tensorboard  # noqa: F401
    except ImportError:
        return
    assert glob.glob(str(production["tmp"] / "ck" / "tensorboard" / production["name"] /
                         "events.out.tfevents.*"))


def test_resumed_checkpoint_names_match_the_jax_trainer(production, tmp_path, monkeypatch):
    """The JAX trainer (small nets: the names do not depend on them), run
    and resumed with the production run's save flags, writes the same
    checkpoint names as the port's two runs."""
    rng = np.random.default_rng(1)
    tiffio.imwrite(str(tmp_path / "data" / "v.tif"),
                   rng.integers(0, 65535, (24, 24, 24), dtype=np.uint16))
    base = ["--dataroot", str(tmp_path / "data"), "--name", "n", "--checkpoints_dir",
            str(tmp_path / "ck"), "--dataset_mode", "singlevolume", "--host_augment",
            "--preprocess", "randomcrop_addColorChannel_addBatchChannel",
            "--model", "axial_to_lateral_gan_apollo", "--netG", "linearkernel",
            "--netG_B", "linearkernel", "--netD", "pixel", "--ndf", "8", "--gan_mode", "lsgan",
            "--init_type", "normal", "--norm", "instance", "--crop_size", "12", "12", "12",
            "--projection_depth", "4", "--save_by_iter", "--lr_policy", "constant",
            "--no_html", "--display_id", "0", "--seed", "0"]
    names = []
    for argv in ([*base, "--save_latest_freq", "500", "--max_iters", "2"],
                 [*base, *RESUME]):
        before = set(os.listdir(tmp_path / "ck" / "n")) if names else set()
        monkeypatch.setattr(sys, "argv", ["train_onecube.py", *argv])
        with contextlib.redirect_stdout(io.StringIO()):
            runpy.run_path(os.path.join(REPO, "train_onecube.py"), run_name="__main__")
        written = set(os.listdir(tmp_path / "ck" / "n")) - before
        names.append(_suffixes(f for f in written if f.endswith(".npz")))
    port = [_suffixes(production[k]["checkpoints"]) for k in ("first", "second")]
    assert names == port == [["iter_2"], ["iter_4", "iter_5"]]


def test_nan_check_saves_nan_debug_and_exits_3(tmp_path):
    vol = np.full((30, 30, 30), np.nan, np.float32)
    np.save(tmp_path / "nan.npy", vol)
    with pytest.raises(SystemExit) as e:
        train_onecube.main(["--dataroot", str(tmp_path / "nan.npy"), "--name", "nan",
                            "--checkpoints_dir", str(tmp_path / "ck"), "--nan_check",
                            "--print_freq", "1", "--max_iters", "2", "--precision", "float32",
                            "--seed", "0",
                            "--preprocess", "randomcrop_addColorChannel_addBatchChannel",
                            "--projection_depth", "4", *SMALL])
    assert e.value.code == 3
    written = sorted(os.path.basename(p) for p in glob.glob(str(tmp_path / "ck" / "nan" / "*.npz")))
    assert written == sorted([f"nan_debug_net_{n}.npz" for n in MODEL_NAMES]
                             + ["nan_debug_optim.npz"])


def test_watchdog_fires_only_after_the_first_beat_goes_stale():
    fired = []
    dog = train_onecube.Watchdog(0.2, expire=lambda: fired.append(time.time()))
    time.sleep(0.5)
    assert not fired  # not armed before the first iteration
    dog.beat()
    deadline = time.time() + 10.0
    while not fired and time.time() < deadline:
        time.sleep(0.05)
    assert len(fired) == 1 and fired[0] - dog.last > 0.2
    dog.stop()


def test_schedule_sets_the_learning_rate_of_each_step(tmp_path):
    """Each update runs at --lr times the schedule's scale (linear decay,
    n_epochs 1, n_epochs_decay 10), as the JAX step takes base_lr *
    lr_scale."""
    model = _port_model(tmp_path)
    ref = JaxLRController("linear", argparse.Namespace(epoch_count=1, n_epochs=1,
                                                       n_epochs_decay=10, lr_decay_iters=50))
    for seed in range(3):
        model.apply_gradients(*_random_grads(model, seed))
        for optim in (model.optim_g, model.optim_d):
            assert all(g["lr"] == LR * ref.scale for g in optim.param_groups)
        model.update_learning_rate()
        ref.step(0.0)
    assert isinstance(model.lr_controllers[0], LRController)
