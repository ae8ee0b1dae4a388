"""The port's epoch trainer (``python -m neuroclear_tpu_torch.train``) end to
end on the CPU: against the JAX package's ``train.py`` run in-process on the
same ``cube`` dataset (two 24^3 volumes, one epoch, ``--serial_batches``, no
random token, so both see the same items) from the same Athena weights
(``--continue_train --epoch init``), its losses step by step and its
checkpoints; with the random host chain and a prefetching loader for each
model; and the loader's order, threads and limits.

Bars: the first step's losses rtol 1e-4 (the same weights and input, the
step's own bar, tests/test_torch_athena.py).  Adam (beta1 0.1) moves each
parameter by lr * g / |g| in its first step, whatever |g|: where the two
packages' f32 gradients differ in sign (near-zero elements; G_A's and the
discriminators' gradients lie ~1e-3-1e-2 apart, see that file), a parameter
moves 2 lr the other way.  So after the first step (``iter_1``
checkpoints) at most ``FLIP_SHARE`` = 1% of each net's elements lie more
than lr from JAX's, and after the epoch at most 1% more than 2 lr (measured:
at most 0.21% and 0.20%, G_A; a wrong gradient moves about half of them);
the second step's losses rtol 5e-3 (measured: at most 2.9e-3, G_B_xy); and
per net the median distance to JAX's after the epoch at most half the
median distance JAX's moved (measured: at most 0.023 of it, G_A).
"""

import os
import runpy
import sys
import time

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import chip_smoke
from neuroclear_tpu import data as jax_data
from neuroclear_tpu.nn import factory as jax_factory
from neuroclear_tpu.nn.core import flatten_params
from neuroclear_tpu.utils import visualizer as jax_visualizer
from neuroclear_tpu_torch import train
from neuroclear_tpu_torch.data import create_dataset
from neuroclear_tpu_torch.models.axial_to_lateral_gan_athena_model import (
    D_NAMES, LOSS_NAMES, MODEL_NAMES)
from neuroclear_tpu_torch.utils.weights import load_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-4
COMMON = ["--dataset_mode", "cube", "--model", "axial_to_lateral_gan_athena",
          "--conversion_plane", "yz", "xy", "--gan_mode", "lsgan", "--lambda_A", "5",
          "--preprocess", "addColorChannel_addBatchChannel", "--crop_size", "24", "24", "24",
          "--serial_batches", "--n_epochs", "1", "--n_epochs_decay", "0", "--print_freq", "1",
          "--save_epoch_freq", "1", "--save_latest_freq", "1", "--save_by_iter",
          "--display_freq", "1000", "--display_id", "0", "--lr_policy", "constant", "--lr",
          str(LR), "--continue_train", "--epoch", "init", "--seed", "0"]


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _volumes(root, n=2, shape=(24, 24, 24), seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        field = np.linspace(0, 1, shape[0], dtype=np.float32)[:, None, None]
        vol = 20000 + 15000 * field + rng.normal(0, 3000, shape)
        np.save(os.path.join(root, f"vol{i + 1}.npy"), vol.clip(0, 65535).astype(np.uint16))
    return str(root)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("epoch")
    data = _volumes(tmp / "data")
    nets = {"G_A": jax_factory.define_G(1, 1, 64, "unet_deconv", "instance", dimension=3),
            "G_B": jax_factory.define_G(1, 1, 64, "deep_linear_gen", "instance", dimension=3)}
    for name in D_NAMES:
        nets[name] = jax_factory.define_D(1, 64, "basic", 3, "instance", dimension=2)
    keys = jax.random.split(jax.random.PRNGKey(3), len(MODEL_NAMES))
    for pkg in ("jax", "port"):
        os.makedirs(tmp / pkg / "athena")
        for n, k in zip(MODEL_NAMES, keys):
            np.savez(tmp / pkg / "athena" / f"init_net_{n}.npz",
                     **flatten_params(nets[n].init(k, "kaiming", 0.02)))

    jax_losses = []
    real_print = jax_visualizer.Visualizer.print_current_losses

    def record(self, epoch, progress, losses, t_comp, t_data):
        jax_losses.append(dict(losses))
        return real_print(self, epoch, progress, losses, t_comp, t_data)

    argv = ["--dataroot", data, "--name", "athena", *COMMON, "--num_threads", "0"]
    saved = sys.argv
    jax_visualizer.Visualizer.print_current_losses = record
    try:
        sys.argv = ["train.py", *argv, "--checkpoints_dir", str(tmp / "jax")]
        runpy.run_path(os.path.join(REPO, "train.py"), run_name="__main__")
    finally:
        sys.argv = saved
        jax_visualizer.Visualizer.print_current_losses = real_print
    port = train.main([*argv, "--checkpoints_dir", str(tmp / "port"), "--device", "cpu"])
    first = {}  # the nets after one step; the iter_ files (~0.6 GB) go
    for pkg in ("jax", "port"):
        first[pkg] = {n: load_npz(tmp / pkg / "athena" / f"iter_1_net_{n}.npz")
                      for n in MODEL_NAMES}
        for f in os.listdir(tmp / pkg / "athena"):
            if f.startswith("iter_"):
                os.remove(tmp / pkg / "athena" / f)
    return tmp, jax_losses, port, first


def test_losses_step_by_step_match_jax_train_py(runs):
    _, jax_losses, port, _ = runs
    assert len(jax_losses) == len(port["losses"]) == 2 == port["total_iters"]
    for step, rel in zip(range(2), (1e-4, 5e-3)):
        for name in LOSS_NAMES:
            assert port["losses"][step][name] == pytest.approx(jax_losses[step][name], rel=rel), \
                (step, name)


FLIP_SHARE = 0.01  # of a net's elements; a wrong update moves about half of them


def test_first_step_moves_the_parameters_as_jax_train_py(runs):
    """Adam's first move is lr * sign(g): the two packages' parameters after
    one step agree but where a gradient element's sign differs (2 lr)."""
    *_, first = runs
    for n in MODEL_NAMES:
        want, got = first["jax"][n], first["port"][n]
        assert set(got) == set(want)
        diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
        assert (diffs > LR).mean() <= FLIP_SHARE, (n, (diffs > LR).mean())


def test_checkpoints_after_the_epoch_match_jax_train_py(runs):
    tmp, *_ = runs
    for suffix in ("1", "latest"):
        assert os.path.exists(tmp / "port" / "athena" / f"{suffix}_optim.npz")
        for n in MODEL_NAMES:
            init = load_npz(tmp / "jax" / "athena" / f"init_net_{n}.npz")
            want = load_npz(tmp / "jax" / "athena" / f"{suffix}_net_{n}.npz")
            got = load_npz(tmp / "port" / "athena" / f"{suffix}_net_{n}.npz")
            assert set(got) == set(want)
            diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
            moved = np.concatenate([np.abs(want[k] - init[k]).ravel() for k in want])
            assert (diffs > 2 * LR).mean() <= FLIP_SHARE, (n, (diffs > 2 * LR).mean())
            assert np.median(diffs) <= 0.5 * np.median(moved), (n, np.median(diffs) / LR)


MODELS = {"axial_to_lateral_gan_apollo": ["--randomize_projection_depth", "--projection_depth",
                                          "4"],
          "axial_to_lateral_gan_athena": ["--conversion_plane", "yz", "xy"],
          "axial_to_lateral_gan_dryops": ["--randomize_projection_depth", "--projection_depth",
                                          "4"]}


def _host_chain_epoch(tmp_path, model):
    data = _volumes(tmp_path / "data", n=3, shape=(30, 40, 40), seed=1)
    return train.main(["--dataroot", data, "--name", "m", "--checkpoints_dir",
                       str(tmp_path / "ck"), "--model", model, *MODELS[model], "--dataset_mode",
                       "cube", "--preprocess",
                       "random3Drotate_randomcrop_randomflip_addColorChannel_addBatchChannel",
                       "--crop_size", "24", "24", "24", "--n_epochs", "1", "--n_epochs_decay",
                       "0", "--save_epoch_freq", "1", "--num_threads", "2", "--gan_mode",
                       "lsgan", "--device", "cpu", "--seed", "2", "--print_freq", "3"])


@pytest.mark.parametrize("model", list(MODELS))
def test_each_model_trains_an_epoch_through_the_random_host_chain(tmp_path, model):
    """Three 30 x 40 x 40 volumes, rotated, cropped to 24^3 and flipped on a
    prefetching thread, shuffled: one epoch of three steps, finite losses,
    the epoch's checkpoints, the host seconds of each item."""
    res = _host_chain_epoch(tmp_path, model)
    assert res["total_iters"] == 3 and len(res["item_seconds"]) == 3
    assert len(res["step_seconds"]) == 3 and all(t > 0 for t in res["step_seconds"])
    assert all(np.isfinite(v) for step in res["losses"] for v in step.values())
    assert res["model"].visuals["real"].shape == (1, 24, 24, 24, 1)
    written = os.listdir(tmp_path / "ck" / "m")
    for n in res["model"].model_names:
        assert f"1_net_{n}.npz" in written and f"latest_net_{n}.npz" in written


def test_the_epoch_loop_is_the_profiler_range_the_smoke_reads(tmp_path):
    """``chip_smoke.py`` takes the epoch's idle share over the range
    ``epoch_loop``: one range, which holds every step and no start-up."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        res = _host_chain_epoch(tmp_path, "axial_to_lateral_gan_dryops")
        wall_ms = (time.perf_counter() - t0) * 1e3
    loop_ms, busy, ops = chip_smoke._range_device_ms(prof, "epoch_loop")
    assert 1e3 * sum(res["step_seconds"]) < loop_ms < wall_ms and busy == ops == 0


def test_grad_accum_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="grad_accum"):
        train.main(["--dataroot", str(tmp_path), "--dataset_mode", "cube", "--grad_accum", "2",
                    "--device", "cpu"])


def _opt(data, **kw):
    argv = ["--dataroot", data, "--dataset_mode", "cube", "--preprocess",
            "addColorChannel_addBatchChannel", "--device", "cpu"]
    opt = train.parse(argv)
    vars(opt).update(kw)
    return opt


@pytest.mark.parametrize("threads", [0, 2])
def test_loader_matches_jax_in_serial_order(tmp_path, threads):
    """The cube dataset's items in numerical file order (vol2 before
    vol10), as the JAX loader yields them, with and without the prefetching
    thread; max_dataset_size cuts the epoch."""
    data = str(tmp_path)
    rng = np.random.default_rng(0)
    for i in (10, 2, 1):
        np.save(os.path.join(data, f"vol{i}.npy"), rng.integers(0, 60000, (4, 5, 6), np.uint16))
    ours = create_dataset(_opt(data, serial_batches=True, num_threads=threads))
    ref = jax_data.create_dataset(_opt(data, serial_batches=True, num_threads=threads,
                                       isTrain=True))
    got, want = list(ours), list(ref)
    assert [b["A_paths"] for b in got] == [b["A_paths"] for b in want]
    assert [os.path.basename(b["A_paths"]) for b in got] == ["vol1.npy", "vol2.npy", "vol10.npy"]
    for a, b in zip(got, want):
        assert np.array_equal(a["A"], b["A"])
    short = create_dataset(_opt(data, serial_batches=True, num_threads=threads,
                                max_dataset_size=2))
    assert len(short) == 2 and len(list(short)) == 2


def test_loader_shuffles_from_the_runs_generator(tmp_path):
    data = str(tmp_path)
    for i in range(6):
        np.save(os.path.join(data, f"v{i}.npy"), np.zeros((2, 2, 2), np.uint16))

    def order(seed):
        loader = create_dataset(_opt(data, num_threads=0), np.random.default_rng(seed))
        return [os.path.basename(b["A_paths"]) for b in loader]

    assert order(4) == order(4)
    assert sorted(order(4)) == sorted(order(5)) and order(4) != sorted(order(4))
