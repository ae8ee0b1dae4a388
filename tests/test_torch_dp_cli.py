"""Data parallelism within the port, on the CPU with gloo ranks under
``torchrun`` (``tests/test_torch_dp_worker.py``; every launch has its own
timeout, so a hung collective fails its test):

  * two ranks against the single-process ``--grad_accum 2`` step for
    Apollo, Athena and Dryops (narrow nets at 16^3: linear-kernel
    generators, the pixel discriminator), from the same weights, crops and
    draws, for two Adam steps: the first step's averaged losses and
    gradients and every parameter, buffer and Adam moment after each step
    equal, bit for bit (the sum of two addends does not depend on their
    order, and the division by 2 is the accumulator's), and the two ranks
    equal to each other;
  * ``torchrun -m neuroclear_tpu_torch.train_onecube`` (the production nets
    at 24^3, two steps, ``--device cpu``) without ``--seed``: one seed
    printed once and used by both ranks, only rank 0 writing checkpoints,
    ``train_opt.txt`` and the web page, and the checkpoint against the
    single-process ``--grad_accum 2`` run with that seed;
  * ``torchrun -m neuroclear_tpu_torch.train --batch_size 2`` (the cube
    dataset, two volumes, one epoch) against the single-process batch-2
    run: the losses rtol 1e-4, the parameters within ``FLIP_SHARE`` of lr
    (tests/test_torch_epoch.py's tolerance: Adam's first move is lr *
    sign(g), so an element whose gradient is f32 noise moves 2 lr the other
    way where the two runs' sum orders differ);
  * the refusals: ``--grad_accum 2`` and, for ``train``, ``--batch_size 3``
    over two ranks; ``--gpu_ids 0,1`` outside torchrun.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from neuroclear_tpu_torch import train
from neuroclear_tpu_torch.models import create_model
from neuroclear_tpu_torch.options import train_options
from neuroclear_tpu_torch.utils import tiffio
from neuroclear_tpu_torch.utils.weights import flat_from_module, load_npz
from test_torch_dp_worker import flats_arrays, run_ranks, save_case, state_arrays

CROP, DEPTH = 16, 4
LR = 1e-4
FLIP_SHARE = 0.01  # tests/test_torch_epoch.py
NARROW = ["--netG", "linearkernel", "--netD", "pixel", "--gan_mode", "lsgan",
          "--projection_depth", str(DEPTH), "--randomize_projection_depth", "--device", "cpu",
          "--lr", str(LR)]
MODELS = {"apollo": ["--model", "axial_to_lateral_gan_apollo", "--netG_B", "linearkernel"],
          "athena": ["--model", "axial_to_lateral_gan_athena", "--netG_B", "linearkernel"],
          "dryops": ["--model", "axial_to_lateral_gan_dryops"]}
ARGV = {k: ["--dataroot", "unused", *NARROW, *v] for k, v in MODELS.items()}
ARGV["athena"] = [a for a in ARGV["athena"] if a not in ("--projection_depth", str(DEPTH),
                                                        "--randomize_projection_depth")]
# the production command at 24^3 with the narrow nets
ONECUBE = ["--dataset_mode", "singlevolume", "--preprocess",
           "random3Drotate_randomcrop_randomflip_addColorChannel_addBatchChannel",
           "--model", "axial_to_lateral_gan_apollo", "--netG", "linearkernel", "--netG_B",
           "linearkernel", "--netD", "pixel", "--gan_mode", "lsgan", "--init_type",
           "kaiming", "--norm", "instance", "--lambda_A", "5", "--crop_size", "24", "24",
           "24", "--lambda_plane", "1", "1", "1", "--save_by_iter", "--save_latest_freq",
           "2", "--lr_policy", "constant", "--randomize_projection_depth",
           "--projection_depth", "10", "--print_freq", "1", "--display_freq", "1000",
           "--update_html_freq", "1", "--max_iters", "2", "--device", "cpu", "--name", "dp"]


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _model(argv):
    opt = train_options.build_parser(argv).parse_args(argv)
    model = create_model(opt, "cpu")
    model.setup(opt)
    return model


def test_two_ranks_equal_grad_accum_2_for_each_model(tmp_path):
    rng = np.random.default_rng(3)
    cases, arrays, refs = [], {}, {}
    for i, (name, argv) in enumerate(ARGV.items()):
        model = _model(argv)
        model.init_weights(i, "kaiming")
        flats = {n: flat_from_module(model.nets[n]) for n in model.model_names}
        arrays.update({f"{name}.flat/{k}": v for k, v in flats_arrays(flats).items()})
        crops = rng.random((2, 2, CROP, CROP, CROP, 1)).astype(np.float32)
        arrays[f"{name}.crops"] = crops
        gen = torch.Generator().manual_seed(i)
        draws = [model.draw_probes((CROP,) * 3, gen) for _ in range(2)]
        cases.append({"prefix": f"{name}.", "argv": argv,
                      "draws": [None if d is None else [d.depth, list(d.g), list(d.d)]
                                for d in draws]})
        # the single-process reference: --grad_accum 2 from the same state
        grads = []
        accumulate = model.accumulate

        def record(crop, n, dr, accumulate=accumulate, grads=grads):
            res = accumulate(crop, n, dr)
            grads.append(res)
            return res

        model.accumulate = record
        states = []
        for s, d in enumerate(draws):
            model.optimize_parameters_accum(
                lambda j, s=s, crops=crops: torch.from_numpy(crops[s, j:j + 1]), 2, d)
            states.append(state_arrays(model))
        refs[name] = (model, grads[0], states)
    save_case(tmp_path, {"cases": cases}, arrays)
    run_ranks("steps", tmp_path)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for name, (model, (losses, _, *_, g_acc, d_acc), states) in refs.items():
        p = f"{name}."
        for k, v in losses.items():
            assert np.array_equal(ranks[0][f"{p}loss.{k}"], v.numpy()), (name, k)
        names = [(n, pn) for n in model.G_NAMES for pn, _ in model.nets[n].named_parameters()]
        names += [(n, pn) for n in model.D_NAMES for pn, _ in model.nets[n].named_parameters()]
        for (n, pn), g in zip(names, list(g_acc) + list(d_acc)):
            assert np.array_equal(ranks[0][f"{p}grad.{n}.{pn}"], g.numpy()), (name, n, pn)
        for s, state in enumerate(states):
            for k, v in state.items():
                for r in range(2):
                    assert np.array_equal(ranks[r][f"{p}step{s}.{k}"], v), (name, s, r, k)


def _volume_dir(tmp, n=1, size=40):
    rng = np.random.default_rng(4)
    d = tmp / "data"
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        vol = (20000 + rng.normal(0, 3000, (size,) * 3)).clip(0, 65535).astype(np.uint16)
        tiffio.imwrite(str(d / f"v{i}.tif"), vol)
    return str(d)


def _nets(ck: str, suffix: str) -> dict:
    return {f: load_npz(os.path.join(ck, f)) for f in sorted(os.listdir(ck))
            if f.startswith(suffix + "_net_")}


def _assert_within_lr(got: dict, ref: dict) -> None:
    """Per net file, at most FLIP_SHARE of its elements more than lr
    apart."""
    for f in ref:
        diffs = np.concatenate([np.abs(got[f][k] - ref[f][k]).ravel() for k in ref[f]])
        assert (diffs > LR).mean() <= FLIP_SHARE, (f, (diffs > LR).mean())


def test_torchrun_train_onecube_matches_grad_accum_2(tmp_path):
    data = _volume_dir(tmp_path)
    argv = ["--dataroot", data, "--checkpoints_dir", str(tmp_path / "ck"), *ONECUBE]
    proc = run_ranks(None, tmp_path, module="neuroclear_tpu_torch.train_onecube", args=argv)
    seeds = re.findall(r"--seed not given: drew seed (\d+)", proc.stdout)
    assert len(seeds) == 1, proc.stdout[-3000:]
    assert "data parallel over 2 ranks (gloo)" in proc.stdout
    assert proc.stdout.count("reached --max_iters") == 1  # rank 0 alone prints
    ck = tmp_path / "ck" / "dp"
    # rank 0 alone writes: each file once, the page and the options dump
    assert sorted(os.listdir(ck)) == sorted(
        ["iter_2_optim.npz", "loss_log.txt", "train_opt.txt", "web"]
        + [f"iter_2_net_{n}.npz" for n in ("G_A", "G_B", "D_A_lateral", "D_A_axial",
                                          "D_B_lateral", "D_B_axial")])
    assert os.path.exists(ck / "web" / "index.html")
    assert f"seed: {seeds[0]}" in " ".join((ck / "train_opt.txt").read_text().split())
    run_ranks(None, tmp_path, world=None, module="neuroclear_tpu_torch.train_onecube",
              args=[*argv, "--name", "accum", "--grad_accum", "2", "--seed", seeds[0]])
    got, ref = _nets(str(ck), "iter_2"), _nets(str(tmp_path / "ck" / "accum"), "iter_2")
    assert set(got) == set(ref) and len(ref) == 6
    _assert_within_lr(got, ref)


EPOCH = ["--dataset_mode", "cube", "--model", "axial_to_lateral_gan_apollo", "--netG",
         "linearkernel", "--netG_B", "linearkernel", "--netD", "pixel", "--gan_mode",
         "lsgan", "--lambda_A", "5", "--preprocess",
         "randomcrop_randomflip_addColorChannel_addBatchChannel", "--crop_size", "24", "24",
         "24", "--n_epochs", "1", "--n_epochs_decay", "0", "--print_freq", "1",
         "--save_epoch_freq", "1", "--display_freq", "1000", "--display_id", "0",
         "--lr_policy", "constant", "--lr", str(LR), "--init_type", "kaiming", "--seed", "5",
         "--device", "cpu", "--num_threads", "0", "--batch_size", "2", "--name", "dp"]


def test_torchrun_train_batch_2_matches_the_single_process_batch(tmp_path, monkeypatch):
    data = _volume_dir(tmp_path, n=2, size=32)
    argv = ["--dataroot", data, "--checkpoints_dir", str(tmp_path / "ck"), *EPOCH]
    proc = run_ranks(None, tmp_path, module="neuroclear_tpu_torch.train", args=argv)
    assert "1 of each batch's 2 items per rank" in proc.stdout
    printed = [dict((k, float(v)) for k, v in re.findall(r"(\w+): (-?\d+\.\d+) ", line))
               for line in proc.stdout.splitlines() if line.startswith("(epoch:")]
    # no TensorBoard here either (its import takes ~20 s; the visualizer
    # reports it off and goes on)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    res = train.main([*argv, "--name", "single"])
    assert len(res["losses"]) == len(printed) == 1
    for k, v in res["losses"][0].items():  # printed to three decimals
        assert abs(printed[0][k] - v) <= 5e-4 + 1e-4 * abs(v), (k, printed[0][k], v)
    ck = tmp_path / "ck"
    assert sorted(f for f in os.listdir(ck / "dp") if f.endswith(".npz")) == sorted(
        f for f in os.listdir(ck / "single") if f.endswith(".npz"))
    got, want = _nets(str(ck / "dp"), "latest"), _nets(str(ck / "single"), "latest")
    assert len(want) == 6
    _assert_within_lr(got, want)


@pytest.mark.parametrize("module, extra, message", [
    ("neuroclear_tpu_torch.train_onecube", ["--grad_accum", "2"],
     "--grad_accum 2 needs a single process"),
    ("neuroclear_tpu_torch.train", ["--batch_size", "3", "--dataset_mode", "cube"],
     "--batch_size 3 does not split over 2 ranks")])
def test_torchrun_refusals(tmp_path, module, extra, message):
    argv = ["--dataroot", str(tmp_path), "--checkpoints_dir", str(tmp_path / "ck"), "--device",
            "cpu", "--seed", "0", *extra]
    proc = run_ranks(None, tmp_path, module=module, args=argv, check=False, timeout=60)
    assert proc.returncode != 0 and message in proc.stdout + proc.stderr
    assert not (tmp_path / "ck").exists()


def test_several_gpu_ids_outside_torchrun_name_torchrun():
    with pytest.raises(NotImplementedError, match="torch.distributed.run"):
        train_options.parse(["--dataroot", "x", "--seed", "1", "--gpu_ids", "0,1"])
