"""The port's memory study (``neuroclear_tpu_torch/scripts/mem_study.py``)
against the JAX script's (``scripts/mem_study.py``, loaded by path and left
as it is) on the CPU: its argv parses to the JAX script's values, the train
argv it builds is the JAX script's (for Dryops less the two options that
JAX's own parser refuses there), and the argument bytes it counts
(parameters and Adam state in the JAX layout) equal the bytes of the JAX
model's parameter and optimizer pytrees, for Apollo, Athena and Dryops.  The
peak itself is read on the card (``chip_smoke.py``'s tools phase); here the
replay of the allocator's history that ``--hlo`` reads is checked on a
made-up history."""

import argparse
import contextlib
import io
import sys

import jax
import numpy as np
import pytest
import torch

from neuroclear_tpu_torch.models import create_model
from neuroclear_tpu_torch.options import train_options
from neuroclear_tpu_torch.scripts import mem_study
from test_torch_count_step_flops import _Stop, load_jax_script

CROP = 24
MODELS = ["axial_to_lateral_gan_apollo", "axial_to_lateral_gan_athena",
          "axial_to_lateral_gan_dryops"]
ARGVS = [[], ["--crop", "64", "--no-remat", "--f32"], ["--model", MODELS[1], "--hlo"],
         ["--model", MODELS[2], "--conversion_plane", "xz", "xy", "--remat"]]


def jax_values(monkeypatch, argv: list) -> tuple:
    """(the JAX script's parsed arguments, the train argv it builds), its
    ``main`` stopped at the option parse."""
    from neuroclear_tpu.options.train_options import TrainOptions

    mod = load_jax_script("mem_study")
    got = {}
    parse = argparse.ArgumentParser.parse_args

    def record_args(self, args=None, namespace=None):
        ns = parse(self, args, namespace)
        got.setdefault("args", ns)
        return ns

    def record_train(self, args=None):
        got["train"] = list(args)
        raise _Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", record_args)
    monkeypatch.setattr(TrainOptions, "parse", record_train)
    monkeypatch.setattr(sys, "argv", ["mem_study.py", *argv])
    with pytest.raises(_Stop):
        mod.main()
    return vars(got["args"]), got["train"]


def _without(argv: list, flag: str, n: int) -> list:
    i = argv.index(flag)
    return argv[:i] + argv[i + 1 + n:]


def _paths_as(argv: list, ckpt: str) -> list:
    """The JAX argv with its scratch paths as the port places them."""
    return [{"/tmp/unused": f"{ckpt}/unused", "/tmp/memstudy": ckpt}.get(a, a) for a in argv]


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "f32", "athena", "dryops"])
def test_argv_parses_as_jax(monkeypatch, argv):
    jax_args, _ = jax_values(monkeypatch, argv)
    port = vars(mem_study.parse_args(argv))
    assert port.pop("device") is None
    assert port == jax_args


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "f32", "athena", "dryops"])
def test_train_argv_is_the_jax_scripts(monkeypatch, argv):
    _, jax_train = jax_values(monkeypatch, argv)
    port = mem_study.train_argv(mem_study.parse_args(argv), "ck")
    want = _paths_as(jax_train, "ck")
    if "dryops" in " ".join(argv):
        want = _without(_without(want, "--netG_B", 1), "--conversion_plane", 2)
    assert port == want


def test_jax_parser_refuses_its_dryops_argv(monkeypatch):
    """Why the port's Dryops argv departs from the JAX script's."""
    from neuroclear_tpu.options.train_options import TrainOptions

    _, jax_train = jax_values(monkeypatch, ["--model", MODELS[2]])
    monkeypatch.undo()
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        TrainOptions().parse(args=jax_train)


@pytest.mark.parametrize("model_name", MODELS)
def test_argument_bytes_equal_jax_pytrees(tmp_path, model_name):
    """Parameters and Adam state: the port's count against the leaves of
    the JAX model's ``params`` and ``opt_state`` built from the same argv
    (at 24^3; neither depends on the crop)."""
    from neuroclear_tpu.models import create_model as jax_create_model
    from neuroclear_tpu.options.train_options import TrainOptions

    args = mem_study.parse_args(["--crop", str(CROP), "--model", model_name])
    argv = mem_study.train_argv(args, str(tmp_path))
    with contextlib.redirect_stdout(io.StringIO()):
        jopt = TrainOptions().parse(args=argv)
        jmodel = jax_create_model(jopt)
        jmodel.setup(jopt)
        port = create_model(train_options.parse(argv + ["--device", "cpu"]), "cpu")
    leaves = jax.tree_util.tree_leaves((jmodel.params, jmodel.opt_state))
    want = sum(np.asarray(leaf).nbytes for leaf in leaves)
    assert mem_study.argument_bytes(port) == want


def test_cpu_run_prints_the_arguments_only(capsys):
    res = mem_study.main(["--crop", str(CROP), "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "cpu"
    gib = res["arguments"] / 2 ** 30
    assert out[2] == f"{'arguments (params+adam+input)':30s} {gib:9.3f} GiB"
    assert out[3] == "the peak is read on the card: run without --device cpu"
    assert set(res) == {"card", "arguments"}
    crop_bytes = 4 * CROP ** 3
    assert res["arguments"] > crop_bytes


def test_largest_blocks_replay():
    """The live set at the peak of a made-up history, the port's innermost
    frame named."""
    frame = [{"filename": "/x/site-packages/torch/nn/functional.py", "line": 1, "name": "f"},
             {"filename": "/r/neuroclear_tpu_torch/nn/core.py", "line": 42, "name": "forward"}]
    trace = [{"action": "alloc", "addr": 1, "size": 100, "frames": frame},
             {"action": "alloc", "addr": 2, "size": 300, "frames": []},
             {"action": "free_requested", "addr": 1, "size": 100},
             {"action": "alloc", "addr": 3, "size": 50, "frames": frame},
             {"action": "free_requested", "addr": 2, "size": 300},
             {"action": "alloc", "addr": 4, "size": 10, "frames": frame}]
    # totals 100, 400, 300, 350, 50, 60: the peak is at 400 (blocks 1 and 2)
    assert mem_study.largest_blocks(trace, n=5) == [(300, "no frame recorded"),
                                                    (100, "nn/core.py:42 forward")]


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs a machine without one")
    with pytest.raises(SystemExit, match="mem_study: no CUDA device"):
        mem_study.main(["--crop", str(CROP)])
