"""The JAX CLI's flags that the port's two parsers (the trainers' and
``test_dice``'s) used to reject: ``--suffix`` with JAX's name template, the
flags JAX declares and never reads (taken with JAX's defaults, changing
nothing), ``--direction AtoB``; and the two refused with a pointer to
ROADMAP.md: ``--direction BtoA`` where the step would read a B volume that
the port's datasets do not hold (the trainers; JAX's ``test_dice`` reads no
direction), and ``--debug`` (JAX's ``jax.profiler`` server)."""

import argparse

import pytest

from neuroclear_tpu.options.test_options import TestOptions
from neuroclear_tpu.options.train_options import TrainOptions
from neuroclear_tpu_torch.options import test_options, train_options

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
        assert opt.name == ("run_unet_deconv_[108, 108, 108]" if parser == "train"
                            else "run_unet_deconv_[16, 16, 16]")
        return
    # the flag changes nothing else the port reads
    assert {k: v for k, v in vars(opt).items() if k != dest} == \
        {k: v for k, v in vars(plain).items() if k != dest}
