"""Which ``--netG``, ``--netG_B``, ``--netD`` and ``--norm`` values the port
takes: exactly those with which the JAX package runs, shown value by value.

For each of the three GAN models and each value of each flag, the JAX
model's nets are built by its factory, their parameters initialised and
one step of its ``make_*_step`` taken, all abstractly (``jax.eval_shape``:
traced, shapes and types checked, nothing computed, so the full-width nets
cost no memory and no compile); the port's trainer options must take the
value exactly when that succeeds, and refuse it with a NotImplementedError
naming ROADMAP.md otherwise.  The same for ``test_dice``: the JAX
generator built, initialised and applied to a batch of tiles, giving one
volume of the tiles' shape.  The partners of the value under test are the
cheapest values that run (a linear-kernel generator, the pixel
discriminator, no norm: tracing the instance norm's custom gradient doubles
a trace's time); ``--norm`` runs with the production U-Net as G_A, whose
norms it changes, and the pixel discriminator, which has one.  A verdict is
traced once per model and flag set (the partners' own values recur).  Then
``unet_vanilla`` at the production 108^3 crop: the JAX net fails (108 -> 54
-> 27 -> 13 cannot be concatenated back with 27), and the port refuses it
with a clear message."""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from neuroclear_tpu.models import gan_common as jgc
from neuroclear_tpu.models.axial_to_lateral_gan_apollo_model import make_apollo_step
from neuroclear_tpu.models.axial_to_lateral_gan_athena_model import make_athena_step
from neuroclear_tpu.models.axial_to_lateral_gan_dryops_model import make_dryops_step
from neuroclear_tpu.nn import factory as jax_factory
from neuroclear_tpu_torch.models.axial_to_lateral_gan_apollo_model import GAN_NET_D, GAN_NET_G
from neuroclear_tpu_torch.nn import factory
from neuroclear_tpu_torch.nn.norms import NORMS
from neuroclear_tpu_torch.options import test_options, train_options

CROP = 24
D_NAMES = {"apollo": ["D_A_lateral", "D_A_axial", "D_B_lateral", "D_B_axial"],
           "athena": ["D_A_xy", "D_A_xz", "D_A_yz", "D_B_xy", "D_B_xz", "D_B_yz"],
           "dryops": ["D_A_lateral", "D_A_axial"]}
CHEAP = {"netG": "linearkernel", "netG_B": "linearkernel", "netD": "pixel"}
PRODUCTION = {"netG": "unet_deconv", "netG_B": "deep_linear_gen", "netD": "basic",
              "norm": "instance"}
CASES = ([(m, "netG", v) for m in D_NAMES for v in factory.NET_G]
         + [(m, "netG_B", v) for m in ("apollo", "athena") for v in factory.NET_G]
         + [(m, "netD", v) for m in D_NAMES for v in factory.NET_D]
         + [(m, "norm", v) for m in D_NAMES for v in NORMS])


def _flags(flag, value):
    flags = {**PRODUCTION, **CHEAP, "norm": "none"}
    if flag == "norm":
        flags["netG"] = PRODUCTION["netG"]
    flags[flag] = value
    return flags


@functools.lru_cache(maxsize=None)
def _jax_verdict(model, flag_items) -> bool:
    return _jax_steps(model, dict(flag_items))


def _jax_steps(model, flags) -> bool:
    """Does the JAX model build and take one (abstract) step with ``flags``?"""
    try:
        nets = {"G_A": jax_factory.define_G(1, 1, 64, flags["netG"], flags["norm"],
                                            dimension=3)}
        if model != "dryops":
            nets["G_B"] = jax_factory.define_G(1, 1, 64, flags["netG_B"], flags["norm"],
                                               dimension=3)
        for d in D_NAMES[model]:
            nets[d] = jax_factory.define_D(1, 64, flags["netD"], 3, flags["norm"], dimension=2)
        key = jax.random.PRNGKey(0)
        params = {n: jax.eval_shape(functools.partial(m.init, init_type="kaiming"), key)
                  for n, m in nets.items()}
        cfg = jgc.GanStepConfig(gan_mode="lsgan", randomize_projection_depth=True,
                                projection_depth=4)
        optim = jgc.make_adam(0.1)
        gp = {n: p for n, p in params.items() if n.startswith("G")}
        dp = {n: p for n, p in params.items() if n.startswith("D")}
        state = {"G": jax.eval_shape(optim.init, gp), "D": jax.eval_shape(optim.init, dp)}
        real = jax.ShapeDtypeStruct((1, CROP, CROP, CROP, 1), jnp.float32)
        lr = jnp.float32(1e-4)
        if model == "apollo":
            out = jax.eval_shape(make_apollo_step(nets, optim, cfg), gp, dp, state, key, real,
                                 lr)
        elif model == "athena":
            out = jax.eval_shape(make_athena_step(nets, optim, cfg, (0, 2, 1)), gp, dp, state,
                                 real, lr)
        else:
            out = jax.eval_shape(make_dryops_step(nets, optim, cfg), gp, dp, state, key, real,
                                 lr)
    except (AttributeError, TypeError, ValueError):
        return False
    return bool(jax.tree.leaves(out))


def _port_takes(argv, parse) -> bool:
    try:
        parse(argv)
    except NotImplementedError as e:
        assert "ROADMAP.md" in str(e), e
        return False
    return True


@pytest.mark.parametrize("model, flag, value", CASES)
def test_trainers_take_exactly_what_the_jax_models_run(model, flag, value):
    flags = _flags(flag, value)
    if model == "dryops":
        flags.pop("netG_B")
    argv = ["--dataroot", "x", "--model", f"axial_to_lateral_gan_{model}", "--seed", "0",
            "--device", "cpu", *[a for k, v in flags.items() for a in (f"--{k}", v)]]
    runs = _jax_verdict(model, tuple(sorted(flags.items())))
    assert _port_takes(argv, train_options.parse) == runs
    expected = {"netG": GAN_NET_G, "netG_B": GAN_NET_G, "netD": GAN_NET_D, "norm": NORMS}[flag]
    assert runs == (value in expected)


@pytest.mark.parametrize("flag, value", [("netG", v) for v in factory.NET_G]
                         + [("norm", v) for v in NORMS])
def test_test_dice_takes_exactly_what_the_jax_cli_runs(flag, value):
    flags = {"netG": "unet_deconv", "norm": "instance", flag: value}
    try:
        net = jax_factory.define_G(1, 1, 64, flags["netG"], flags["norm"], dimension=3)
        params = jax.eval_shape(net.init, jax.random.PRNGKey(0))
        tiles = jax.ShapeDtypeStruct((2, 16, 16, 16, 1), jnp.bfloat16)
        out = jax.eval_shape(net.apply, params, tiles)
        runs = getattr(out, "shape", None) == tiles.shape
    except (AttributeError, TypeError, ValueError):
        runs = False
    argv = ["--dataroot", "x", "--dice_size", "16", "--device", "cpu", "--netG", flags["netG"],
            "--norm", flags["norm"]]
    assert _port_takes(argv, test_options.parse) == runs


def test_unet_vanilla_fails_at_108_in_both_packages():
    net = jax_factory.define_G(1, 1, 64, "unet_vanilla", "instance", dimension=3)
    params = jax.eval_shape(net.init, jax.random.PRNGKey(0))
    with pytest.raises(TypeError):
        jax.eval_shape(net.apply, params, jax.ShapeDtypeStruct((1, 108, 108, 108, 1),
                                                                jnp.float32))
    out = jax.eval_shape(net.apply, params, jax.ShapeDtypeStruct((1, 112, 112, 112, 1),
                                                                  jnp.float32))
    assert out.shape == (1, 112, 112, 112, 1)
    port = factory.define_G(1, 1, 64, "unet_vanilla")
    with pytest.raises(ValueError, match="multiples of 8"):
        port(torch.zeros(1, 108, 108, 108, 1))
