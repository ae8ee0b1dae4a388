"""The four init schemes of the JAX package's ``init_weight``
(``nn/core.py:35-78``) in the port (``utils/weights.py::init_flat``), on
the six production nets at full width, on the CPU: each weight's mean and
std within 5 standard errors of the scheme's formula (a sample std of n
normal draws has a standard error of std / sqrt(2 n)); the orthogonal
weights orthonormal on the (O, rest) flattening, times the gain, at 1e-5;
torch's fan rule for convs and transposed convs as JAX's ``_fans``; on
large kernels the port's statistics against JAX's own draws; and a
checkpoint the JAX package initialised with ``--init_type normal`` runs in
the port."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from neuroclear_tpu.nn import core as jax_core
from neuroclear_tpu.nn import factory as jax_factory
from neuroclear_tpu.nn.core import flatten_params
from neuroclear_tpu_torch.models.axial_to_lateral_gan_apollo_model import (
    D_NAMES, MODEL_NAMES, ApolloModel)
from neuroclear_tpu_torch.nn.core import ConvTranspose
from neuroclear_tpu_torch.nn.generators import UNetDeconv
from neuroclear_tpu_torch.options import train_options
from neuroclear_tpu_torch.utils.weights import (INIT_TYPES, fans, flat_from_module, init_weight,
                                                params_from_numpy)

GAIN = 0.02


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """One CPU thread for torch and BLAS: with a thread per core in each of
    the suite's six workers these steps run tens of times slower than alone
    (a 24^3 bf16 study step: 250 s against 5 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _expected_std(kshape, init_type, gain, transpose):
    fan_in, fan_out = jax_core._fans(kshape, transpose)
    if init_type == "normal":
        return gain
    if init_type == "xavier":
        return gain * math.sqrt(2.0 / (fan_in + fan_out))
    if init_type == "kaiming":
        return math.sqrt(2.0 / fan_in)
    rows = kshape[-1]
    return gain / math.sqrt(max(rows, math.prod(kshape) // rows))


def _kernels(model):
    """(net.path, JAX-layout kernel, transposed?) of every weight."""
    out = []
    for name in MODEL_NAMES:
        net = model.nets[name]
        flat = flat_from_module(net)
        for key, w in flat.items():
            if key.endswith(".w"):
                layer = net.get_submodule(key[:-2])
                out.append((f"{name}.{key}", w, isinstance(layer, ConvTranspose)))
            else:
                assert not w.any(), key  # biases start at zero
    return out


@functools.lru_cache(maxsize=None)
def _initialised(init_type):
    """The six nets as the trainer initialises them with ``--init_type``."""
    opt = train_options.build_parser().parse_args(
        ["--dataroot", "unused", "--init_type", init_type, "--init_gain", str(GAIN)])
    model = ApolloModel(opt, "cpu")
    model.init_weights(4, opt.init_type, opt.init_gain)
    return init_type, _kernels(model)


@pytest.fixture(scope="module", params=INIT_TYPES)
def initialised(request):
    return _initialised(request.param)


def test_each_weight_has_the_schemes_statistics(initialised):
    init_type, kernels = initialised
    for key, w, transpose in kernels:
        want = _expected_std(w.shape, init_type, GAIN, transpose)
        n = w.size
        if init_type == "orthogonal":
            # orthonormal rows (or columns): the mean square is exact
            rms = float(np.sqrt(np.mean(w.astype(np.float64) ** 2)))
            assert rms == pytest.approx(want, rel=1e-5), key
            continue
        if n < 8:
            continue  # the 1x1x1 1 -> 1 conv: too few draws for a statistic
        assert abs(float(w.mean())) <= 5 * want / math.sqrt(n), key
        assert abs(float(w.std()) - want) <= 5 * want / math.sqrt(2 * n), key


def test_orthogonal_weights_are_orthonormal_times_the_gain():
    _, kernels = _initialised("orthogonal")
    for key, w, _ in kernels:
        rows = w.shape[-1]
        # the (O, rest) flattening, rest in JAX's (k..., I) order
        m = np.moveaxis(w, -1, 0).reshape(rows, -1).astype(np.float64)
        gram = m @ m.T if rows <= m.shape[1] else m.T @ m
        np.testing.assert_allclose(gram, GAIN ** 2 * np.eye(len(gram)), rtol=0,
                                   atol=1e-5 * GAIN ** 2, err_msg=key)


@pytest.mark.parametrize("kshape", [(3, 3, 3, 1, 64), (3, 3, 3, 128, 64), (2, 2, 2, 256, 128),
                                    (4, 4, 64, 128), (1, 1, 1, 16, 1), (7, 7, 7, 1, 64)])
@pytest.mark.parametrize("transpose", [False, True])
def test_fan_rule_is_jaxs(kshape, transpose):
    assert fans(kshape, transpose) == jax_core._fans(kshape, transpose)


def test_transposed_conv_draws_by_its_out_channels():
    """The U-Net's t_conv2 (256 -> 128, k 2): torch's rule keys off dim 1
    of the (I, O, k...) weight, so its kaiming std is sqrt(2 / (128 * 8)),
    not sqrt(2 / (256 * 8))."""
    model = ApolloModel(train_options.build_parser().parse_args(["--dataroot", "unused"]), "cpu")
    model.init_weights(0, "kaiming")
    w = model.nets["G_A"].t_conv2.weight.detach().numpy()
    assert w.shape == (256, 128, 2, 2, 2)
    assert abs(float(w.std()) - math.sqrt(2.0 / (128 * 8))) <= 5 * math.sqrt(
        2.0 / (128 * 8)) / math.sqrt(2 * w.size)


@pytest.mark.parametrize("init_type", INIT_TYPES)
@pytest.mark.parametrize("kshape, transpose", [((3, 3, 3, 128, 256), False),
                                               ((2, 2, 2, 256, 128), True),
                                               ((4, 4, 256, 512), False)])
def test_large_kernels_match_jaxs_draws(init_type, kshape, transpose):
    """The port's kernel and JAX's ``init_weight`` of the same shape: the
    same std within 5 standard errors of their difference (the same RMS
    for orthogonal, whose rows are unit vectors in both)."""
    port = init_weight(np.random.default_rng(1), kshape, init_type, GAIN, transpose)
    ref = np.asarray(jax_core.init_weight(jax.random.PRNGKey(1), kshape, init_type, GAIN,
                                          transpose))
    assert port.shape == ref.shape == kshape and port.dtype == np.float32
    want = _expected_std(kshape, init_type, GAIN, transpose)
    if init_type == "orthogonal":
        assert float(np.sqrt(np.mean(port.astype(np.float64) ** 2))) == pytest.approx(
            float(np.sqrt(np.mean(ref.astype(np.float64) ** 2))), rel=1e-5)
        return
    assert abs(float(port.std()) - float(ref.std())) <= 5 * want / math.sqrt(port.size)


def test_jax_normal_init_checkpoint_runs_in_the_port():
    """The six nets initialised by the JAX package with ``normal`` (its CLI
    default) load in the port, and G_A gives JAX's output (rtol 1e-4, the
    U-Net's bar)."""
    keys = jax.random.split(jax.random.PRNGKey(2), len(MODEL_NAMES))
    nets = {"G_A": jax_factory.define_G(1, 1, 64, "unet_deconv", "instance", dimension=3),
            "G_B": jax_factory.define_G(1, 1, 64, "deep_linear_gen", "instance", dimension=3)}
    for name in D_NAMES:
        nets[name] = jax_factory.define_D(1, 64, "basic", 3, "instance", dimension=2)
    params = {n: nets[n].init(k, "normal", GAIN) for n, k in zip(MODEL_NAMES, keys)}
    model = ApolloModel(train_options.build_parser().parse_args(["--dataroot", "unused"]), "cpu")
    model.load_flats({n: flatten_params(params[n]) for n in MODEL_NAMES})
    x = np.random.default_rng(3).random((1, 16, 16, 16, 1)).astype(np.float32)
    ref = np.asarray(nets["G_A"].apply(params["G_A"], jnp.asarray(x)))
    net = UNetDeconv(1, 1)
    net.load_state_dict(params_from_numpy(flatten_params(params["G_A"]), net))
    with torch.no_grad():
        got = model.nets["G_A"](torch.from_numpy(x)).numpy()
        again = net(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, again)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
