"""The rest of the network zoo in the port (neuroclear_tpu_torch/nn) against
the JAX package on the CPU: every ``define_G`` (12) and ``define_D`` (6)
name and every ``--norm`` value (4) builds with the JAX net's parameter
tree (the same flat keys, shapes and leaf count), and its forward on
JAX-initialised weights carried across by ``utils/weights.py`` matches the
JAX net's on the same seeded input, f32, at the sizes of JAX's own
``tests/test_networks.py`` (16^3, 12^3, 32^2, 48^2); batch norm in both
modes and its refresh; the layers the zoo adds (the antialiased linear
resize, the spectral norm, the reflect pad, the k3 stride-2 transpose);
``FixedLinearKernel`` with and without noise; ``ImagePool``.

Bar: rtol 1e-5 with an absolute floor of 1e-5 * max|ref| (the same f32 ops
summed in another order), 1e-4 for the deep 2D stacks (ResNet's 9 blocks,
VGG16's 13 convs and 3 linear layers, whose sums are long).  One CPU thread;
each JAX net is jitted once per configuration."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from neuroclear_tpu.nn import factory as jax_factory
from neuroclear_tpu.nn import norms as jax_norms
from neuroclear_tpu.nn.core import ConvTranspose as JaxConvTranspose
from neuroclear_tpu.nn.core import flatten_params, unflatten_params
from neuroclear_tpu.nn.discriminators import _spectral_normalise
from neuroclear_tpu.utils.image_pool import ImagePool as JaxImagePool
from neuroclear_tpu_torch.nn import factory, norms
from neuroclear_tpu_torch.nn.core import Conv, ConvTranspose, reflect_pad, resize_linear
from neuroclear_tpu_torch.utils.image_pool import ImagePool
from neuroclear_tpu_torch.utils.weights import flat_from_module, init_flat, params_from_numpy

RTOL = 1e-5
DEEP_RTOL = 1e-4

# (netG, norm, input shape) at JAX's test sizes; every name once, the U-Nets
# under the other norms too
G_CASES = [("unet_twoouts", "instance", (1, 16, 16, 16, 1)),
           ("unet_deconv", "batch", (1, 12, 12, 12, 1)),
           ("unet_deconv", "none", (1, 12, 12, 12, 1)),
           ("unet_deconv", "spectral", (1, 12, 12, 12, 1)),
           ("unet_vanilla", "instance", (1, 16, 16, 16, 1)),
           ("unet_vanilla", "batch", (2, 16, 16, 16, 1)),
           ("resnet_9blocks", "instance", (1, 32, 32, 1)),
           ("resnet_6blocks", "batch", (2, 32, 32, 1)),
           ("VGG", "instance", (2, 32, 32, 1)),
           ("linearkernel", "instance", (1, 12, 12, 12, 1)),
           ("linearkernel_double", "instance", (1, 12, 12, 12, 1)),
           ("linearkernel_LK31", "instance", (1, 12, 12, 12, 1)),
           ("linearkernel_NC", "instance", (1, 12, 12, 12, 1)),
           ("deep_linear_gen", "batch", (1, 12, 12, 12, 1))]
D_CASES = [(d, norm) for d in factory.NET_D for norm in ("instance", "batch")] + [
    ("basic", "none"), ("pixel", "spectral")]


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _close(a, ref, rtol=RTOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(a), ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def _randomised(params, seed):
    """The JAX init with random biases, offsets and running statistics, so
    every leaf takes part."""
    rng = np.random.default_rng(seed)
    flat = {k: np.asarray(v) for k, v in flatten_params(params).items()}
    for k, v in flat.items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf in ("b", "offset", "running_mean"):
            flat[k] = (rng.normal(size=v.shape) * 0.1).astype(np.float32)
        elif leaf == "running_var":
            flat[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    return flat


def _same_tree(jax_params, net):
    """The port's leaves are the JAX tree's: keys, shapes, leaf count."""
    ref = {k: np.shape(v) for k, v in flatten_params(jax_params).items()}
    got = {k: v.shape for k, v in flat_from_module(net).items()}
    assert got == ref
    assert sum(int(np.prod(s)) for s in got.values()) == sum(
        int(np.prod(s)) for s in ref.values())


def _carry(jax_net, net, seed, init=None):
    params = init() if init else jax_net.init(jax.random.PRNGKey(seed), "kaiming", 0.02)
    _same_tree(params, net)
    flat = _randomised(params, seed)
    net.load_state_dict(params_from_numpy(flat, net))
    return unflatten_params(flat), flat


@pytest.mark.parametrize("name, norm, shape", G_CASES)
def test_generator_matches_jax(name, norm, shape):
    jax_net = jax_factory.define_G(1, 1, 64, name, norm, dimension=3)
    net = factory.define_G(1, 1, 64, name, norm)
    init = None
    if name == "VGG":  # 134 M parameters: drawn once, by the port's numpy init
        init = lambda: unflatten_params(init_flat(net, "kaiming", 0.02, 3))  # noqa: E731
    params, _ = _carry(jax_net, net, 3, init)
    x = np.random.default_rng(4).random(shape).astype(np.float32)
    ref = jax.jit(jax_net.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        y = net(torch.from_numpy(x))
    deep = name.startswith(("resnet", "VGG"))
    if name == "unet_twoouts":
        assert len(y) == 2
        for a, r in zip(y, ref):
            _close(a, r)
    else:
        assert y.shape == ref.shape
        _close(y, ref, DEEP_RTOL if deep else RTOL)


@pytest.mark.parametrize("name, norm", D_CASES)
def test_discriminator_matches_jax(name, norm):
    jax_net = jax_factory.define_D(1, 64, name, 3, norm, dimension=2)
    net = factory.define_D(1, 64, name, 3, norm)
    params, _ = _carry(jax_net, net, 5)
    x = np.random.default_rng(6).random((2, 48, 48, 1)).astype(np.float32)
    ref = jax.jit(jax_net.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        y = net(torch.from_numpy(x))
    assert y.shape == ref.shape
    _close(y, ref)


def test_n_layers_discriminators_take_n_layers_d():
    for name in ("n_layers", "n_layers_SN"):
        jax_net = jax_factory.define_D(1, 64, name, 2, "batch", dimension=2)
        net = factory.define_D(1, 64, name, 2, "batch")
        _same_tree(jax_net.init(jax.random.PRNGKey(0)), net)


def test_unknown_names_raise_as_in_jax():
    with pytest.raises(NotImplementedError, match="not recognized"):
        factory.define_G(1, 1, 64, "unet_shallow")
    with pytest.raises(NotImplementedError, match="not recognized"):
        factory.define_D(1, 64, "multiscale")
    with pytest.raises(NotImplementedError, match="not found"):
        norms.get_norm_spec("group")


def test_batch_norm_eval_uses_the_running_statistics_only_when_switched():
    """A batch-norm U-Net: batch statistics by default (whatever
    ``nn.Module.training`` says), the running ones after ``set_eval``, each
    against the JAX net outside and inside ``eval_mode``."""
    jax_net = jax_factory.define_G(1, 1, 64, "unet_deconv", "batch", dimension=3)
    net = factory.define_G(1, 1, 64, "unet_deconv", "batch")
    params, _ = _carry(jax_net, net, 7)
    x = np.random.default_rng(8).random((2, 12, 12, 12, 1)).astype(np.float32)
    train_ref = jax.jit(jax_net.apply)(params, jnp.asarray(x))
    with jax_norms.eval_mode():
        eval_ref = jax.jit(jax_net.apply)(params, jnp.asarray(x))
    net.eval()  # torch's eval mode changes nothing: the switch is explicit
    with torch.no_grad():
        _close(net(torch.from_numpy(x)), train_ref)
        norms.set_eval(net)
        _close(net(torch.from_numpy(x)), eval_ref)
        norms.set_eval(net, False)
        _close(net(torch.from_numpy(x)), train_ref)
    assert np.abs(np.asarray(train_ref) - np.asarray(eval_ref)).max() > 1e-3


def test_batch_norm_collects_and_refreshes_as_jax():
    """``collect_batch_stats`` and ``ema_update_stats`` against the JAX
    package's on one batch-norm layer: batch mean, biased variance, EMA 0.1;
    the forward itself leaves the buffers alone."""
    x = (np.random.default_rng(9).normal(2.0, 3.0, (2, 5, 5, 5, 4))).astype(np.float32)
    spec = jax_norms.get_norm_spec("batch", 3)
    p = spec.init(jax.random.PRNGKey(0), 4)
    with jax_norms.collect_batch_stats() as stats:
        spec.apply(p, jnp.asarray(x))
    (rm, rv), = jax_norms.ema_update_stats(stats)
    bn = norms.get_norm_spec("batch").layer(4)
    with torch.no_grad(), norms.collect_batch_stats() as got:
        bn(torch.from_numpy(x))
    assert torch.equal(bn.running_mean, torch.zeros(4))
    assert torch.equal(bn.running_var, torch.ones(4))
    norms.ema_update_stats(got)
    _close(bn.running_mean, rm)
    _close(bn.running_var, rv)
    # torch's own BatchNorm would use the unbiased variance: not this
    n = x.size / 4
    unbiased = 0.9 + 0.1 * x.var(axis=(0, 1, 2, 3)) * n / (n - 1)
    assert not np.allclose(bn.running_var.numpy(), unbiased, rtol=1e-6)


@pytest.mark.parametrize("size", [1, 3, 7, 14, 16, 32, 224])
def test_resize_linear_matches_jax_image_resize(size):
    """VGG's resize to 7x7: antialiased when it shrinks (so not
    AdaptiveAvgPool2d), plain interpolation when it grows."""
    x = np.random.default_rng(size).random((2, size, size + (size > 1), 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, 7, 7, 3), method="linear")
    y = resize_linear(torch.from_numpy(x), (7, 7))
    _close(y, ref)
    if size == 14:
        pooled = torch.nn.functional.adaptive_avg_pool2d(
            torch.from_numpy(x[:, :, :14]).movedim(-1, 1), 7).movedim(1, -1)
        assert (pooled - resize_linear(torch.from_numpy(x[:, :, :14]), (7, 7))).abs().max() > 1e-3


def test_spectral_norm_runs_three_iterations_from_the_stored_u():
    """``Conv.spectral_weight``: the JAX normalisation's value, ``u`` never
    updated, sigma constant to the gradient."""
    conv = Conv(16, 32, 4, 2, 1, dim=2, spectral=True)
    rng = np.random.default_rng(10)
    w = rng.normal(size=(4, 4, 16, 32)).astype(np.float32)
    u = rng.normal(size=(32,)).astype(np.float32)
    conv.weight.data = Conv.weight_from_jax(w).contiguous()
    conv.u.copy_(torch.from_numpy(u))
    ref, vjp = jax.vjp(lambda ww: _spectral_normalise(ww, jnp.asarray(u)), jnp.asarray(w))
    got = conv.spectral_weight()
    _close(Conv.weight_to_jax(got).detach(), ref)
    cot = rng.normal(size=w.shape).astype(np.float32)
    got.backward(Conv.weight_from_jax(cot))
    (gref,) = vjp(jnp.asarray(cot))
    _close(Conv.weight_to_jax(conv.weight.grad), gref)
    np.testing.assert_array_equal(conv.u.numpy(), u)
    # one iteration from u, torch.nn.utils.spectral_norm's count, is another function
    one = jax.jit(lambda ww: _spectral_normalise(ww, jnp.asarray(u), n_iter=1))(jnp.asarray(w))
    assert np.abs(np.asarray(one) - np.asarray(ref)).max() > 1e-6


def test_reflect_pad_and_k3_transpose_match_jax():
    rng = np.random.default_rng(11)
    x = rng.random((1, 6, 5, 3)).astype(np.float32)
    _close(reflect_pad(torch.from_numpy(x), 2), jnp.pad(jnp.asarray(x),
                                                        ((0, 0), (2, 2), (2, 2), (0, 0)),
                                                        mode="reflect"))
    jt = JaxConvTranspose(2, 3, 5, 3, 2)
    p = jt.init(jax.random.PRNGKey(1))
    ref = jt.apply(p, jnp.asarray(x))[:, 1:, 1:]  # the ResNet's crop of the VALID transpose
    t = ConvTranspose(3, 5, 3, 2, dim=2, padding=1, output_padding=1)
    t.weight.data = ConvTranspose.weight_from_jax(np.asarray(p["w"])).contiguous()
    t.bias.data = torch.from_numpy(np.asarray(p["b"]))
    with torch.no_grad():
        _close(t(torch.from_numpy(x)), ref)


@pytest.mark.parametrize("layout", ["raw", "torch"])
@pytest.mark.parametrize("k", [3, 4])
def test_fixed_kernel_without_noise_matches_jax(layout, k):
    """``init_from_psf`` takes both PSF layouts; an even kernel is cropped
    to its centre."""
    psf = np.random.default_rng(k).random((k, k, k)).astype(np.float32)
    given = psf if layout == "raw" else psf[None, None]
    jax_net = jax_factory.define_G(1, 1, 64, "fixed_kernel", given_psf=given,
                                   noise_setting=(0.1, 10.0), dimension=3)
    net = factory.define_G(1, 1, 64, "fixed_kernel", given_psf=given, noise_setting=(0.1, 10.0))
    params = jax_net.init_from_psf(given)
    net.init_from_psf(given)
    _same_tree(params, net)
    x = np.random.default_rng(12).random((1, 12, 12, 12, 1)).astype(np.float32)
    ref = jax_net.apply(params, jnp.asarray(x))
    with torch.no_grad():
        y = net(torch.from_numpy(x))
    assert y.shape == ref.shape == x.shape
    _close(y, ref)


def test_fixed_kernel_noise_is_minmaxed_and_poisson_quantised():
    """The noise path, held by what a different RNG allows: the output spans
    [0, 1] exactly, and its levels are whole Poisson counts rescaled."""
    net = factory.define_G(1, 1, 64, "fixed_kernel", noise_setting=(0.1, 20.0))
    psf = np.zeros((9, 9, 9), np.float32)
    psf[4, 4, 4] = 1.0
    net.init_from_psf(psf)
    x = torch.from_numpy(np.random.default_rng(13).random((1, 12, 12, 12, 1),
                                                          dtype=np.float32))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        y = net(x, generator=gen)
        y2 = net(x, generator=torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)  # the generator decides the draw
    assert float(y.min()) == 0.0 and float(y.max()) == 1.0
    levels = torch.unique(y)
    counts = levels / levels[levels > 0].min()  # (k - k_min) of each level
    assert torch.allclose(counts, counts.round(), atol=1e-3)
    assert 2 < len(levels) <= 20 * 2 + 1


@pytest.mark.parametrize("pool_size", [0, 50])
def test_image_pool_queries_as_the_jax_pool(pool_size):
    """The same seed in the port's ``random.Random`` and in the ``random``
    module the JAX pool draws from: the same images come back."""
    rng = np.random.default_rng(14)
    batches = [rng.random((4, 3, 3, 1)).astype(np.float32) for _ in range(30)]
    random.seed(5)
    jax_pool = JaxImagePool(pool_size)
    pool = ImagePool(pool_size, random.Random(5))
    for b in batches:
        ref = jax_pool.query(b)
        got = pool.query(torch.from_numpy(b))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if pool_size:
        assert len(pool.images) == pool_size
