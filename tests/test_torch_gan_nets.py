"""The port's Apollo nets, losses and probes against the JAX package on the
CPU: DeepLinearGenerator and NLayerDiscriminator on JAX-initialised weights
carried across by ``params_from_numpy``, the GAN losses, and the slice and
MIP probes at indices drawn from JAX keys, forward and gradient.  f32; nets
rtol 1e-5 with an absolute floor of 1e-5 * max|ref| (conv sums in another
order); losses and probes rtol 1e-6 (the same few operations)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroclear_tpu.nn import factory as jax_factory
from neuroclear_tpu.nn import losses as jax_losses
from neuroclear_tpu.nn.core import count_params as jax_count_params
from neuroclear_tpu.nn.core import flatten_params
from neuroclear_tpu.ops import sampling as jax_sampling
from neuroclear_tpu_torch.nn import factory
from neuroclear_tpu_torch.nn.losses import gan_loss, l1_loss
from neuroclear_tpu_torch.ops.sampling import random_projection, random_slice
from neuroclear_tpu_torch.utils.weights import count_params, flat_from_module, params_from_numpy

RTOL = 1e-5


def _carry(jax_net, net, seed):
    params = jax_net.init(jax.random.PRNGKey(seed), "kaiming")
    flat = flatten_params(params)
    net.load_state_dict(params_from_numpy(flat, net))
    return params, flat


def _close(a, ref, rtol=RTOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(a, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def test_parameter_counts():
    g_b = factory.define_G(1, 1, 64, "deep_linear_gen")
    d = factory.define_D(1, 64, "basic")
    assert count_params(g_b) == 647_120
    assert count_params(d) == 2_762_689
    jax_d = jax_factory.define_D(1, 64, "basic", 3, "instance", dimension=2)
    assert jax_count_params(jax_d.init(jax.random.PRNGKey(0), "kaiming")) == 2_762_689


def test_deep_linear_generator_matches_jax():
    jax_net = jax_factory.define_G(1, 1, 64, "deep_linear_gen", "instance", dimension=3)
    net = factory.define_G(1, 1, 64, "deep_linear_gen")
    params, flat = _carry(jax_net, net, 1)
    x = np.random.default_rng(1).random((1, 10, 12, 8, 1)).astype(np.float32)
    ref = jax_net.apply(params, jnp.asarray(x))
    with torch.no_grad():
        y = net(torch.from_numpy(x)).numpy()
    _close(y, ref)
    # and back: the port's weights in the JAX flat format are the same arrays
    back = flat_from_module(net)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


@pytest.mark.parametrize("n_layers, size", [(3, 32), (2, 20)])
def test_nlayer_discriminator_matches_jax(n_layers, size):
    netd = "basic" if n_layers == 3 else "n_layers"
    jax_net = jax_factory.define_D(1, 64, netd, n_layers, "instance", dimension=2)
    net = factory.define_D(1, 64, netd, n_layers)
    params, flat = _carry(jax_net, net, 2)
    rng = np.random.default_rng(2)
    for k in flat:  # random biases, so every bias takes part
        if k.endswith(".b"):
            flat[k] = (rng.normal(size=flat[k].shape) * 0.1).astype(np.float32)
    net.load_state_dict(params_from_numpy(flat, net))
    params = {k.split(".")[0]: {} for k in flat}
    for k, v in flat.items():
        name, leaf = k.split(".")
        params[name][leaf] = jnp.asarray(v)
    x = rng.random((2, size, size, 1)).astype(np.float32)
    ref = jax_net.apply(params, jnp.asarray(x))
    with torch.no_grad():
        y = net(torch.from_numpy(x)).numpy()
    assert y.shape == ref.shape
    _close(y, ref)


@pytest.mark.parametrize("mode", ["lsgan", "vanilla", "wgangp"])
def test_gan_loss_matches_jax(mode):
    pred = np.random.default_rng(3).normal(size=(1, 11, 11, 1)).astype(np.float32) * 2
    for real in (True, False):
        ref = float(jax_losses.gan_loss(jnp.asarray(pred), real, mode))
        got = float(gan_loss(torch.from_numpy(pred).to(torch.bfloat16).float(), real, mode))
        ref_b = float(jax_losses.gan_loss(jnp.asarray(pred).astype(jnp.bfloat16), real, mode))
        assert got == pytest.approx(ref_b, rel=1e-6, abs=1e-7)
        got = float(gan_loss(torch.from_numpy(pred), real, mode))
        assert got == pytest.approx(ref, rel=1e-6, abs=1e-7)
    with pytest.raises(NotImplementedError):
        gan_loss(torch.from_numpy(pred), True, "hinge")


def test_l1_loss_matches_jax():
    rng = np.random.default_rng(4)
    a, b = (rng.random((1, 6, 6, 6, 1)).astype(np.float32) for _ in range(2))
    ref = float(jax_losses.l1_loss(jnp.asarray(a), jnp.asarray(b)))
    assert float(l1_loss(torch.from_numpy(a), torch.from_numpy(b))) == pytest.approx(ref,
                                                                                     rel=1e-6)


def _tied_volume(seed):
    """Values on a coarse grid, so that MIP windows hold tied maxima."""
    rng = np.random.default_rng(seed)
    return (np.round(rng.random((1, 9, 7, 8, 1)) * 3) / 3).astype(np.float32)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_probes_match_jax_with_jax_draws(axis):
    """Slice and MIP at the index / window start the JAX key draws, forward
    and gradient; the tied maxima split the gradient evenly in both."""
    vol = _tied_volume(axis)
    cot_rng = np.random.default_rng(10 + axis)
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(axis), 4)):
        n = vol.shape[axis + 1]
        depth = 2 + i
        idx = int(jax.random.randint(key, (), 0, n))
        start = int(jax.random.randint(key, (), 0, n - depth))
        for name, jfn, tfn in (
                ("slice", lambda v: jax_sampling.random_slice(key, v, axis),
                 lambda v: random_slice(v, idx, axis)),
                ("proj", lambda v: jax_sampling.random_projection(key, v, depth, axis),
                 lambda v: random_projection(v, start, depth, axis))):
            ref, vjp = jax.vjp(jfn, jnp.asarray(vol))
            cot = cot_rng.normal(size=ref.shape).astype(np.float32)
            (gref,) = vjp(jnp.asarray(cot))
            vt = torch.from_numpy(vol).requires_grad_(True)
            out = tfn(vt)
            out.backward(torch.from_numpy(cot))
            np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref), err_msg=name)
            np.testing.assert_allclose(vt.grad.numpy(), np.asarray(gref), rtol=1e-6,
                                       atol=1e-7, err_msg=name)
    # the coarse grid does make ties: some window's maximum occurs twice
    win = np.moveaxis(vol, axis + 1, 1)[:, :4]
    top = win.max(axis=1, keepdims=True)
    assert ((win == top).sum(axis=1) > 1).any()
