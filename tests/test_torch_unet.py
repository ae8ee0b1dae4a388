"""The port's UNetDeconv (neuroclear_tpu_torch/nn/generators.py) against the
JAX package's ``UNetDeconv.apply`` with the same weights, carried across by
``params_from_numpy``, on the CPU in f32."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroclear_tpu.nn.core import unflatten_params
from neuroclear_tpu.nn.generators import UNetDeconv as JaxUNetDeconv
from neuroclear_tpu_torch.nn.factory import define_G
from neuroclear_tpu_torch.nn.generators import UNetDeconv
from neuroclear_tpu_torch.utils.weights import (count_params, init_flat, load_npz,
                                                params_from_numpy)

# ten instance norms deep in f32: each conv's sum order differs from XLA's,
# ~1e-6 per layer, renormalised by every norm
RTOL = 1e-4


def _flat_with_biases(net, seed):
    """Kaiming weights as the JAX package draws them, plus random biases so
    every bias takes part in the comparison."""
    flat = init_flat(net, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for k in flat:
        if k.endswith(".b"):
            flat[k] = (rng.normal(size=flat[k].shape) * 0.1).astype(np.float32)
    return flat


@pytest.fixture(scope="module")
def weights():
    net = UNetDeconv(1, 1)
    flat = _flat_with_biases(net, 0)
    net.load_state_dict(params_from_numpy(flat, net))
    return net, flat


def test_parameter_count():
    assert count_params(UNetDeconv(1, 1)) == 7_077_251


def test_checkpoint_keys_match_the_jax_tree(weights):
    _, flat = weights
    shapes = jax.eval_shape(lambda k: JaxUNetDeconv(1, 1).init(k, "kaiming"),
                            jax.random.PRNGKey(0))

    def flat_shapes(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            key = f"{prefix}.{k}" if prefix else k
            out.update(flat_shapes(v, key) if isinstance(v, dict) else {key: v.shape})
        return out

    jax_flat = flat_shapes(shapes)
    assert set(flat) == set(jax_flat)
    for k, shape in jax_flat.items():
        assert flat[k].shape == shape, k


def test_unet_matches_jax_apply(weights):
    net, flat = weights
    rng = np.random.default_rng(2)
    x = rng.random((1, 24, 24, 24, 1), dtype=np.float32)
    ref = np.asarray(jax.jit(JaxUNetDeconv(1, 1).apply)(unflatten_params(flat),
                                                        jnp.asarray(x)))
    with torch.inference_mode():
        y = net(torch.from_numpy(x)).numpy()
    assert y.shape == ref.shape == (1, 24, 24, 24, 1)
    np.testing.assert_allclose(y, ref, rtol=RTOL, atol=RTOL)


def test_bf16_unet_bounded_against_f32(weights):
    """bf16 through the wconv and inorm plain versions stays within a
    stated bound of the f32 output: sigmoid outputs in [0, 1], bf16 keeps 8
    significant bits, and ten norms re-round the activations."""
    net, _ = weights
    x = torch.from_numpy(np.random.default_rng(3).random((1, 16, 16, 16, 1),
                                                          dtype=np.float32))
    with torch.inference_mode():
        y32 = net(x)
        y16 = net(x.to(torch.bfloat16))
    assert y16.dtype == torch.bfloat16
    err = (y16.float() - y32).abs()
    assert err.max().item() <= 0.05 and err.mean().item() <= 0.01, (
        err.max().item(), err.mean().item())


def test_npz_round_trip_and_plain_network(tmp_path, weights):
    """A flat .npz written as base_model.save_networks writes it loads into
    the port, and the plain-version network computes the same output."""
    _, flat = weights
    path = os.path.join(tmp_path, "iter_5_net_G_A.npz")
    np.savez(path, **flat)
    loaded = load_npz(path)
    plain = define_G(1, 1, 64, "unet_deconv", plain=True)
    plain.load_state_dict(params_from_numpy(loaded, plain))
    net = define_G(1, 1, 64, "unet_deconv")
    net.load_state_dict(params_from_numpy(loaded, net))
    x = torch.from_numpy(np.random.default_rng(4).random((1, 8, 8, 8, 1), dtype=np.float32))
    with torch.inference_mode():
        assert torch.equal(net(x), plain(x))
    with pytest.raises(KeyError):
        params_from_numpy({k: v for k, v in loaded.items() if k != "t_conv1.w"}, net)
    with pytest.raises(NotImplementedError, match="not recognized"):
        define_G(1, 1, 64, "unet_shallow")
