"""The port's instance-norm backward (neuroclear_tpu_torch/ops/inorm.py:
InstanceNormFn, pair_sums_gy, bwd_map) against the JAX package's custom VJP
of ``pallas_ops.instance_norm`` and its building blocks ``_pair_sums(g, y)``
and ``_bwd_map``, on the CPU, where the wrappers run their plain versions.
f32, rtol 1e-5 with an absolute floor of 1e-5 * max|ref| for values near
zero: f32 sums over the spatial rows taken in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroclear_tpu.ops import pallas_ops
from neuroclear_tpu_torch.ops import inorm

RTOL = 1e-5


def _close(a, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(a, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3.0 + 1.5).astype(np.float32)
    # a cotangent with a per-channel common mode, as a 1x1 conv after the
    # norm gives one, so the mean subtraction of the backward is exercised
    common = rng.normal(size=(1,) * (len(shape) - 1) + (shape[-1],))
    g = (rng.normal(size=shape) * 0.5 + common).astype(np.float32)
    return x, g


@pytest.mark.parametrize("shape", [(1, 8, 8, 8, 64), (2, 6, 6, 128)])
@pytest.mark.parametrize("act", [None, "relu", "leaky"])
def test_instance_norm_function_matches_jax_vjp(shape, act):
    x, g = _inputs(shape, shape[-1] + len(shape))
    y_ref, vjp = jax.vjp(lambda v: pallas_ops.instance_norm_act(v, act), jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = inorm.instance_norm_act(xt, act)
    y.backward(torch.from_numpy(g))
    _close(y.detach().numpy(), y_ref)
    _close(xt.grad.numpy(), dx_ref)


@pytest.mark.parametrize("act", [None, "relu", "leaky"])
def test_pair_sums_gy_and_bwd_map_match_jax(act):
    """The two backward passes on the same (g, y): with no activation they
    are ``_pair_sums(g3, y3)`` and ``_bwd_map``; with one, the same on
    g' = g * act'(y) (JAX: the activation's VJP applied first)."""
    rng = np.random.default_rng(3)
    n, rows, c = 2, 300, 64
    y3 = rng.normal(size=(n, rows, c)).astype(np.float32)
    g3 = rng.normal(size=(n, rows, c)).astype(np.float32)
    if act is None:
        gd = jnp.asarray(g3)
    else:
        fn = jax.nn.relu if act == "relu" else (lambda v: jax.nn.leaky_relu(v, 0.2))
        gd = jax.vjp(fn, jnp.asarray(y3))[1](jnp.asarray(g3))[0]
    sg, sgy = pallas_ops._pair_sums(gd, jnp.asarray(y3))
    s = inorm.pair_sums_gy(torch.from_numpy(g3), torch.from_numpy(y3), act)
    assert s.dtype == torch.float32 and s.shape == (n, 2, c)
    _close(s[:, 0].numpy(), sg)
    _close(s[:, 1].numpy(), sgy)
    rstd = (rng.random((n, c), dtype=np.float32) + 0.5)
    mg, mgy = np.asarray(sg) / rows, np.asarray(sgy) / rows
    ref = pallas_ops._bwd_map(gd, jnp.asarray(y3), jnp.asarray(rstd), jnp.asarray(mg),
                              jnp.asarray(mgy))
    dx = inorm.bwd_map(torch.from_numpy(g3), torch.from_numpy(y3), torch.from_numpy(rstd),
                       torch.from_numpy(mg), torch.from_numpy(mgy), act)
    _close(dx.numpy(), ref)


def test_map_keeps_the_pre_activation_for_the_backward():
    """With ``keep_pre`` the map returns y before the activation (the JAX
    VJP's saved ``y3``) beside act(y); without a gradient only act(y) is
    written."""
    rng = np.random.default_rng(5)
    x3 = torch.from_numpy(rng.normal(size=(2, 50, 64)).astype(np.float32)).to(torch.bfloat16)
    scale = torch.from_numpy(rng.random((2, 64), dtype=np.float32) + 0.5)
    shift = torch.from_numpy(rng.normal(size=(2, 64)).astype(np.float32))
    pre, a = inorm.affine_map_act(x3, scale, shift, "leaky", keep_pre=True)
    ref_pre = (x3.float() * scale[:, None] + shift[:, None]).to(torch.bfloat16)
    assert torch.equal(pre, ref_pre) and (pre < 0).any()
    assert torch.equal(a, torch.where(ref_pre >= 0, ref_pre, ref_pre * 0.2))
    assert torch.equal(inorm.affine_map_act(x3, scale, shift, "leaky"), a)


def test_relu_derivative_at_zero_follows_jax():
    """act'(0): 0 for relu (jax.nn.relu), 1 for leaky_relu (x >= 0)."""
    y = torch.tensor([[[-1.0, 0.0, 2.0]]])
    g = torch.ones_like(y)
    assert inorm.act_grad_plain(g, y, "relu").tolist() == [[[0.0, 0.0, 1.0]]]
    assert inorm.act_grad_plain(g, y, "leaky").tolist() == [[[pytest.approx(0.2), 1.0, 1.0]]]
    for act in ("relu", "leaky"):
        fn = jax.nn.relu if act == "relu" else (lambda v: jax.nn.leaky_relu(v, 0.2))
        ref = jax.vjp(fn, jnp.asarray(y.numpy()))[1](jnp.asarray(g.numpy()))[0]
        np.testing.assert_allclose(inorm.act_grad_plain(g, y, act).numpy(), np.asarray(ref),
                                   rtol=1e-6)
