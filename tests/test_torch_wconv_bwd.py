"""The port's conv gradients (neuroclear_tpu_torch/ops/wconv.py: conv3d_dx,
conv3d_dw and WConvFn) against the JAX package's custom VJP of the W-pair
conv, ``pallas_wconv._bwd`` (its Pallas dx and dw kernels, run in interpret
mode as tests/test_ops.py runs them) and ``_bwd_xla``, on the CPU, where the
wrappers run their plain versions.  f32, atol and rtol 2e-4: the JAX test's
own bar for these kernels."""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neuroclear_tpu_torch.nn.core import Conv
from neuroclear_tpu_torch.ops import wconv

TOL = 2e-4


@pytest.fixture(scope="module")
def pallas_wconv():
    """The JAX package's pallas_wconv with the kernel enabled in interpret
    mode, restored afterwards (environment set and module reloaded here; the
    package itself is not touched)."""
    os.environ["NEUROCLEAR_PALLAS_WCONV"] = "1"
    os.environ["NEUROCLEAR_PALLAS_INTERPRET"] = "1"
    from neuroclear_tpu.ops import pallas_wconv as mod

    importlib.reload(mod)
    try:
        yield mod
    finally:
        os.environ.pop("NEUROCLEAR_PALLAS_WCONV", None)
        os.environ.pop("NEUROCLEAR_PALLAS_INTERPRET", None)
        importlib.reload(mod)


def _inputs(cin, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, 4, 6, 16, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, cin, 64)) * 0.05).astype(np.float32)
    g = rng.normal(size=(1, 4, 6, 16, 64)).astype(np.float32)
    return x, w, g


def _dw_to_jax(dw_packed: torch.Tensor) -> np.ndarray:
    """Packed (27, 64, cin) -> JAX (3, 3, 3, cin, 64)."""
    cin = dw_packed.shape[2]
    return dw_packed.reshape(3, 3, 3, 64, cin).permute(0, 1, 2, 4, 3).numpy()


@pytest.mark.parametrize("cin", [64, 128])
def test_dx_and_dw_match_the_pallas_backward(pallas_wconv, cin):
    x, w, g = _inputs(cin, cin)
    assert pallas_wconv._bwd_plans_ok(x.shape, jnp.float32, cin)
    dx_p, dw_p = pallas_wconv._bwd((jnp.asarray(x), jnp.asarray(w)), jnp.asarray(g))
    dx_x, dw_x = pallas_wconv._bwd_xla((jnp.asarray(x), jnp.asarray(w)), jnp.asarray(g))
    wt = wconv.pack_weight(Conv.weight_from_jax(w))
    dx = wconv.conv3d_dx(torch.from_numpy(g), wt)
    dw = wconv.conv3d_dw(torch.from_numpy(x), torch.from_numpy(g))
    assert dx.shape == x.shape and dw.shape == (27, 64, cin) and dw.dtype == torch.float32
    for ref_dx, ref_dw in ((dx_p, dw_p), (dx_x, dw_x)):
        np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(_dw_to_jax(dw), np.asarray(ref_dw), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("cin", [64, 128])
def test_autograd_function_matches_the_pallas_backward(pallas_wconv, cin):
    """WConvFn's input, weight and bias gradients through Conv's packing,
    against ``_bwd`` (the bias gradient: the sum of the cotangent)."""
    x, w, g = _inputs(cin, cin + 1)
    dx_p, dw_p = pallas_wconv._bwd((jnp.asarray(x), jnp.asarray(w)), jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    wtor = Conv.weight_from_jax(w).clone().requires_grad_(True)
    bias = torch.zeros(64, requires_grad=True)
    y = wconv.WConvFn.apply(xt, wconv.pack_weight(wtor), bias, False)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_p), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(Conv.weight_to_jax(wtor.grad).numpy(), np.asarray(dw_p),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(bias.grad.numpy(), g.sum(axis=(0, 1, 2, 3)), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("cin", [64, 128])
def test_autograd_function_matches_conv3d_in_float64(cin):
    """In f64 the plain versions are exact to f64 rounding: WConvFn's
    output and its three gradients equal autograd through F.conv3d."""
    rng = np.random.default_rng(cin + 7)
    x = torch.from_numpy(rng.normal(size=(2, 3, 4, 6, cin)))
    w = torch.from_numpy(rng.normal(size=(64, cin, 3, 3, 3)) * 0.05)
    b = torch.from_numpy(rng.normal(size=(64,)))
    g = torch.from_numpy(rng.normal(size=(2, 3, 4, 6, 64)))
    outs = []
    for use_fn in (True, False):
        xt, wt_, bt = (t.clone().requires_grad_(True) for t in (x, w, b))
        if use_fn:
            y = wconv.WConvFn.apply(xt, wconv.pack_weight(wt_), bt, True)
        else:
            y = F.conv3d(xt.permute(0, 4, 1, 2, 3), wt_, bt, 1, 1).permute(0, 2, 3, 4, 1)
        y.backward(g)
        outs.append((y.detach(), xt.grad, wt_.grad, bt.grad))
    for a, b_ in zip(*outs):
        torch.testing.assert_close(a, b_, rtol=1e-10, atol=1e-10)


def test_bf16_weight_gradient_is_rounded_to_bf16():
    """Through Conv in bf16, dw reaches the f32 master weight rounded to
    bf16, as the JAX package's ``_bwd`` returns ``dw.astype(w.dtype)``."""
    rng = np.random.default_rng(11)
    conv = Conv(64, 64, 3, 1, 1, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(rng.normal(size=(64, 64, 3, 3, 3)) * 0.05))
    x = torch.from_numpy(rng.normal(size=(1, 4, 4, 6, 64)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(1, 4, 4, 6, 64)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    conv(xb).backward(g.to(torch.bfloat16))
    grad = conv.weight.grad
    assert grad.dtype == torch.float32
    assert torch.equal(grad, grad.to(torch.bfloat16).float())
    ref = wconv.conv3d_dw_plain(xb, g.to(torch.bfloat16)).to(torch.bfloat16).float()
    assert torch.equal(wconv.pack_weight(grad), ref)
