"""The port's W-pair conv module (neuroclear_tpu_torch/ops/wconv.py) against
the JAX package's conv, on the CPU, where the wrapper runs its plain
version.  f32 throughout: the point is the algorithm and the weight layout
the kernel consumes, not bf16 rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroclear_tpu.ops.conv_wpack import conv3d_wpack2
from neuroclear_tpu_torch.nn.core import Conv
from neuroclear_tpu_torch.ops import wconv

# f32 sums of 27*cin products in another order: ~1e-6 relative to the
# output's scale; rtol 1e-5 with an absolute floor of 1e-5 * max|ref| for
# outputs near zero
RTOL = 1e-5


def _jax_conv(x, w):
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1, 1), ((1, 1),) * 3,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        precision=jax.lax.Precision.HIGHEST))


@pytest.mark.parametrize("cin, shape", [(64, (1, 6, 8, 16)), (128, (2, 4, 4, 12)),
                                        (64, (1, 3, 5, 4))])
def test_wconv_matches_jax_conv(cin, shape):
    rng = np.random.default_rng(cin + shape[-1])
    x = rng.normal(size=shape + (cin,)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, cin, 64)) * 0.05).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    ref = _jax_conv(x, w) + b
    wt = wconv.pack_weight(Conv.weight_from_jax(w))
    y = wconv.conv3d(torch.from_numpy(x), wt, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(y, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


def test_wconv_matches_wpack_reference():
    """The JAX package's own plain reference of the packed kernel
    (conv_wpack.conv3d_wpack2) computes the same function."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 4, 6, 8, 128)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, 128, 64)) * 0.05).astype(np.float32)
    ref = np.asarray(conv3d_wpack2(jnp.asarray(x), jnp.asarray(w),
                                   precision=jax.lax.Precision.HIGHEST))
    y = wconv.conv3d(torch.from_numpy(x), wconv.pack_weight(Conv.weight_from_jax(w)),
                     torch.zeros(64)).numpy()
    np.testing.assert_allclose(y, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


def test_wconv_gate_matches_jax_gate():
    """Same shapes in and out of the gate as pallas_wconv.supported."""
    assert wconv.supported((2, 140, 140, 140, 64), 64, 64, 3, 1, 1, 3)
    assert wconv.supported((2, 140, 140, 140, 128), 128, 64, 3, 1, 1, 3)
    assert not wconv.supported((1, 6, 8, 15, 64), 64, 64, 3, 1, 1, 3)   # odd W
    assert not wconv.supported((1, 6, 8, 2, 64), 64, 64, 3, 1, 1, 3)    # W < 4
    assert not wconv.supported((1, 6, 8, 16, 64), 64, 128, 3, 1, 1, 3)  # cout 128
    assert not wconv.supported((1, 6, 8, 16, 32), 32, 64, 3, 1, 1, 3)   # cin 32
    assert not wconv.supported((1, 6, 8, 16, 1), 1, 64, 3, 1, 1, 3)     # first conv
    assert not wconv.supported((1, 6, 8, 16, 64), 64, 64, 1, 1, 0, 3)   # 1x1x1


def test_conv_module_routes_bf16_gate_through_wconv():
    """A bf16 Conv inside the gate runs the wconv wrapper (its plain version
    on the CPU) and agrees with the f32 conv to bf16 rounding."""
    rng = np.random.default_rng(5)
    conv = Conv(64, 64, 3, 1, 1)
    w = (rng.normal(size=(3, 3, 3, 64, 64)) * 0.05).astype(np.float32)
    with torch.no_grad():
        conv.weight.copy_(Conv.weight_from_jax(w))
        conv.bias.copy_(torch.from_numpy(rng.normal(size=(64,)).astype(np.float32)))
    x = torch.from_numpy(rng.normal(size=(1, 4, 4, 8, 64)).astype(np.float32))
    with torch.no_grad():
        y32 = conv(x)
        y16 = conv(x.to(torch.bfloat16))
    assert y16.dtype == torch.bfloat16 and y16.shape == y32.shape
    # inputs and weights rounded to bf16 (2^-9 relative each) over 1728
    # terms, then one bf16 rounding of the output
    err = (y16.float() - y32).abs().max().item()
    assert err <= 2e-2 * y32.abs().max().item(), err


def test_wconv_kernel_wrapper_refuses_bad_cuda_input():
    """Off the CPU the wrapper never falls back: a tensor on another device
    type is refused before any launch."""
    x = torch.zeros((1, 4, 4, 8, 64), dtype=torch.bfloat16, device="meta")
    wt = torch.zeros((27, 64, 64), dtype=torch.bfloat16, device="meta")
    before = wconv.conv3d.launches
    with pytest.raises((ValueError, TypeError, RuntimeError, NotImplementedError)):
        wconv.conv3d(x, wt, torch.zeros(64, device="meta"))
    assert wconv.conv3d.launches == before
