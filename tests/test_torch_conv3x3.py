"""The port's dense-K conv module (neuroclear_tpu_torch/ops/conv3x3.py) against
the JAX package's ``pallas_conv.conv3d_3x3``, run in Pallas interpret mode on
the CPU as tests/test_ops.py runs it, where the port's wrapper runs its plain
version.  f32 throughout: the point is the algorithm, the weight layout and
the gradients, not bf16 rounding.

Tolerances: the forward sums 27 * cin products in another order than the
Pallas kernel's dot, ~1e-6 relative to the output's scale (RTOL 1e-5, with
an absolute floor of RTOL * max|ref| for outputs near zero); the gradients
of sum(y^2) chain two such sums, GRAD_RTOL 1e-4 the same way.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroclear_tpu.ops import pallas_conv
from neuroclear_tpu_torch.nn.core import Conv
from neuroclear_tpu_torch.ops import conv3x3, wconv

RTOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(scope="module")
def pc():
    """pallas_conv reloaded with its switch on, in interpret mode; the
    environment and the module are restored afterwards."""
    saved = {k: os.environ.get(k) for k in ("NEUROCLEAR_PALLAS_INTERPRET",
                                            "NEUROCLEAR_PALLAS_CONV")}
    os.environ["NEUROCLEAR_PALLAS_INTERPRET"] = "1"
    os.environ["NEUROCLEAR_PALLAS_CONV"] = "1"
    try:
        yield importlib.reload(pallas_conv)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        importlib.reload(pallas_conv)


def _close(got, ref, rtol):
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("cin, cout", [(32, 32), (64, 128), (96, 96), (256, 128)])
def test_conv3x3_and_gradients_match_pallas_conv(pc, cin, cout):
    rng = np.random.default_rng(cin + cout)
    shape = (1, 4, 4, 32)
    x = rng.normal(size=shape + (cin,)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, cin, cout)) * np.sqrt(2.0 / (27 * cin))).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    assert pc.supported(x.shape, w.shape, (1, 1, 1), "SAME", (1, 1, 1))

    def loss(x, w):
        return jnp.sum(jnp.square(pc.conv3d_3x3(x, w)))

    ref_y = np.asarray(pc.conv3d_3x3(jnp.asarray(x), jnp.asarray(w))) + b
    ref_gx, ref_gw = (np.asarray(g) for g in jax.grad(loss, (0, 1))(jnp.asarray(x),
                                                                  jnp.asarray(w)))

    xt = torch.from_numpy(x).requires_grad_(True)
    wj = torch.from_numpy(w).requires_grad_(True)
    wt = wconv.pack_weight(Conv.weight_from_jax(wj))
    bt = torch.from_numpy(b)
    y = conv3x3.conv3d(xt.detach(), wt.detach(), bt)
    _close(y.numpy(), ref_y, RTOL)
    # the gradient of sum(conv^2) without the bias, as the JAX loss has none
    yf = conv3x3.Conv3x3Fn.apply(xt, wt, torch.zeros(cout), False)
    (yf ** 2).sum().backward()
    _close(xt.grad.numpy(), ref_gx, GRAD_RTOL)
    _close(wj.grad.numpy(), ref_gw, GRAD_RTOL)


SHAPES = [  # (x shape, cin, cout)
    ((2, 70, 70, 70, 64), 64, 128), ((2, 70, 70, 70, 256), 256, 128),
    ((1, 54, 54, 54, 128), 128, 128), ((1, 4, 4, 32, 32), 32, 32),
    ((1, 4, 4, 32, 96), 96, 96), ((1, 4, 4, 32, 64), 64, 64),
    ((1, 4, 4, 31, 64), 64, 128),    # W < 32
    ((1, 4, 3, 32, 64), 64, 128),    # H < 4
    ((1, 4, 4, 32, 48), 48, 64),     # cin not a multiple of 32
    ((1, 4, 4, 32, 64), 64, 160),    # cout > 128
    ((1, 4, 4, 32, 64), 64, 80),     # cout not a multiple of 32
    ((1, 4, 4, 32, 64), 64, 256),    # the bottom convs
    ((1, 4, 4, 32, 1), 1, 64),       # the first conv
]


def test_gate_matches_pallas_conv_gate(pc, monkeypatch):
    monkeypatch.setenv("NEUROCLEAR_PALLAS_CONV", "1")
    for x_shape, cin, cout in SHAPES:
        want = pc.supported(x_shape, (3, 3, 3, cin, cout), (1, 1, 1), "SAME", (1, 1, 1))
        assert conv3x3.supported(x_shape, cin, cout, 3, 1, 1, 3) == want, (x_shape, cin, cout)
    assert not conv3x3.supported((1, 4, 4, 32, 64), 64, 64, 1, 1, 0, 3)     # 1x1x1
    assert not conv3x3.supported((1, 4, 4, 32, 64), 64, 64, 3, 2, 1, 3)     # stride 2
    monkeypatch.setenv("NEUROCLEAR_PALLAS_CONV", "0")
    assert not conv3x3.supported((2, 70, 70, 70, 64), 64, 128, 3, 1, 1, 3)  # switch off
    monkeypatch.delenv("NEUROCLEAR_PALLAS_CONV")
    assert not conv3x3.supported((2, 70, 70, 70, 64), 64, 128, 3, 1, 1, 3)  # off by default


@pytest.mark.parametrize("switch", ["1", "0"])
def test_conv_module_routes_gate_shapes_through_conv3x3(monkeypatch, switch):
    """With the switch on, a bf16 Conv inside the gate runs the conv3x3
    wrapper (its plain version on the CPU), with and without a gradient; the
    W-pair gate still comes first.  With the switch off, neither runs."""
    monkeypatch.setenv("NEUROCLEAR_PALLAS_CONV", switch)
    calls = []
    plain = conv3x3.conv3d_plain
    monkeypatch.setattr(conv3x3, "conv3d_plain", lambda *a: (calls.append(a[0].shape[-1]),
                                                             plain(*a))[1])
    rng = np.random.default_rng(7)
    conv = Conv(64, 128, 3, 1, 1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(rng.normal(size=(128, 64, 3, 3, 3)) * 0.03))
    x = torch.from_numpy(rng.normal(size=(1, 4, 4, 32, 64)).astype(np.float32))
    with torch.no_grad():
        y32 = conv(x)
        y16 = conv(x.to(torch.bfloat16))
    xg = x.to(torch.bfloat16).requires_grad_(True)
    conv(xg).float().sum().backward()
    assert xg.grad is not None and conv.weight.grad is not None
    assert calls == ([64, 64] if switch == "1" else [])
    # inputs and weights rounded to bf16 over 1728 terms, one rounding out
    assert (y16.float() - y32).abs().max().item() <= 2e-2 * y32.abs().max().item()

    calls.clear()
    with torch.no_grad():
        Conv(64, 64, 3, 1, 1)(x.to(torch.bfloat16))  # the W-pair conv's gate
    assert calls == []


def test_conv3x3_wrapper_refuses_bad_cuda_input():
    """Off the CPU the wrapper never falls back: an input it does not take,
    and a well-formed one on a device that is not CUDA, are refused by its
    own checks before the kernel is built or launched."""
    wt = torch.zeros((27, 128, 64), dtype=torch.bfloat16, device="meta")
    x = torch.zeros((1, 4, 4, 32, 64), dtype=torch.bfloat16, device="meta")
    before = conv3x3.conv3d.launches
    with pytest.raises(TypeError, match="takes torch.bfloat16 x, got torch.float32"):
        conv3x3.conv3d(x.float(), wt)
    with pytest.raises(ValueError, match=r"does not take x \(1, 4, 4, 32, 48\)"):
        conv3x3.conv3d(x[..., :48].contiguous(), wt[..., :48].contiguous())
    with pytest.raises(ValueError, match="x must be a contiguous"):
        conv3x3.conv3d(torch.zeros((1, 4, 4, 64, 32), dtype=torch.bfloat16,
                                   device="meta").transpose(3, 4), wt)
    with pytest.raises(ValueError, match=r"bias \(64,\) does not match cout 128"):
        conv3x3.conv3d(x, wt, torch.zeros(64, device="meta"))
    with pytest.raises(ValueError, match="launches on a CUDA device, got a tensor on meta"):
        conv3x3.conv3d(x, wt, torch.zeros(128, device="meta"))
    assert conv3x3.conv3d.launches == before
