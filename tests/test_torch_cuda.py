"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes with ragged edges (the full-width shapes run in
chip_smoke.py).  Marked ``cuda``: they skip without a card.  On a machine
with the card and no JAX, run them without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from neuroclear_tpu_torch.ops import conv3x3, inorm, wconv

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape, cin", [((1, 3, 5, 6), 64), ((2, 4, 3, 10), 128),
                                        ((1, 5, 7, 10), 64), ((1, 2, 2, 4), 128)])
def test_wconv_kernel_matches_plain(dev, shape, cin):
    g = torch.Generator(device="cpu").manual_seed(cin + shape[-1])
    x = torch.randn(*shape, cin, generator=g).to(dev, torch.bfloat16)
    w = torch.randn(64, cin, 3, 3, 3, generator=g) * math.sqrt(2.0 / (27 * cin))
    b = torch.randn(64, generator=g).to(dev)
    wt = wconv.pack_weight(w.to(dev, torch.bfloat16))
    before = wconv.conv3d.launches
    y = wconv.conv3d(x, wt, b)
    torch.cuda.synchronize()
    assert wconv.conv3d.launches == before + 1
    p = wconv.conv3d_plain(x, wt, b).float()
    # one bf16 rounding of f32 sums taken in another order
    tol = 2.0 ** -7 * p.abs() + 2.0 ** -12 * p.abs().max()
    assert ((y.float() - p).abs() <= tol).all()


def _bf16_step_tol(p: torch.Tensor) -> torch.Tensor:
    """One bf16 rounding of f32 sums taken in another order."""
    return 2.0 ** -7 * p.abs() + 2.0 ** -12 * p.abs().max()


@pytest.mark.parametrize("shape, cin", [((1, 3, 5, 6), 64), ((2, 4, 3, 10), 128),
                                        ((1, 5, 7, 10), 128), ((1, 2, 2, 4), 64)])
def test_wconv_dx_kernel_matches_plain(dev, shape, cin):
    """The input gradient: the conv kernel with 64 or 128 output channels,
    no bias, in one launch."""
    g = torch.Generator(device="cpu").manual_seed(cin + shape[-1] + 1)
    gy = torch.randn(*shape, 64, generator=g).to(dev, torch.bfloat16)
    w = torch.randn(64, cin, 3, 3, 3, generator=g) * math.sqrt(2.0 / (27 * cin))
    wt = wconv.pack_weight(w.to(dev, torch.bfloat16))
    before = wconv.conv3d_dx.launches
    dx = wconv.conv3d_dx(gy, wt)
    torch.cuda.synchronize()
    assert wconv.conv3d_dx.launches == before + 1 and dx.shape == (*shape, cin)
    p = wconv.conv3d_dx_plain(gy, wt).float()
    assert ((dx.float() - p).abs() <= _bf16_step_tol(p)).all()


@pytest.mark.parametrize("shape, cin", [((1, 3, 5, 6), 64), ((2, 4, 3, 10), 128),
                                        ((1, 9, 11, 12), 64), ((1, 2, 2, 4), 128)])
def test_wconv_dw_kernel_matches_plain(dev, shape, cin):
    """The weight gradient, f32 out, against the plain f32 sums: f32 sums of
    the same bf16 products in another order, within 1e-5 of the sum of the
    products' magnitudes."""
    g = torch.Generator(device="cpu").manual_seed(cin + shape[-1] + 2)
    x = torch.randn(*shape, cin, generator=g).to(dev, torch.bfloat16)
    gy = torch.randn(*shape, 64, generator=g).to(dev, torch.bfloat16)
    before = wconv.conv3d_dw.launches
    dw = wconv.conv3d_dw(x, gy)
    torch.cuda.synchronize()
    assert wconv.conv3d_dw.launches == before + 1
    assert dw.dtype == torch.float32 and dw.shape == (27, 64, cin)
    p = wconv.conv3d_dw_plain(x, gy)
    mag = wconv.conv3d_dw_plain(x.abs(), gy.abs())
    assert ((dw - p).abs() <= 1e-5 * mag + 1e-6).all()


def test_wconv_autograd_function_on_the_card(dev):
    """WConvFn's three gradients through the kernels against the same
    Function on the plain versions."""
    g = torch.Generator(device="cpu").manual_seed(5)
    x = torch.randn(1, 4, 6, 8, 128, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(64, 128, 3, 3, 3, generator=g) * 0.03).to(dev)
    b = torch.randn(64, generator=g).to(dev)
    gy = torch.randn(1, 4, 6, 8, 64, generator=g).to(dev, torch.bfloat16)
    grads = []
    for plain in (False, True):
        xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))
        y = wconv.WConvFn.apply(xr, wconv.pack_weight(wr.to(torch.bfloat16)), br, plain)
        y.backward(gy)
        grads.append((y.float(), xr.grad.float(), wr.grad, br.grad))
    for k, p in zip(grads[0], grads[1]):
        assert ((k - p).abs() <= _bf16_step_tol(p)).all()


@pytest.mark.parametrize("shape, cin, cout", [((1, 3, 5, 7), 32, 32), ((2, 4, 3, 10), 64, 128),
                                              ((1, 5, 7, 33), 96, 96), ((1, 2, 2, 3), 256, 64),
                                              ((1, 6, 4, 32), 128, 128)])
def test_conv3x3_kernel_matches_plain(dev, shape, cin, cout):
    """The dense-K conv, every cout template, ragged voxel counts: one bf16
    rounding of f32 sums taken in another order."""
    g = torch.Generator(device="cpu").manual_seed(cin + cout + shape[-1])
    x = torch.randn(*shape, cin, generator=g).to(dev, torch.bfloat16)
    w = torch.randn(cout, cin, 3, 3, 3, generator=g) * math.sqrt(2.0 / (27 * cin))
    b = torch.randn(cout, generator=g).to(dev)
    wt = wconv.pack_weight(w.to(dev, torch.bfloat16))
    before = conv3x3.conv3d.launches
    y = conv3x3.conv3d(x, wt, b)
    torch.cuda.synchronize()
    assert conv3x3.conv3d.launches == before + 1 and y.shape == (*shape, cout)
    p = conv3x3.conv3d_plain(x, wt, b).float()
    assert ((y.float() - p).abs() <= _bf16_step_tol(p)).all()


def test_conv3x3_autograd_function_on_the_card(dev):
    """Conv3x3Fn through the kernel against the same Function on the plain
    version: the forward to one bf16 step; the gradients, PyTorch's conv
    gradients on both sides of the same operands, to one bf16 step of a sum
    order cuDNN may choose anew."""
    g = torch.Generator(device="cpu").manual_seed(6)
    x = torch.randn(1, 4, 6, 32, 64, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(128, 64, 3, 3, 3, generator=g) * 0.03).to(dev)
    b = torch.randn(128, generator=g).to(dev)
    gy = torch.randn(1, 4, 6, 32, 128, generator=g).to(dev, torch.bfloat16)
    outs = []
    for plain in (False, True):
        xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))
        y = conv3x3.Conv3x3Fn.apply(xr, wconv.pack_weight(wr.to(torch.bfloat16)), br, plain)
        y.backward(gy)
        outs.append((y.float(), xr.grad, wr.grad, br.grad))
    for k, p in zip(outs[0], outs[1]):
        assert ((k.float() - p.float()).abs() <= _bf16_step_tol(p.float())).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 7, 64), (2, 1000, 128), (3, 333, 256), (1, 5, 8),
                                   (1, 144, 512)])
@pytest.mark.parametrize("act", [None, "relu", "leaky"])
def test_inorm_backward_kernels_match_plain(dev, dtype, shape, act):
    """pair_sums_gy within 1e-5 of f64 sums of magnitudes; bwd_map and the
    map, with and without the pre-activation kept, bit-equal to their plain
    versions."""
    g = torch.Generator(device="cpu").manual_seed(shape[1] + 3)
    x = (torch.randn(*shape, generator=g) * 2 + 0.5).to(dev, dtype)
    gy = torch.randn(*shape, generator=g).to(dev, dtype)
    scale, shift = inorm.norm_coefficients(inorm.pair_sums(x), shape[1])
    pre, y = inorm.affine_map_act(x, scale, shift, act, keep_pre=True)
    pre_p, y_p = inorm.affine_map_act_plain(x, scale, shift, act, keep_pre=True)
    assert torch.equal(pre, pre_p) and torch.equal(y, y_p)
    assert torch.equal(inorm.affine_map_act(x, scale, shift, act), y_p)
    s = inorm.pair_sums_gy(gy, pre, act)
    gd = inorm.act_grad_plain(gy.double(), pre.double(), act)
    ref = torch.stack([gd.sum(1), (gd * pre.double()).sum(1)], 1)
    mag = torch.stack([gd.abs().sum(1), (gd * pre.double()).abs().sum(1)], 1)
    assert ((s.double() - ref).abs() <= 1e-5 * mag + 1e-30).all()
    mg = (s[:, 0] / shape[1]).contiguous()
    mgy = (s[:, 1] / shape[1]).contiguous()
    dx = inorm.bwd_map(gy, pre, scale, mg, mgy, act)
    assert torch.equal(dx, inorm.bwd_map_plain(gy, pre, scale, mg, mgy, act))


@pytest.mark.parametrize("act", [None, "relu", "leaky"])
def test_instance_norm_function_on_the_card(dev, act):
    """InstanceNormFn through the kernels against the same Function on the
    plain versions, f32: the forward bit-equal, the input gradient to f32
    rounding of sums taken in another order."""
    g = torch.Generator(device="cpu").manual_seed(9)
    x = (torch.randn(2, 6, 5, 4, 128, generator=g) * 3 + 1).to(dev)
    gy = torch.randn(2, 6, 5, 4, 128, generator=g).to(dev)
    outs = []
    for plain in (False, True):
        xr = x.clone().requires_grad_(True)
        y = inorm.InstanceNormFn.apply(xr, act, plain)
        y.backward(gy)
        outs.append((y, xr.grad))
    assert torch.allclose(outs[0][0], outs[1][0], rtol=1e-5, atol=1e-5)
    assert torch.allclose(outs[0][1], outs[1][1], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 7, 64), (2, 1000, 128), (3, 333, 256), (1, 5, 8)])
def test_inorm_kernels_match_plain(dev, dtype, shape):
    g = torch.Generator(device="cpu").manual_seed(shape[1])
    x = (torch.randn(*shape, generator=g) * 2 + 0.5).to(dev, dtype)
    s = inorm.pair_sums(x)
    xd = x.double()
    ref = torch.stack([xd.sum(1), (xd * xd).sum(1)], 1)
    mag = torch.stack([xd.abs().sum(1), (xd * xd).sum(1)], 1)
    assert ((s.double() - ref).abs() <= 1e-5 * mag).all()
    scale, shift = inorm.norm_coefficients(s, shape[1])
    for act in (None, "relu"):
        y = inorm.affine_map_act(x, scale, shift, act)
        assert torch.equal(y, inorm.affine_map_act_plain(x, scale, shift, act))


def test_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros((1, 4, 4, 6, 64), dtype=torch.float32, device=dev)
    wt = torch.zeros((27, 64, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(TypeError):
        wconv.conv3d(x, wt, torch.zeros(64, device=dev))       # f32 input
    with pytest.raises(ValueError):
        inorm.pair_sums(torch.zeros((1, 10, 12), device=dev))  # C = 12
    before = conv3x3.conv3d.launches
    with pytest.raises(ValueError):                            # cout 160
        conv3x3.conv3d(x.to(torch.bfloat16), torch.zeros((27, 160, 64), dtype=torch.bfloat16,
                                                         device=dev))
    assert conv3x3.conv3d.launches == before
