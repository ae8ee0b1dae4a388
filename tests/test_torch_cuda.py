"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes with ragged edges (the full-width shapes run in
chip_smoke.py).  Marked ``cuda``: they skip without a card.  On a machine
with the card and no JAX, run them without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from neuroclear_tpu_torch.ops import inorm, wconv

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
