"""Discriminator twins of ``neuroclear_tpu/nn/discriminators.py``: the
production PatchGAN, ``NLayerDiscriminator`` without spectral norm."""

from __future__ import annotations

import torch
from torch import nn

from .core import Conv, leaky_relu, sigmoid
from .norms import get_norm_spec


class NLayerDiscriminator(nn.Module):
    """PatchGAN (``nn/discriminators.py:24-83``): k4 convs, stride 2 for
    conv0 .. conv{n_layers-1}, stride 1 for conv{n_layers} and conv_out,
    padding 1; an instance norm after conv1 .. conv{n_layers} with the
    LeakyReLU(0.2) fused, a plain LeakyReLU(0.2) after conv0.  Channels-last
    (N, H, W, C) for dim 2."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 norm: str = "instance", use_sigmoid: bool = False, dim: int = 2,
                 plain: bool = False):
        super().__init__()
        spec = get_norm_spec(norm, dim)
        self.n_layers, self.use_sigmoid = n_layers, use_sigmoid

        def conv(cin, cout, stride, bias=True):
            return Conv(cin, cout, 4, stride, 1, bias=bias, plain=plain, dim=dim)

        self.conv0 = conv(input_nc, ndf, 2)
        nf = 1
        for n in range(1, n_layers + 1):
            nf_prev, nf = nf, min(2 ** n, 8)
            self.add_module(f"conv{n}", conv(ndf * nf_prev, ndf * nf,
                                             2 if n < n_layers else 1))
            self.add_module(f"norm{n}", spec.layer("leaky", plain=plain))
        self.conv_out = conv(ndf * nf, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = leaky_relu(self.conv0(x))
        for n in range(1, self.n_layers + 1):
            x = getattr(self, f"norm{n}")(getattr(self, f"conv{n}")(x))
        x = self.conv_out(x)
        return sigmoid(x) if self.use_sigmoid else x
