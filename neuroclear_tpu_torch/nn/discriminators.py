"""Discriminator twins of ``neuroclear_tpu/nn/discriminators.py``: the
PatchGAN ``NLayerDiscriminator`` (the production netD, and with
``spectral=True`` the ``*_SN`` variants), ``KernelPatchDiscriminator`` and
``PixelDiscriminator``.  Channels-last (N, H, W, C) for dim 2.

Module names are the JAX package's parameter paths, except the PatchGAN's
norms: the port names them ``norm{n}``, the JAX package ``conv{n}_norm``
(``jax_paths`` maps them for the weight carry, ``utils/weights.py``)."""

from __future__ import annotations

import torch
from torch import nn

from .core import Conv, leaky_relu, sigmoid
from .norms import NoNorm, get_norm_spec


class NLayerDiscriminator(nn.Module):
    """PatchGAN (``nn/discriminators.py:24-83``): k4 convs, stride 2 for
    conv0 .. conv{n_layers-1}, stride 1 for conv{n_layers} and conv_out,
    padding 1; a norm after conv1 .. conv{n_layers} with the LeakyReLU(0.2)
    after it (fused for the instance norm), a plain LeakyReLU(0.2) after
    conv0.  conv1 .. conv{n_layers} have a bias only under the instance
    norm.  With ``spectral`` every conv runs on its spectrally normalised
    weight (``Conv.spectral_weight``), no norm and no bias but conv0's and
    conv_out's."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 norm: str = "instance", use_sigmoid: bool = False, dim: int = 2,
                 plain: bool = False, spectral: bool = False):
        super().__init__()
        spec = get_norm_spec(norm, dim)
        self.n_layers, self.use_sigmoid = n_layers, use_sigmoid
        use_bias = norm == "instance" and not spectral

        def conv(cin, cout, stride, bias=True):
            return Conv(cin, cout, 4, stride, 1, bias=bias, plain=plain, dim=dim,
                        spectral=spectral)

        self.conv0 = conv(input_nc, ndf, 2)
        nf = 1
        self.jax_paths = {}
        for n in range(1, n_layers + 1):
            nf_prev, nf = nf, min(2 ** n, 8)
            self.add_module(f"conv{n}", conv(ndf * nf_prev, ndf * nf,
                                             2 if n < n_layers else 1, use_bias))
            self.add_module(f"norm{n}", NoNorm("leaky") if spectral
                            else spec.layer(ndf * nf, "leaky", plain=plain))
            self.jax_paths[f"norm{n}"] = f"conv{n}_norm"
        self.conv_out = conv(ndf * nf, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = leaky_relu(self.conv0(x))
        for n in range(1, self.n_layers + 1):
            x = getattr(self, f"norm{n}")(getattr(self, f"conv{n}")(x))
        x = self.conv_out(x)
        return sigmoid(x) if self.use_sigmoid else x


class KernelPatchDiscriminator(nn.Module):
    """KernelGAN's PatchGAN (``nn/discriminators.py:106-142``): a k7 VALID
    head without activation, (n_layers - 2) x [1x1 conv, norm, ReLU], a 1x1
    output; every conv has a bias only under the instance norm."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 5,
                 norm: str = "instance", dim: int = 2, plain: bool = False):
        super().__init__()
        spec = get_norm_spec(norm, dim)
        use_bias = norm == "instance"
        self.n_feat = n_layers - 2
        self.first_layer = Conv(input_nc, ndf, 7, 1, 0, bias=use_bias, plain=plain, dim=dim)
        for i in range(self.n_feat):
            self.add_module(f"feat{i}", Conv(ndf, ndf, 1, 1, 0, bias=use_bias, plain=plain,
                                             dim=dim))
            self.add_module(f"feat{i}_norm", spec.layer(ndf, "relu", plain=plain))
        self.final_layer = Conv(ndf, 1, 1, 1, 0, bias=use_bias, plain=plain, dim=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.first_layer(x)
        for i in range(self.n_feat):
            x = getattr(self, f"feat{i}_norm")(getattr(self, f"feat{i}")(x))
        return self.final_layer(x)


class PixelDiscriminator(nn.Module):
    """1x1 PixelGAN (``nn/discriminators.py:146-175``): conv0 (bias),
    LeakyReLU(0.2), conv1, norm, LeakyReLU(0.2), conv2 -> 1 channel; conv1
    and conv2 have a bias only under the instance norm."""

    def __init__(self, input_nc: int, ndf: int = 64, norm: str = "instance", dim: int = 2,
                 plain: bool = False):
        super().__init__()
        spec = get_norm_spec(norm, dim)
        use_bias = norm == "instance"
        self.conv0 = Conv(input_nc, ndf, 1, 1, 0, plain=plain, dim=dim)
        self.conv1 = Conv(ndf, ndf * 2, 1, 1, 0, bias=use_bias, plain=plain, dim=dim)
        self.norm1 = spec.layer(ndf * 2, "leaky", plain=plain)
        self.conv2 = Conv(ndf * 2, 1, 1, 1, 0, bias=use_bias, plain=plain, dim=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = leaky_relu(self.conv0(x))
        return self.conv2(self.norm1(self.conv1(x)))
