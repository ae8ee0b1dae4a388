"""Generator twins of ``neuroclear_tpu/nn/generators.py``: ``ConvBlock``
(its plain path), ``UNetDeconv``, the production generator,
``DeepLinearGenerator``, the production backward generator of the Apollo
cycle, and the rest of the zoo: ``UNetVanilla``, ``LinearKernel`` (and
``double``), ``LinearKernelNC``, ``FixedLinearKernel``, ``ResnetGenerator``
(2D), ``VGGNet`` (2D classifier) and ``UNetTwoOuts`` (two heads).  Module
names are the JAX package's parameter paths.

``plain=True`` builds the same network on the kernels' plain PyTorch
versions, whatever the device: the reference a run on the card is held
against.

``remat=True`` in a forward call recomputes activations in the backward pass
(``torch.utils.checkpoint``, non-reentrant) at the JAX package's boundaries
(``nn/generators.py``, ``UNetDeconv.remat``): each conv -> norm -> ReLU unit
of a ``ConvBlock``, and each block of the U-Net with its skip concatenation
inside, so that the saved residuals are the two halves and one block's
interior is alive at a time.  The forward values, and so the gradients, are
the same bits as without it: the recomputation runs the same operations on
the same inputs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .core import Conv, ConvTranspose, Linear, max_pool, reflect_pad, resize_linear, sigmoid
from .norms import get_norm_spec


def checkpointed(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward pass
    (only its inputs are kept).  The nets draw no random numbers, so no RNG
    state is stashed."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def _direct(fn, *args):
    return fn(*args)


class ConvBlock(nn.Module):
    """n x (conv k s1 -> norm -> ReLU): the instance norm with the ReLU fused
    (the norm kernels), batch or no norm as conv -> norm -> ReLU."""

    def __init__(self, in_c: int, out_c: int, n: int, norm: str = "instance",
                 plain: bool = False, k: int = 3, pad: int = 1):
        super().__init__()
        spec = get_norm_spec(norm)
        self.n = n
        for i in range(n):
            self.add_module(f"conv{i}", Conv(in_c if i == 0 else out_c, out_c, k, 1, pad,
                                             plain=plain))
            self.add_module(f"norm{i}", spec.layer(out_c, "relu", plain=plain))

    def unit(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(x))

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """With ``remat`` each unit is recomputed in the backward pass."""
        ck = checkpointed if remat else _direct
        for i in range(self.n):
            x = ck(functools.partial(self.unit, i), x)
        return x


class UNetDeconv(nn.Module):
    """2-level 3D U-Net with transposed-conv upsampling and a sigmoid head
    (``nn/generators.py:129-207``).  Channel plan for input_nc=1: 64 -> 128
    -> (bottom 256) -> 128 -> 64 -> 1x1x1 -> 1x1x1 -> sigmoid."""

    def __init__(self, input_nc: int, output_nc: int, norm: str = "instance",
                 plain: bool = False):
        super().__init__()
        s = input_nc * 64
        self.double_conv1 = ConvBlock(input_nc, s, 2, norm, plain)
        self.double_conv2 = ConvBlock(s, s * 2, 2, norm, plain)
        self.bottom_layer = ConvBlock(s * 2, s * 4, 3, norm, plain)
        self.t_conv2 = ConvTranspose(s * 4, s * 2, 2, 2)
        self.ex_double_conv2 = ConvBlock(s * 4, s * 2, 2, norm, plain)
        self.t_conv1 = ConvTranspose(s * 2, s, 2, 2)
        self.ex_conv1_1 = ConvBlock(s * 2, s, 1, norm, plain)
        self.one_by_one = Conv(s, output_nc, 1, 1, 0)
        self.one_by_one_2 = Conv(output_nc, output_nc, 1, 1, 0)

    # gan_common.maybe_remat: this net recomputes per block, not whole
    block_remat = True

    @staticmethod
    def _skip(block: ConvBlock, remat: bool, skip: torch.Tensor,
              up: torch.Tensor) -> torch.Tensor:
        return block(torch.cat([skip, up], dim=-1), remat=remat)

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """x: (N, D, H, W, input_nc), D, H and W multiples of 4.  With
        ``remat`` each block, and each unit inside it, is recomputed in the
        backward pass."""
        ck = checkpointed if remat else _direct
        conv1 = ck(functools.partial(self.double_conv1, remat=remat), x)
        conv2 = ck(functools.partial(self.double_conv2, remat=remat), max_pool(conv1, 2))
        bottom = ck(functools.partial(self.bottom_layer, remat=remat), max_pool(conv2, 2))
        ex2 = ck(functools.partial(self._skip, self.ex_double_conv2, remat), conv2,
                 self.t_conv2(bottom))
        ex1 = ck(functools.partial(self._skip, self.ex_conv1_1, remat), conv1,
                 self.t_conv1(ex2))
        return sigmoid(self.one_by_one_2(self.one_by_one(ex1)))


class DeepLinearGenerator(nn.Module):
    """KernelGAN-style purely linear 3D conv stack, no activations, no bias
    (``nn/generators.py:270-302``): k7 (p3) -> k5 (p2) -> k3 (p1) at 64
    channels, then 1x1x1 64 -> 32 -> 16 -> output_nc.  In bf16 ``feat1``
    (3x3x3, 64 -> 64) passes the W-pair gate and runs the hand kernel with a
    zero bias."""

    def __init__(self, input_nc: int, output_nc: int, plain: bool = False):
        super().__init__()
        c = input_nc * 64
        for name, (cin, cout, k, pad) in (("first_layer", (input_nc, c, 7, 3)),
                                          ("feat0", (c, c, 5, 2)),
                                          ("feat1", (c, c, 3, 1)),
                                          ("feat2", (c, c // 2, 1, 0)),
                                          ("feat3", (c // 2, c // 4, 1, 0)),
                                          ("final_layer", (c // 4, output_nc, 1, 0))):
            self.add_module(name, Conv(cin, cout, k, 1, pad, bias=False, plain=plain))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x


def check_multiple(x: torch.Tensor, m: int, net: str) -> None:
    """ValueError unless every spatial dim of ``x`` is a multiple of ``m``
    (where the JAX package's skip concatenation fails on the shapes)."""
    spatial = tuple(x.shape[1:-1])
    if any(s % m for s in spatial):
        raise ValueError(f"{net} pools {m.bit_length() - 1} times: its input's spatial dims "
                         f"{spatial} must be multiples of {m} (e.g. 112^3 crops, 144^3 tiles)")


class UNetVanilla(nn.Module):
    """3-level 3D U-Net (``nn/generators.py:216-262``): 64 -> 128 -> 256 ->
    (bottom 512) -> 256 -> 128 -> 64 -> 1x1x1 -> sigmoid, two units per
    block.  In bf16 ``double_conv1.conv1`` and ``ex_conv1_1.conv0/conv1``
    pass the W-pair conv's gate.  It has no per-block remat
    (``gan_common.maybe_remat`` recomputes it whole, as the JAX package's
    ``jax.checkpoint`` fallback)."""

    def __init__(self, input_nc: int, output_nc: int, norm: str = "instance",
                 plain: bool = False):
        super().__init__()
        s = input_nc * 64
        self.double_conv1 = ConvBlock(input_nc, s, 2, norm, plain)
        self.double_conv2 = ConvBlock(s, s * 2, 2, norm, plain)
        self.double_conv3 = ConvBlock(s * 2, s * 4, 2, norm, plain)
        self.bottom_layer = ConvBlock(s * 4, s * 8, 2, norm, plain)
        self.t_conv3 = ConvTranspose(s * 8, s * 4, 2, 2)
        self.ex_double_conv3 = ConvBlock(s * 8, s * 4, 2, norm, plain)
        self.t_conv2 = ConvTranspose(s * 4, s * 2, 2, 2)
        self.ex_double_conv2 = ConvBlock(s * 4, s * 2, 2, norm, plain)
        self.t_conv1 = ConvTranspose(s * 2, s, 2, 2)
        self.ex_conv1_1 = ConvBlock(s * 2, s, 2, norm, plain)
        self.one_by_one = Conv(s, output_nc, 1, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, D, H, W, input_nc), D, H and W multiples of 8."""
        check_multiple(x, 8, "UNetVanilla")
        conv1 = self.double_conv1(x)
        conv2 = self.double_conv2(max_pool(conv1, 2))
        conv3 = self.double_conv3(max_pool(conv2, 2))
        bottom = self.bottom_layer(max_pool(conv3, 2))
        x3 = self.ex_double_conv3(torch.cat([conv3, self.t_conv3(bottom)], dim=-1))
        x2 = self.ex_double_conv2(torch.cat([conv2, self.t_conv2(x3)], dim=-1))
        x1 = self.ex_conv1_1(torch.cat([conv1, self.t_conv1(x2)], dim=-1))
        return sigmoid(self.one_by_one(x1))


def _same_pad(kernel_size: int) -> int:
    """``int(round((k - 1) / 2))`` of the JAX package (round half to even)."""
    return int(round((kernel_size - 1) / 2))


class LinearKernel(nn.Module):
    """One learned bias-free conv of ``kernel_size`` (same size), applied
    twice when ``double`` (``nn/generators.py:311-332``)."""

    def __init__(self, input_nc: int, output_nc: int, kernel_size: int, dim: int = 3,
                 double: bool = False, plain: bool = False):
        super().__init__()
        self.double = double
        self.convlayer = Conv(input_nc, output_nc, kernel_size, 1, _same_pad(kernel_size),
                              bias=False, plain=plain, dim=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.convlayer(x)
        return self.convlayer(y) if self.double else y


class LinearKernelNC(nn.Module):
    """A blur conv and a noise conv on the same input, summed
    (``nn/generators.py:336-357``)."""

    def __init__(self, input_nc: int, output_nc: int, kernel_size: int, dim: int = 3,
                 plain: bool = False):
        super().__init__()
        pad = _same_pad(kernel_size)
        self.blur_convlayer = Conv(input_nc, output_nc, kernel_size, 1, pad, bias=False,
                                   plain=plain, dim=dim)
        self.noise_convlayer = Conv(input_nc, output_nc, kernel_size, 1, pad, bias=False,
                                    plain=plain, dim=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blur_convlayer(x) + self.noise_convlayer(x)


def _minmax01(x: torch.Tensor) -> torch.Tensor:
    lo, hi = x.min(), x.max()
    return (x - lo) / torch.clamp(hi - lo, min=1e-12)


class FixedLinearKernel(nn.Module):
    """A frozen PSF conv, then Gaussian and Poisson noise
    (``nn/generators.py:361-402``).  The PSF is the buffer ``psf`` in the
    JAX layout (k..., I, O), set by ``init_from_psf``; an even kernel is
    over-padded by one and cropped to its centre.  The noise is drawn from
    an explicit ``torch.Generator`` (the JAX package draws it from a PRNG
    key, so the two agree in distribution, not in samples): N(0, sigma),
    min-max to [0, 1], Poisson(y * peak) / peak, min-max again."""

    def __init__(self, kernel_shape, gau_sigma: float, poisson_peak: float, dim: int = 3):
        super().__init__()
        self.gau_sigma, self.poisson_peak, self.dim = gau_sigma, poisson_peak, dim
        self.register_buffer("psf", torch.zeros(tuple(kernel_shape) + (1, 1)))

    def init_from_psf(self, psf) -> None:
        """Take a raw (k...) PSF or one in torch's (O, I, k...) layout."""
        psf = np.asarray(psf, np.float32)
        if psf.ndim == self.dim:
            psf = psf[..., None, None]
        elif psf.ndim == self.dim + 2:  # (O, I, k...) -> (k..., I, O)
            psf = np.moveaxis(psf, (0, 1), (-1, -2))
        self.psf = torch.from_numpy(np.ascontiguousarray(psf)).to(self.psf.device)

    def forward(self, x: torch.Tensor, generator: torch.Generator = None) -> torch.Tensor:
        k = tuple(self.psf.shape[:self.dim])
        w = Conv.weight_from_jax(self.psf).to(x.dtype)
        conv = F.conv3d if self.dim == 3 else F.conv2d
        y = conv(x.movedim(-1, 1), w, None, 1, tuple(_same_pad(kk) for kk in k))
        y = y.movedim(1, -1)
        if k[-1] % 2 == 0:  # even kernels over-pad by one; centre-crop
            y = y[(slice(None),) + (slice(1, None),) * self.dim]
        y = y.contiguous()
        if generator is not None:
            noise = torch.randn(y.shape, generator=generator, device=generator.device)
            y = _minmax01(y + noise.to(y.device, y.dtype) * self.gau_sigma)
            rate = (y * self.poisson_peak).float()
            y = torch.poisson(rate.to(generator.device), generator=generator).to(y.device, y.dtype)
            y = _minmax01(y / self.poisson_peak)
        return y


class ResnetGenerator(nn.Module):
    """The 2D ResNet template (``nn/generators.py:416-498``): reflect pad 3,
    k7 head, two stride-2 downsamplings, ``n_blocks`` residual blocks
    (reflect-padded k3 convs), two k3 stride-2 transposed convs, reflect pad
    3, k7 tail, sigmoid.  Convs before a norm have a bias only under the
    instance norm, as in JAX."""

    def __init__(self, input_nc: int, output_nc: int, ngf: int = 64, norm: str = "instance",
                 n_blocks: int = 6, plain: bool = False):
        super().__init__()
        spec = get_norm_spec(norm, 2)
        use_bias = norm == "instance"
        self.n_blocks = n_blocks

        def conv(cin, cout, k, stride=1, pad=0, bias=use_bias):
            return Conv(cin, cout, k, stride, pad, bias=bias, plain=plain, dim=2)

        self.head = conv(input_nc, ngf, 7)
        self.head_norm = spec.layer(ngf, "relu", plain=plain)
        for i in range(2):
            c = ngf * 2 ** i
            self.add_module(f"down{i}", conv(c, c * 2, 3, 2, 1))
            self.add_module(f"down{i}_norm", spec.layer(c * 2, "relu", plain=plain))
        c = ngf * 4
        for i in range(n_blocks):
            self.add_module(f"block{i}_conv0", conv(c, c, 3))
            self.add_module(f"block{i}_norm0", spec.layer(c, "relu", plain=plain))
            self.add_module(f"block{i}_conv1", conv(c, c, 3))
            self.add_module(f"block{i}_norm1", spec.layer(c, None, plain=plain))
        for i in range(2):
            c = ngf * 2 ** (2 - i)
            self.add_module(f"up{i}", ConvTranspose(c, c // 2, 3, 2, bias=use_bias, dim=2,
                                                    padding=1, output_padding=1))
            self.add_module(f"up{i}_norm", spec.layer(c // 2, "relu", plain=plain))
        self.tail = conv(ngf, output_nc, 7, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, input_nc)."""
        x = self.head_norm(self.head(reflect_pad(x, 3)))
        for i in range(2):
            x = getattr(self, f"down{i}_norm")(getattr(self, f"down{i}")(x))
        for i in range(self.n_blocks):
            h = getattr(self, f"block{i}_norm0")(getattr(self, f"block{i}_conv0")(
                reflect_pad(x, 1)))
            h = getattr(self, f"block{i}_norm1")(getattr(self, f"block{i}_conv1")(
                reflect_pad(h, 1)))
            x = x + h
        for i in range(2):
            x = getattr(self, f"up{i}_norm")(getattr(self, f"up{i}")(x))
        return sigmoid(self.tail(reflect_pad(x, 3)))


VGG_TYPES = {
    "VGG11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "VGG13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "VGG16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512, "M"],
    "VGG19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512,
              "M", 512, 512, 512, 512, "M"],
}


class VGGNet(nn.Module):
    """The 2D VGG classifier (``nn/generators.py:516-554``): k3 convs, each
    with a batch norm (whatever ``--norm`` says) and a ReLU, 2x2 max pools,
    the linear resize to 7x7 (``resize_linear``), then fc 25088 -> 4096 ->
    4096 -> ``num_classes`` with ReLUs between."""

    def __init__(self, input_nc: int, num_classes: int = 2, vgg_type: str = "VGG16",
                 plain: bool = False):
        super().__init__()
        self.plan = VGG_TYPES[vgg_type]
        spec = get_norm_spec("batch", 2)
        in_c, ci = input_nc, 0
        for c in self.plan:
            if c == "M":
                continue
            self.add_module(f"conv{ci}", Conv(in_c, c, 3, 1, 1, plain=plain, dim=2))
            self.add_module(f"bn{ci}", spec.layer(c, "relu"))
            in_c, ci = c, ci + 1
        self.fc0 = Linear(512 * 7 * 7, 4096)
        self.fc1 = Linear(4096, 4096)
        self.fc2 = Linear(4096, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, input_nc) -> (N, num_classes) logits."""
        ci = 0
        for c in self.plan:
            if c == "M":
                x = max_pool(x, 2, 2)
                continue
            x = getattr(self, f"bn{ci}")(getattr(self, f"conv{ci}")(x))
            ci += 1
        x = resize_linear(x, (7, 7)).reshape(x.shape[0], -1)
        x = torch.relu(self.fc0(x))
        x = torch.relu(self.fc1(x))
        return self.fc2(x)


class UNetTwoOuts(nn.Module):
    """The two-head 3D U-Net (``nn/generators.py:569-615``), batch norm
    whatever ``--norm`` says, as the JAX package builds it; ``input_nc`` is
    the channel multiplier (the first conv is 1 -> input_nc).  Returns
    (``one_by_one``, ``one_by_one_2``), the second a k1 conv block."""

    def __init__(self, input_nc: int, output_nc: int, plain: bool = False):
        super().__init__()
        c = input_nc
        self.double_conv1 = ConvBlock(1, c, 2, "batch", plain)
        self.double_conv2 = ConvBlock(c, c * 2, 2, "batch", plain)
        self.double_conv3 = ConvBlock(c * 2, c * 4, 2, "batch", plain)
        self.double_conv5 = ConvBlock(c * 4, c * 8, 2, "batch", plain)
        self.t_conv3 = ConvTranspose(c * 8, c * 4, 2, 2)
        self.ex_double_conv3 = ConvBlock(c * 8, c * 4, 2, "batch", plain)
        self.t_conv2 = ConvTranspose(c * 4, c * 2, 2, 2)
        self.ex_double_conv2 = ConvBlock(c * 4, c * 2, 2, "batch", plain)
        self.t_conv1 = ConvTranspose(c * 2, c, 2, 2)
        self.ex_double_conv1 = ConvBlock(c * 2, c, 2, "batch", plain)
        self.one_by_one = Conv(c, output_nc, 1, 1, 0)
        self.one_by_one_2 = ConvBlock(c, 1, 2, "batch", plain, k=1, pad=0)

    def forward(self, x: torch.Tensor):
        check_multiple(x, 8, "UNetTwoOuts")
        conv1 = self.double_conv1(x)
        conv2 = self.double_conv2(max_pool(conv1, 2))
        conv3 = self.double_conv3(max_pool(conv2, 2))
        conv5 = self.double_conv5(max_pool(conv3, 2))
        x3 = self.ex_double_conv3(torch.cat([conv3, self.t_conv3(conv5)], dim=-1))
        x2 = self.ex_double_conv2(torch.cat([conv2, self.t_conv2(x3)], dim=-1))
        x1 = self.ex_double_conv1(torch.cat([conv1, self.t_conv1(x2)], dim=-1))
        return self.one_by_one(x1), self.one_by_one_2(x1)
