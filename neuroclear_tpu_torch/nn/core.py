"""Layer twins of ``neuroclear_tpu/nn/core.py``.

Activations are channels-last (N, D, H, W, C) or (N, H, W, C) tensors, as
in the JAX package.  Weights are stored in PyTorch's layouts: (O, I, k...)
for a conv, (I, O, k, k, k) for a transposed conv; ``weight_from_jax``
converts a JAX checkpoint's (k..., I, O) array and ``weight_to_jax`` converts
back.  Convs outside the W-pair kernel's gate, or inside it with its
switch (``wconv.ENABLED``) off, run through ``F.conv3d`` or ``F.conv2d`` on
a channels-last view, as the JAX package leaves them to XLA's convolution;
inside the gate, ``wconv.WConvFn`` carries the gradients through the hand
kernels when one is needed.  With
``NEUROCLEAR_PALLAS_CONV=1``, bf16 convs outside that gate and inside
``conv3x3.supported`` go to the dense-K conv kernel, as the JAX package
routes them to ``pallas_conv.conv3d_3x3``.  On the card a
float32 conv matches the JAX package only with TF32 off
(``torch.backends.cudnn.allow_tf32 = False``), the same trap as XLA's
DEFAULT precision (``nn/core.py:94-100``); the entry points turn it off.

Beyond the U-Net's layers, the rest of the network zoo needs 2D transposed
convs with k 3 (``ConvTranspose``'s ``padding``/``output_padding``), the
reflect pad, the 2D max pool, a linear layer (``Linear``) and the twin of
``jax.image.resize(..., "linear")`` (``resize_linear``).  A ``Conv`` built
with ``spectral=True`` holds the power-iteration vector ``u`` as a buffer
and runs on ``w / sigma`` (``spectral_weight``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv3x3, inorm, wconv


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    """(N, *spatial, C) -> an (N, C, *spatial) view."""
    return x.movedim(-1, 1)


def _channels_last(y: torch.Tensor) -> torch.Tensor:
    return y.movedim(1, -1).contiguous()


class Conv(nn.Module):
    """2D or 3D conv with torch-style symmetric integer padding.  bf16 3x3x3
    convs inside ``wconv.supported``, with ``wconv.ENABLED``, go to the
    W-pair kernel (its plain version when ``plain``), through
    ``wconv.WConvFn`` when a gradient is needed; then, in the order of the
    JAX package's ``Conv.apply``, those inside ``conv3x3.supported`` go to
    the dense-K kernel the same way, through ``conv3x3.Conv3x3Fn``."""

    def __init__(self, in_c: int, out_c: int, k: int, stride: int = 1, pad: int = 0,
                 bias: bool = True, plain: bool = False, dim: int = 3,
                 spectral: bool = False):
        super().__init__()
        if dim not in (2, 3):
            raise ValueError(f"conv dim {dim}: the port has 2 and 3")
        self.in_c, self.out_c, self.k, self.stride, self.pad = in_c, out_c, k, stride, pad
        self.plain, self.dim, self.spectral = plain, dim, spectral
        self.weight = nn.Parameter(torch.zeros((out_c, in_c) + (k,) * dim))
        self.bias = nn.Parameter(torch.zeros(out_c)) if bias else None
        if spectral:
            self.register_buffer("u", torch.zeros(out_c))

    @staticmethod
    def weight_from_jax(w) -> torch.Tensor:
        """(k..., I, O) -> (O, I, k...)."""
        w = torch.as_tensor(w)
        return w.permute(w.dim() - 1, w.dim() - 2, *range(w.dim() - 2))

    @staticmethod
    def weight_to_jax(w: torch.Tensor) -> torch.Tensor:
        """(O, I, k...) -> (k..., I, O)."""
        return w.permute(*range(2, w.dim()), 1, 0)

    def spectral_weight(self, n_iter: int = 3) -> torch.Tensor:
        """``_spectral_normalise`` of the JAX package: ``n_iter`` power
        iterations from the stored ``u`` on every call (``u`` is never
        updated), then ``w / sigma`` with sigma a constant to the gradient."""
        with torch.no_grad():
            wm = self.weight.reshape(self.out_c, -1)
            u = self.u
            for _ in range(n_iter):
                v = wm.t() @ u
                v = v / (torch.linalg.vector_norm(v) + 1e-12)
                u = wm @ v
                u = u / (torch.linalg.vector_norm(u) + 1e-12)
            sigma = u @ (wm @ v)
        return self.weight / sigma

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.spectral_weight() if self.spectral else self.weight
        if x.dtype == torch.bfloat16:
            gate = (self.in_c, self.out_c, self.k, self.stride, self.pad, self.dim)
            if wconv.ENABLED and wconv.supported(x.shape, *gate):
                return self._hand_conv(x, w, wconv.WConvFn, wconv.conv3d, wconv.conv3d_plain)
            if conv3x3.supported(x.shape, *gate):
                return self._hand_conv(x, w, conv3x3.Conv3x3Fn, conv3x3.conv3d,
                                       conv3x3.conv3d_plain)
        conv = F.conv3d if self.dim == 3 else F.conv2d
        y = _channels_last(conv(_channels_first(x), w.to(x.dtype), None, self.stride,
                                self.pad))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    def _hand_conv(self, x, w, autograd_fn, kernel, plain):
        """A hand conv on the packed weights ``w`` and the f32 bias: through
        ``autograd_fn`` when a gradient is needed, else the kernel wrapper
        (its plain version when ``self.plain``)."""
        wt = wconv.pack_weight(w.to(x.dtype))
        bias = (self.bias if self.bias is not None
                else torch.zeros(self.out_c, device=x.device)).float().contiguous()
        if torch.is_grad_enabled() and (x.requires_grad or wt.requires_grad
                                        or bias.requires_grad):
            return autograd_fn.apply(x.contiguous(), wt, bias, self.plain)
        return (plain if self.plain else kernel)(x.contiguous(), wt, bias)


class ConvTranspose(nn.Module):
    """nn.ConvTranspose{2,3}d(in, out, k, stride, padding, output_padding)
    semantics.  The U-Nets use k == stride == 2; ``ResnetGenerator`` k 3,
    stride 2, whose VALID transpose with the first row cropped
    (``generators.py``) is padding 1, output_padding 1.  The JAX package
    stores the kernel in torch's orientation and flips it in its apply."""

    def __init__(self, in_c: int, out_c: int, k: int, stride: int, bias: bool = True,
                 dim: int = 3, padding: int = 0, output_padding: int = 0):
        super().__init__()
        self.stride, self.dim = stride, dim
        self.padding, self.output_padding = padding, output_padding
        self.weight = nn.Parameter(torch.zeros((in_c, out_c) + (k,) * dim))
        self.bias = nn.Parameter(torch.zeros(out_c)) if bias else None

    @staticmethod
    def weight_from_jax(w) -> torch.Tensor:
        """(k..., I, O), stored in torch's orientation -> (I, O, k...)."""
        w = torch.as_tensor(w)
        return w.permute(w.dim() - 2, w.dim() - 1, *range(w.dim() - 2))

    @staticmethod
    def weight_to_jax(w: torch.Tensor) -> torch.Tensor:
        """(I, O, k...) -> (k..., I, O)."""
        return w.permute(*range(2, w.dim()), 0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = F.conv_transpose3d if self.dim == 3 else F.conv_transpose2d
        y = _channels_last(conv(_channels_first(x), self.weight.to(x.dtype), None,
                                self.stride, self.padding, self.output_padding))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class Linear(nn.Module):
    """x @ w + b with the JAX package's (in, out) weight, stored as torch's
    (out, in)."""

    def __init__(self, in_f: int, out_f: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_f, in_f))
        self.bias = nn.Parameter(torch.zeros(out_f))

    @staticmethod
    def weight_from_jax(w) -> torch.Tensor:
        return torch.as_tensor(w).t()

    @staticmethod
    def weight_to_jax(w: torch.Tensor) -> torch.Tensor:
        return w.t()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def max_pool(x: torch.Tensor, window: int, dim: int = 3) -> torch.Tensor:
    """nn.MaxPool{2,3}d(window) with stride == window (floor semantics)."""
    pool = F.max_pool3d if dim == 3 else F.max_pool2d
    return _channels_last(pool(_channels_first(x), window))


def reflect_pad(x: torch.Tensor, n: int) -> torch.Tensor:
    """``jnp.pad(x, n, mode="reflect")`` over the spatial dims of a
    channels-last tensor."""
    spatial = x.dim() - 2
    return _channels_last(F.pad(_channels_first(x), (n, n) * spatial, mode="reflect"))


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) f32 weights of ``compute_weight_mat`` in
    ``jax.image.resize`` for the triangle kernel with antialiasing: the
    kernel widens by the shrink factor, so a shrink averages, not samples."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale
                - np.float32(0.0) * inv_scale - np.float32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0), np.float32(1) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1)), np.float32(0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, np.float32(0)).astype(np.float32)


def resize_linear(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(x, (N, *size, C), "linear")`` of a channels-last
    (N, H, W, C) tensor: antialiased when it shrinks (not
    ``AdaptiveAvgPool2d``), an axis whose size does not change left as it
    is."""
    (h, w), (oh, ow) = x.shape[1:3], size
    if (h, w) != (oh, ow):
        y = x
        if h != oh:
            wh = torch.from_numpy(_resize_weights(h, oh)).to(x.device, x.dtype)
            y = torch.einsum("nhwc,hp->npwc", y, wh)
        if w != ow:
            ww = torch.from_numpy(_resize_weights(w, ow)).to(x.device, x.dtype)
            y = torch.einsum("nhwc,wq->nhqc", y, ww)
        return y
    return x


class InstanceNorm(nn.Module):
    """InstanceNorm with affine=False, eps=1e-5 and biased variance over the
    spatial dims, with the following activation fused (``act``: None,
    'relu' or 'leaky'): the statistics, the map and, when a gradient is
    needed, the backward are the ``ops/inorm`` kernels."""

    def __init__(self, act=None, plain: bool = False):
        super().__init__()
        self.act, self.plain = act, plain

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return inorm.instance_norm_act(x, self.act, plain=self.plain)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.leaky_relu(x, 0.2)``: x where x >= 0, else 0.2 x."""
    return inorm.activation(x, "leaky")


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)
