"""Layer twins of ``neuroclear_tpu/nn/core.py``.

Activations are channels-last (N, D, H, W, C) or (N, H, W, C) tensors, as
in the JAX package.  Weights are stored in PyTorch's layouts: (O, I, k...)
for a conv, (I, O, k, k, k) for a transposed conv; ``weight_from_jax``
converts a JAX checkpoint's (k..., I, O) array and ``weight_to_jax`` converts
back.  Convs outside the W-pair kernel's gate run through ``F.conv3d`` or
``F.conv2d`` on a channels-last view, as the JAX package leaves them to
XLA's convolution; inside the gate, ``wconv.WConvFn`` carries the
gradients through the hand kernels when one is needed.  With
``NEUROCLEAR_PALLAS_CONV=1``, bf16 convs outside that gate and inside
``conv3x3.supported`` go to the dense-K conv kernel, as the JAX package
routes them to ``pallas_conv.conv3d_3x3``.  On the card a
float32 conv matches the JAX package only with TF32 off
(``torch.backends.cudnn.allow_tf32 = False``), the same trap as XLA's
DEFAULT precision (``nn/core.py:94-100``); the entry points turn it off.
"""

from __future__ import annotations

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
    convs inside ``wconv.supported`` go to the W-pair kernel (its plain
    version when ``plain``), through ``wconv.WConvFn`` when a gradient is
    needed; then, in the order of the JAX package's ``Conv.apply``, those
    inside ``conv3x3.supported`` go to the dense-K kernel the same way,
    through ``conv3x3.Conv3x3Fn``."""

    def __init__(self, in_c: int, out_c: int, k: int, stride: int = 1, pad: int = 0,
                 bias: bool = True, plain: bool = False, dim: int = 3):
        super().__init__()
        if dim not in (2, 3):
            raise ValueError(f"conv dim {dim}: the port has 2 and 3")
        self.in_c, self.out_c, self.k, self.stride, self.pad = in_c, out_c, k, stride, pad
        self.plain, self.dim = plain, dim
        self.weight = nn.Parameter(torch.zeros((out_c, in_c) + (k,) * dim))
        self.bias = nn.Parameter(torch.zeros(out_c)) if bias else None

    @staticmethod
    def weight_from_jax(w) -> torch.Tensor:
        """(k..., I, O) -> (O, I, k...)."""
        w = torch.as_tensor(w)
        return w.permute(w.dim() - 1, w.dim() - 2, *range(w.dim() - 2))

    @staticmethod
    def weight_to_jax(w: torch.Tensor) -> torch.Tensor:
        """(O, I, k...) -> (k..., I, O)."""
        return w.permute(*range(2, w.dim()), 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.bfloat16:
            gate = (self.in_c, self.out_c, self.k, self.stride, self.pad, self.dim)
            if wconv.supported(x.shape, *gate):
                return self._hand_conv(x, wconv.WConvFn, wconv.conv3d, wconv.conv3d_plain)
            if conv3x3.supported(x.shape, *gate):
                return self._hand_conv(x, conv3x3.Conv3x3Fn, conv3x3.conv3d,
                                       conv3x3.conv3d_plain)
        conv = F.conv3d if self.dim == 3 else F.conv2d
        y = _channels_last(conv(_channels_first(x), self.weight.to(x.dtype), None,
                                self.stride, self.pad))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    def _hand_conv(self, x, autograd_fn, kernel, plain):
        """A hand conv on the packed weights and the f32 bias: through
        ``autograd_fn`` when a gradient is needed, else the kernel wrapper
        (its plain version when ``self.plain``)."""
        wt = wconv.pack_weight(self.weight.to(x.dtype))
        bias = (self.bias if self.bias is not None
                else torch.zeros(self.out_c, device=x.device)).float().contiguous()
        if torch.is_grad_enabled() and (x.requires_grad or wt.requires_grad
                                        or bias.requires_grad):
            return autograd_fn.apply(x.contiguous(), wt, bias, self.plain)
        return (plain if self.plain else kernel)(x.contiguous(), wt, bias)


class ConvTranspose(nn.Module):
    """nn.ConvTranspose3d(in, out, k, stride) semantics; the U-Net uses
    k == stride == 2."""

    def __init__(self, in_c: int, out_c: int, k: int, stride: int, bias: bool = True):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(in_c, out_c, k, k, k))
        self.bias = nn.Parameter(torch.zeros(out_c)) if bias else None

    @staticmethod
    def weight_from_jax(w) -> torch.Tensor:
        """(k, k, k, I, O), stored in torch's orientation -> (I, O, k, k, k)."""
        return torch.as_tensor(w).permute(3, 4, 0, 1, 2)

    @staticmethod
    def weight_to_jax(w: torch.Tensor) -> torch.Tensor:
        """(I, O, k, k, k) -> (k, k, k, I, O)."""
        return w.permute(2, 3, 4, 0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _channels_last(F.conv_transpose3d(_channels_first(x), self.weight.to(x.dtype),
                                              None, self.stride))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def max_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """nn.MaxPool3d(window) with stride == window (floor semantics)."""
    return _channels_last(F.max_pool3d(_channels_first(x), window))


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
