"""Layer twins of ``neuroclear_tpu/nn/core.py``.

Activations are channels-last (N, D, H, W, C) tensors, as in the JAX
package.  Weights are stored in PyTorch's layouts: (O, I, k, k, k) for a
conv, (I, O, k, k, k) for a transposed conv; ``weight_from_jax`` converts a
JAX checkpoint's (k, k, k, I, O) array.  Convs outside the W-pair kernel's
gate run through ``F.conv3d`` on a channels-last view, as the JAX package
leaves them to XLA's convolution.  On the card a float32 conv matches the
JAX package only with TF32 off (``torch.backends.cudnn.allow_tf32 = False``),
the same trap as XLA's DEFAULT precision (``nn/core.py:94-100``); the entry
points turn it off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import inorm, wconv


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    """Channels-last (N, D, H, W, C) -> an (N, C, D, H, W) view."""
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 4, 1).contiguous()


class Conv(nn.Module):
    """3D conv with torch-style symmetric integer padding.  bf16 3x3x3
    convs inside ``wconv.supported`` go to the W-pair kernel (its plain
    version when ``plain``)."""

    def __init__(self, in_c: int, out_c: int, k: int, stride: int = 1, pad: int = 0,
                 bias: bool = True, plain: bool = False):
        super().__init__()
        self.in_c, self.out_c, self.k, self.stride, self.pad = in_c, out_c, k, stride, pad
        self.plain = plain
        self.weight = nn.Parameter(torch.zeros(out_c, in_c, k, k, k))
        self.bias = nn.Parameter(torch.zeros(out_c)) if bias else None

    @staticmethod
    def weight_from_jax(w) -> torch.Tensor:
        """(k, k, k, I, O) -> (O, I, k, k, k)."""
        return torch.as_tensor(w).permute(4, 3, 0, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.bfloat16 and wconv.supported(
                x.shape, self.in_c, self.out_c, self.k, self.stride, self.pad, 3):
            wt = wconv.pack_weight(self.weight.to(x.dtype))
            bias = (self.bias if self.bias is not None
                    else torch.zeros(self.out_c, device=x.device)).float().contiguous()
            fn = wconv.conv3d_plain if self.plain else wconv.conv3d
            return fn(x.contiguous(), wt, bias)
        y = F.conv3d(_ncdhw(x), self.weight.to(x.dtype), None, self.stride, self.pad)
        y = _ndhwc(y)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose3d(_ncdhw(x), self.weight.to(x.dtype), None, self.stride)
        y = _ndhwc(y)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def max_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """nn.MaxPool3d(window) with stride == window (floor semantics)."""
    return _ndhwc(F.max_pool3d(_ncdhw(x), window))


class InstanceNorm(nn.Module):
    """InstanceNorm with affine=False, eps=1e-5 and biased variance over the
    spatial dims, with the following activation fused (``act``): the
    statistics and the map are the ``ops/inorm`` kernels."""

    def __init__(self, act=None, plain: bool = False):
        super().__init__()
        self.act, self.plain = act, plain

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return inorm.instance_norm_act(x, self.act, plain=self.plain)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)
