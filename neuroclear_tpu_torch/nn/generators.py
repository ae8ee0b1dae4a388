"""Generator twins of ``neuroclear_tpu/nn/generators.py``: ``ConvBlock``
(its plain path), ``UNetDeconv``, the production generator, and
``DeepLinearGenerator``, the production backward generator of the Apollo
cycle.

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

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .core import Conv, ConvTranspose, max_pool, sigmoid
from .norms import get_norm_spec


def checkpointed(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward pass
    (only its inputs are kept).  The nets draw no random numbers, so no RNG
    state is stashed."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def _direct(fn, *args):
    return fn(*args)


class ConvBlock(nn.Module):
    """n x (conv k3 s1 p1 -> instance norm -> ReLU), norm and ReLU fused."""

    def __init__(self, in_c: int, out_c: int, n: int, norm: str = "instance",
                 plain: bool = False):
        super().__init__()
        spec = get_norm_spec(norm)
        self.n = n
        for i in range(n):
            self.add_module(f"conv{i}", Conv(in_c if i == 0 else out_c, out_c, 3, 1, 1,
                                             plain=plain))
            self.add_module(f"norm{i}", spec.layer("relu", plain=plain))

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
