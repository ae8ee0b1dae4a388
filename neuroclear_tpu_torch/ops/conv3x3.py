"""3x3x3 SAME convolution for any cin that is a multiple of 32 and cout of
32, 64, 96 or 128: the port of ``neuroclear_tpu/ops/pallas_conv.py``, the
dense-K conv the JAX package keeps behind ``NEUROCLEAR_PALLAS_CONV=1``.

``csrc/conv3x3.cu`` is the port's one hand-written 3x3x3 conv kernel:
``launch`` runs it once, and the W-pair conv's forward and input gradient
(``ops/wconv.py``) launch it too, each wrapper with its own launch count.
``conv_plan`` is its host-side tiling (the output box of a block, the grid,
the channels per pipeline stage), in plain Python so that the CPU tests
check it; ``box_counts`` serves the weight gradient's plan
(``ops/wconv.py``) too.
``pack_weight`` gives the (27, cout, cin) layout it takes and
``conv3d_plain`` its arithmetic in PyTorch.

``conv3d`` launches the kernel (replaces ``_conv_kernel`` as
``_conv3d_pallas`` runs it) on a CUDA bf16 tensor, with its own launch
count, or raises; on a CPU tensor it runs ``conv3d_plain``.  ``Conv3x3Fn``
carries its gradient as ``conv3d_3x3``'s custom VJP does: the backward
(``_bwd``) is PyTorch's own conv gradients (cuDNN on the card), as the JAX
package leaves it to XLA's convolutions, so it has no kernel of its own.

In ``nn/core.py::Conv`` the route is taken after the W-pair conv's gate, as
in the JAX package's ``Conv.apply``.  Since the port runs the W-pair conv in
training as well as in inference, in both the route serves the U-Net's four
half-resolution 128-output convs (``double_conv2`` and ``ex_double_conv2``);
in JAX training, with the W-pair kernel off, it would take the 64-output
convs too, which is the same function.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import build

_COUTS = (32, 64, 96, 128)  # csrc/conv3x3.cu: one template per cout

# TMA's limits on a tiled box: at most 256 elements per dimension, the
# innermost extent a multiple of 16 bytes and, under a swizzle, at most the
# swizzle's span
TMA_BOX_MAX = 256
# csrc/conv3x3.cu: the output box (z, y, x) of a block, by cout: two z-planes
# of 28 x 8 (one per warpgroup) up to 64, one 14 x 8 plane (its two 64-row
# tiles of cout split between the warpgroups) above
CONV_BOXES = {False: (2, 28, 8), True: (1, 14, 8)}
CONV_KC = 32  # csrc/conv3x3.cu: input channels per pipeline stage


def box_counts(d: int, h: int, w: int, box) -> tuple[int, int, int]:
    """Boxes along z, y and x that cover a (d, h, w) volume."""
    bz, by, bx = box
    return -(-d // bz), -(-h // by), -(-w // bx)


class ConvPlan(NamedTuple):
    """How csrc/conv3x3.cu tiles one conv: ``kc`` input channels per pipeline
    stage, the output ``box`` (bz, by, bx) of one block (``CONV_BOXES``), the
    box counts along (z, y, x), and the grid (one block per box and batch
    entry).  A stage loads the box with a one-voxel halo, one TMA load per
    8-channel chunk (16-byte rows, no swizzle), and each tap's weights, cout
    padded to 64 or 128 rows, under the 64-byte swizzle."""
    kc: int
    box: tuple[int, int, int]
    counts: tuple[int, int, int]
    grid: int
    swizzle_bytes: int = 2 * CONV_KC  # the weights' rows

    def tma_boxes(self, cout: int) -> list[tuple[int, ...]]:
        """The two TMA boxes, innermost first: a chunk of the haloed input
        (8, bx + 2, by + 2, bz + 2, 1) and a tap's weights (kc, cout padded
        to a multiple of 64)."""
        bz, by, bx = self.box
        return [(8, bx + 2, by + 2, bz + 2, 1), (self.kc, -(-cout // 64) * 64)]


def conv_plan(shape, cin: int, cout: int) -> ConvPlan:
    """The plan for x of shape (B, D, H, W, ...) with ``cin`` channels, a
    multiple of 32, and ``cout`` outputs: the kernel's box and stage width,
    and the grid."""
    b, d, h, w = shape[:4]
    box = CONV_BOXES[cout > 64]
    counts = box_counts(d, h, w, box)
    return ConvPlan(CONV_KC, box, counts, b * counts[0] * counts[1] * counts[2])


def enabled() -> bool:
    """The JAX package's own switch, ``NEUROCLEAR_PALLAS_CONV=1``, off by
    default; read at each call, so a run can turn the route on and off."""
    return os.environ.get("NEUROCLEAR_PALLAS_CONV", "0") == "1"


def supported(x_shape, cin: int, cout: int, k: int, stride: int, pad: int,
              dim: int) -> bool:
    """The shape gate of ``pallas_conv.supported``, on when ``enabled()``:
    3D, k 3, stride 1, pad 1, cin and cout multiples of 32, cout at most
    128, H at least 4 and W at least 32.  Its VMEM strip plan (``_pick_th``)
    is a TPU budget and is not carried over; it refuses only W * cin above
    116,508, which no production shape reaches."""
    if not enabled():
        return False
    if dim != 3 or k != 3 or stride != 1 or pad != 1 or len(x_shape) != 5:
        return False
    if cin % 32 or cout % 32 or cout > 128:
        return False
    _, _, h, w, _ = x_shape
    return h >= 4 and w >= 32


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """Torch-layout weight (cout, cin, 3, 3, 3) -> the kernel's (27, cout, cin):
    tap-major (z, y, x), input channels contiguous."""
    cout, cin = w.shape[:2]
    return w.permute(2, 3, 4, 0, 1).reshape(27, cout, cin).contiguous()


def acc_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def conv3d_plain(x: torch.Tensor, wt: torch.Tensor, bias=None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: for each of the 27 taps, the
    shifted input (B, D, H, W, cin) times the tap's (cin, cout) weights,
    summed in f32 (f64 for f64 input), plus the bias, rounded once to x's
    dtype."""
    b, d, h, w, _ = x.shape
    acc_t = acc_dtype(x)
    xp = F.pad(x.to(acc_t), (0, 0, 1, 1, 1, 1, 1, 1))
    acc = torch.zeros((b, d, h, w, wt.shape[1]), dtype=acc_t, device=x.device)
    for t in range(27):
        dz, dy, dx = t // 9, (t // 3) % 3, t % 3
        acc += xp[:, dz:dz + d, dy:dy + h, dx:dx + w, :] @ wt[t].to(acc_t).t()
    if bias is not None:
        acc += bias.to(acc_t)
    return acc.to(x.dtype)


def check_operand(kernel: str, name: str, t: torch.Tensor, device, dtype) -> None:
    """Raise unless t is a contiguous, 16-byte aligned ``dtype`` tensor on
    ``device`` (TMA reads from 16-byte aligned addresses only)."""
    if t.dtype != dtype:
        raise TypeError(f"{kernel} takes {dtype} {name}, got {t.dtype}")
    if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{kernel} {name} must be a contiguous, 16-byte aligned "
                         f"tensor on {device}")


def launch(x: torch.Tensor, wt: torch.Tensor, bias, what: str) -> torch.Tensor:
    """One launch of csrc/conv3x3.cu, counted by the caller: x (B, D, H, W,
    cin) bf16 on a CUDA device, wt (27, cout, cin) bf16, bias (cout,) f32 or
    None.  Any other input raises before the kernel is built or launched;
    ``what`` names the caller in the message."""
    if x.dim() != 5 or wt.dim() != 3:
        raise ValueError(f"{what} does not take x {tuple(x.shape)}, weights {tuple(wt.shape)}")
    b, d, h, w, cin = x.shape
    cout = wt.shape[1]
    if cin % 32 or cout not in _COUTS or tuple(wt.shape) != (27, cout, cin):
        raise ValueError(f"{what} does not take x {tuple(x.shape)}, weights {tuple(wt.shape)}")
    check_operand(what, "x", x, x.device, torch.bfloat16)
    check_operand(what, "wt", wt, x.device, torch.bfloat16)
    if bias is not None:
        check_operand(what, "bias", bias, x.device, torch.float32)
        if tuple(bias.shape) != (cout,):
            raise ValueError(f"{what} bias {tuple(bias.shape)} does not match cout {cout}")
    if x.device.type != "cuda":
        raise ValueError(f"{what} launches on a CUDA device, got a tensor on {x.device}")
    plan = conv_plan(x.shape, cin, cout)
    y = torch.empty((b, d, h, w, cout), dtype=torch.bfloat16, device=x.device)
    lib = build.load("conv3x3")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.nc_conv3x3_bf16(x.data_ptr(), wt.data_ptr(),
                                   None if bias is None else bias.data_ptr(),
                                   y.data_ptr(), b, d, h, w, cin, cout, plan.kc, *plan.box,
                                   stream)
    build.check(lib, code, f"{what} launch")
    return y


def conv3d(x: torch.Tensor, wt: torch.Tensor, bias=None) -> torch.Tensor:
    """x (B, D, H, W, cin) NDHWC, wt (27, cout, cin) from ``pack_weight``,
    bias (cout,) f32 or None.  A CPU tensor takes ``conv3d_plain``; a CUDA
    tensor launches the kernel (bf16 only) or raises."""
    if x.device.type == "cpu":
        return conv3d_plain(x, wt, bias)
    y = launch(x, wt, bias, "conv3x3 kernel")
    conv3d.launches += 1
    return y


conv3d.launches = 0


def _unpack_weight(wt: torch.Tensor) -> torch.Tensor:
    """(27, cout, cin) -> PyTorch's (cout, cin, 3, 3, 3)."""
    cout, cin = wt.shape[1:]
    return wt.reshape(3, 3, 3, cout, cin).permute(3, 4, 0, 1, 2)


class Conv3x3Fn(torch.autograd.Function):
    """``conv3d`` (``conv3d_plain`` when ``plain``) with the gradients of
    ``pallas_conv._bwd``: dx and dw by PyTorch's conv gradients in the
    operands' dtype (``torch.nn.grad.conv3d_input`` / ``conv3d_weight``, as
    ``_bwd`` runs XLA convs), dw returned in the packed layout and the
    weights' dtype; the bias gradient is the f32 sum of the cotangent."""

    @staticmethod
    def forward(ctx, x, wt, bias, plain):
        ctx.save_for_backward(x, wt)
        return (conv3d_plain if plain else conv3d)(x, wt, bias)

    @staticmethod
    def backward(ctx, gy):
        x, wt = ctx.saved_tensors
        g_cf = gy.movedim(-1, 1)   # channels-first views of the NDHWC tensors
        w = _unpack_weight(wt).to(gy.dtype)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv3d_input(x.movedim(-1, 1).shape, w, g_cf, padding=1)
            dx = dx.movedim(1, -1).contiguous().to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv3d_weight(x.movedim(-1, 1).to(gy.dtype), w.shape, g_cf,
                                             padding=1)
            dw = pack_weight(dw).to(wt.dtype)
        if ctx.needs_input_grad[2]:
            db = gy.to(acc_dtype(gy)).sum(dim=(0, 1, 2, 3))
        return dx, dw, db, None
