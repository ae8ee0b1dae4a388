"""3x3x3 SAME convolution with 64 output channels, forward and backward: the
port of ``neuroclear_tpu/ops/pallas_wconv.py``.

Three wrappers, each with its own launch count, carry it on the card:
  * ``conv3d``: the forward conv, kernel ``csrc/conv3x3.cu`` (launched by
    ``conv3x3.launch``, the port's one 3x3x3 conv kernel; replaces
    ``_kernel`` as ``_conv_pallas`` runs it);
  * ``conv3d_dx``: the input gradient, the same kernel run on the 64-channel
    cotangent with the flipped, in/out-transposed weights, so its output has
    the forward's cin (64 or 128) channels and no bias (replaces ``_kernel``
    as ``_bwd`` runs it);
  * ``conv3d_dw``: the weight gradient in the packed (27, 64, cin) layout,
    kernel ``csrc/wconv_dw.cu`` (replaces ``_dw_kernel``), tiled by
    ``dw_plan``: voxel boxes summed in chunks, the chunks in a fixed order,
    so that dw is the same bits from run to run.
Each runs its plain PyTorch version (the same sums, f32 accumulation) on a
CPU tensor and launches its kernel on a CUDA tensor (bf16 only), or raises.
``WConvFn`` ties the three into one ``torch.autograd.Function``, as
``conv3d_wpack_pallas`` carries its custom VJP.  They serve the U-Net's two
full-resolution 64-output-channel convs, ``double_conv1.conv1`` (64 -> 64) and
``ex_conv1_1.conv0`` (128 -> 64), and the backward generator's ``feat1``
(64 -> 64), inside the JAX package's shape gate.  ``pack_weight`` and
``conv3d_plain`` are the conv kernel's, from ``ops/conv3x3.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import build
from .conv3x3 import acc_dtype, box_counts, check_operand, conv3d_plain, launch, pack_weight

COUT = 64
DW_BOX = (2, 4, 16)         # csrc/wconv_dw.cu: the voxel box (z, y, x) of a pipeline stage
DW_TILE_ROWS = 128          # csrc/wconv_dw.cu: (tap, c) rows per block, two 64-row halves
_TARGET_BLOCKS = 4 * 132    # dw: four waves of one resident block per H100 SM
_DW_MIN_BOXES = 32          # dw: fewest boxes (2,048 voxels) a chunk is worth


class DwPlan(NamedTuple):
    """How csrc/wconv_dw.cu tiles dw: the voxel ``box`` (bz, by, bx) of one
    pipeline stage, the box counts along (z, y, x), ``nboxes`` in all
    (numbered x fastest, then y, z and the batch), the row ``tiles`` of 128
    (tap, c) rows, and the split of the boxes into ``chunks`` of
    ``per_chunk`` consecutive boxes (the last may be shorter), summed in
    chunk order."""
    box: tuple[int, int, int]
    counts: tuple[int, int, int]
    nboxes: int
    tiles: int
    chunks: int
    per_chunk: int

    def chunk_boxes(self, k: int) -> range:
        return range(k * self.per_chunk, min(self.nboxes, (k + 1) * self.per_chunk))


def dw_plan(shape, cin: int) -> DwPlan:
    """The plan for x of shape (B, D, H, W, ...) with ``cin`` channels, a
    multiple of 64: about ``_TARGET_BLOCKS`` blocks, none of whose chunks
    holds fewer than ``_DW_MIN_BOXES`` boxes unless the volume is that
    small, and no chunk empty."""
    b, d, h, w = shape[:4]
    counts = box_counts(d, h, w, DW_BOX)
    nboxes = b * counts[0] * counts[1] * counts[2]
    tiles = -(-27 * cin // DW_TILE_ROWS)
    chunks = max(1, min(_TARGET_BLOCKS // tiles, nboxes // _DW_MIN_BOXES))
    per_chunk = -(-nboxes // chunks)
    return DwPlan(DW_BOX, counts, nboxes, tiles, -(-nboxes // per_chunk), per_chunk)


def supported(x_shape, cin: int, cout: int, k: int, stride: int, pad: int,
              dim: int) -> bool:
    """The shape gate of ``pallas_wconv.supported``: cout 64, cin 64 or 128,
    W even and at least 4 (the TPU strip plan does not apply here)."""
    if dim != 3 or k != 3 or stride != 1 or pad != 1 or len(x_shape) != 5:
        return False
    _, _, h, w, _ = x_shape
    if w % 2 or w < 4 or h < 2:
        return False
    return cout == COUT and cin in (64, 128)


def dx_weight(wt: torch.Tensor) -> torch.Tensor:
    """Packed forward weights (27, 64, cin) -> the input gradient's packed
    weights (27, cin, 64): taps flipped (tap t -> 26 - t), in and out
    swapped, as ``_bwd`` builds ``w_flip``."""
    return wt.flip(0).transpose(1, 2).contiguous()


def conv3d_dx_plain(g: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """dL/dx: ``conv3d_plain`` of the cotangent with ``dx_weight(wt)``."""
    return conv3d_plain(g, dx_weight(wt))


def conv3d_dw_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dL/dw in the packed (27, 64, cin) layout, in f32 (f64 for f64 input):
    dw[t, o, c] = sum over voxels of g[., o] * x[. + shift(t), c]."""
    b, d, h, w, cin = x.shape
    acc_t = acc_dtype(x)
    xp = F.pad(x.to(acc_t), (0, 0, 1, 1, 1, 1, 1, 1))
    g2 = g.to(acc_t).reshape(-1, g.shape[-1]).t()
    dw = torch.empty((27, g.shape[-1], cin), dtype=acc_t, device=x.device)
    for t in range(27):
        dz, dy, dx = t // 9, (t // 3) % 3, t % 3
        dw[t] = g2 @ xp[:, dz:dz + d, dy:dy + h, dx:dx + w, :].reshape(-1, cin)
    return dw


def conv3d(x: torch.Tensor, wt: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x (B, D, H, W, cin) NDHWC, wt (27, 64, cin) from ``pack_weight``,
    bias (64,) f32.  A CPU tensor takes ``conv3d_plain``; a CUDA tensor
    launches the kernel (bf16 only) or raises."""
    if x.device.type == "cpu":
        return conv3d_plain(x, wt, bias)
    if not supported(x.shape, x.shape[-1], wt.shape[1], 3, 1, 1, 3):
        raise ValueError(f"wconv kernel does not take x {tuple(x.shape)}, "
                         f"weights {tuple(wt.shape)}")
    y = launch(x, wt, bias, "wconv kernel")
    conv3d.launches += 1
    return y


conv3d.launches = 0


def conv3d_dx(g: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """dL/dx of ``conv3d``: g (B, D, H, W, 64) the cotangent, wt the forward's
    packed (27, 64, cin) weights; returns (B, D, H, W, cin) in g's dtype.  A
    CPU tensor takes ``conv3d_dx_plain``; a CUDA tensor launches the conv
    kernel once or raises."""
    if g.device.type == "cpu":
        return conv3d_dx_plain(g, wt)
    if g.shape[-1] != COUT:
        raise ValueError(f"wconv dx takes a {COUT}-channel cotangent, got {tuple(g.shape)}")
    dx = launch(g, dx_weight(wt), None, "wconv dx kernel")
    conv3d_dx.launches += 1
    return dx


conv3d_dx.launches = 0


def conv3d_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dL/dw of ``conv3d`` in the packed (27, 64, cin) layout, f32: x (B, D,
    H, W, cin) the forward's input (cin a multiple of 64), g (B, D, H, W, 64)
    the cotangent.  A CPU tensor takes ``conv3d_dw_plain``; a CUDA tensor
    launches the kernel (bf16 only) or raises."""
    if x.device.type == "cpu":
        return conv3d_dw_plain(x, g)
    b, d, h, w, cin = x.shape
    if x.dim() != 5 or cin % 64 or tuple(g.shape) != (b, d, h, w, COUT):
        raise ValueError(f"wconv dw does not take x {tuple(x.shape)}, g {tuple(g.shape)}")
    check_operand("wconv dw", "x", x, x.device, torch.bfloat16)
    check_operand("wconv dw", "g", g, x.device, torch.bfloat16)
    if x.device.type != "cuda":
        raise ValueError(f"wconv dw launches on a CUDA device, got a tensor on {x.device}")
    plan = dw_plan(x.shape, cin)
    part = torch.empty((plan.chunks, 27 * cin, COUT), dtype=torch.float32, device=x.device)
    dw = torch.empty((27, COUT, cin), dtype=torch.float32, device=x.device)
    lib = build.load("wconv_dw")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.nc_wconv_dw_bf16(x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(),
                                    b, d, h, w, cin, plan.chunks, *plan.box, plan.per_chunk,
                                    stream)
    build.check(lib, code, "wconv_dw launch")
    conv3d_dw.launches += 1
    return dw


conv3d_dw.launches = 0


class WConvFn(torch.autograd.Function):
    """``conv3d`` with its gradients: dx by ``conv3d_dx``, dw by ``conv3d_dw``
    rounded to the weights' dtype (bf16 on the path, as the JAX package's
    ``_bwd`` returns ``dw.astype(w.dtype)`` for the bf16 weights), and the
    bias gradient as the f32 sum of the cotangent.  ``plain`` runs the plain
    versions whatever the device."""

    @staticmethod
    def forward(ctx, x, wt, bias, plain):
        ctx.save_for_backward(x, wt)
        ctx.plain = plain
        return (conv3d_plain if plain else conv3d)(x, wt, bias)

    @staticmethod
    def backward(ctx, gy):
        x, wt = ctx.saved_tensors
        gy = gy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = (conv3d_dx_plain if ctx.plain else conv3d_dx)(gy, wt)
        if ctx.needs_input_grad[1]:
            dw = (conv3d_dw_plain if ctx.plain else conv3d_dw)(x, gy).to(wt.dtype)
        if ctx.needs_input_grad[2]:
            db = gy.to(acc_dtype(gy)).sum(dim=(0, 1, 2, 3))
        return dx, dw, db, None
