"""3x3x3 SAME convolution with 64 output channels, forward and backward: the
port of ``neuroclear_tpu/ops/pallas_wconv.py``.

Three wrappers, each with its own launch count, carry it on the card:
  * ``conv3d``: the forward conv, kernel ``csrc/wconv.cu`` (replaces
    ``_kernel`` as ``_conv_pallas`` runs it);
  * ``conv3d_dx``: the input gradient, the same kernel run on the 64-channel
    cotangent with the flipped, in/out-transposed weights, so its output has
    the forward's cin (64 or 128) channels and no bias (replaces ``_kernel``
    as ``_bwd`` runs it);
  * ``conv3d_dw``: the weight gradient in the packed (27, 64, cin) layout,
    kernel ``csrc/wconv_dw.cu`` (replaces ``_dw_kernel``).
Each runs its plain PyTorch version (the same sums, f32 accumulation) on a
CPU tensor and launches its kernel on a CUDA tensor (bf16 only), or raises.
``WConvFn`` ties the three into one ``torch.autograd.Function``, as
``conv3d_wpack_pallas`` carries its custom VJP.  They serve the U-Net's two
full-resolution 64-output-channel convs, ``double_conv1.conv1`` (64 -> 64) and
``ex_conv1_1.conv0`` (128 -> 64), and the backward generator's ``feat1``
(64 -> 64), inside the JAX package's shape gate.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

COUT = 64
_GROUP = 64               # csrc/wconv.cu BN: output channels per block row
_DW_TILE = 128            # csrc/wconv_dw.cu BM: (tap, c) rows per block
_TARGET_BLOCKS = 4 * 132  # dw: about four blocks per H100 SM
_DW_MIN_VOXELS = 2048     # dw: fewest voxels a chunk is worth


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


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """Torch-layout weight (cout, cin, 3, 3, 3) -> the kernel's (27, cout, cin):
    tap-major (z, y, x), input channels contiguous."""
    cout, cin = w.shape[:2]
    return w.permute(2, 3, 4, 0, 1).reshape(27, cout, cin).contiguous()


def dx_weight(wt: torch.Tensor) -> torch.Tensor:
    """Packed forward weights (27, 64, cin) -> the input gradient's packed
    weights (27, cin, 64): taps flipped (tap t -> 26 - t), in and out
    swapped, as ``_bwd`` builds ``w_flip``."""
    return wt.flip(0).transpose(1, 2).contiguous()


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def conv3d_plain(x: torch.Tensor, wt: torch.Tensor, bias=None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: for each of the 27 taps, the
    shifted input (B, D, H, W, cin) times the tap's (cin, cout) weights,
    summed in f32 (f64 for f64 input), plus the bias, rounded once to x's
    dtype."""
    b, d, h, w, _ = x.shape
    acc_t = _acc_dtype(x)
    xp = F.pad(x.to(acc_t), (0, 0, 1, 1, 1, 1, 1, 1))
    acc = torch.zeros((b, d, h, w, wt.shape[1]), dtype=acc_t, device=x.device)
    for t in range(27):
        dz, dy, dx = t // 9, (t // 3) % 3, t % 3
        acc += xp[:, dz:dz + d, dy:dy + h, dx:dx + w, :] @ wt[t].to(acc_t).t()
    if bias is not None:
        acc += bias.to(acc_t)
    return acc.to(x.dtype)


def conv3d_dx_plain(g: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """dL/dx: ``conv3d_plain`` of the cotangent with ``dx_weight(wt)``."""
    return conv3d_plain(g, dx_weight(wt))


def conv3d_dw_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dL/dw in the packed (27, 64, cin) layout, in f32 (f64 for f64 input):
    dw[t, o, c] = sum over voxels of g[., o] * x[. + shift(t), c]."""
    b, d, h, w, cin = x.shape
    acc_t = _acc_dtype(x)
    xp = F.pad(x.to(acc_t), (0, 0, 1, 1, 1, 1, 1, 1))
    g2 = g.to(acc_t).reshape(-1, g.shape[-1]).t()
    dw = torch.empty((27, g.shape[-1], cin), dtype=acc_t, device=x.device)
    for t in range(27):
        dz, dy, dx = t // 9, (t // 3) % 3, t % 3
        dw[t] = g2 @ xp[:, dz:dz + d, dy:dy + h, dx:dx + w, :].reshape(-1, cin)
    return dw


def _check_operand(name: str, t: torch.Tensor, device, dtype) -> None:
    if t.dtype != dtype:
        raise TypeError(f"wconv kernels take {dtype} {name}, got {t.dtype}")
    if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"wconv {name} must be a contiguous, 16-byte aligned "
                         f"tensor on {device}")


def _launch_conv(x: torch.Tensor, wt: torch.Tensor, bias) -> torch.Tensor:
    """One launch of csrc/wconv.cu: x (B, D, H, W, cin) bf16, wt (27, cout,
    cin) bf16 with cout a multiple of 64, bias (cout,) f32 or None."""
    b, d, h, w, cin = x.shape
    cout = wt.shape[1]
    if x.dim() != 5 or cin not in (64, 128) or w % 2 or w < 4 or h < 2:
        raise ValueError(f"wconv kernel does not take x {tuple(x.shape)}")
    if wt.dim() != 3 or tuple(wt.shape) != (27, cout, cin) or cout % _GROUP:
        raise ValueError(f"wconv weights {tuple(wt.shape)} do not match cin {cin}")
    _check_operand("x", x, x.device, torch.bfloat16)
    _check_operand("wt", wt, x.device, torch.bfloat16)
    if bias is not None:
        _check_operand("bias", bias, x.device, torch.float32)
        if tuple(bias.shape) != (cout,):
            raise ValueError(f"wconv bias {tuple(bias.shape)} does not match cout {cout}")
    y = torch.empty((b, d, h, w, cout), dtype=torch.bfloat16, device=x.device)
    lib = build.load("wconv")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.nc_wconv3x3x3_bf16(x.data_ptr(), wt.data_ptr(),
                                      None if bias is None else bias.data_ptr(),
                                      y.data_ptr(), b, d, h, w, cin, cout, stream)
    build.check(lib, code, "wconv3x3x3 launch")
    return y


def conv3d(x: torch.Tensor, wt: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x (B, D, H, W, cin) NDHWC, wt (27, 64, cin) from ``pack_weight``,
    bias (64,) f32.  A CPU tensor takes ``conv3d_plain``; a CUDA tensor
    launches the kernel (bf16 only) or raises."""
    if x.device.type == "cpu":
        return conv3d_plain(x, wt, bias)
    if not supported(x.shape, x.shape[-1], wt.shape[1], 3, 1, 1, 3):
        raise ValueError(f"wconv kernel does not take x {tuple(x.shape)}, "
                         f"weights {tuple(wt.shape)}")
    y = _launch_conv(x, wt, bias)
    conv3d.launches += 1
    return y


conv3d.launches = 0


def conv3d_dx(g: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """dL/dx of ``conv3d``: g (B, D, H, W, 64) the cotangent, wt the forward's
    packed (27, 64, cin) weights; returns (B, D, H, W, cin) in g's dtype.  A
    CPU tensor takes ``conv3d_dx_plain``; a CUDA tensor launches the conv
    kernel once (cin / 64 block rows) or raises."""
    if g.device.type == "cpu":
        return conv3d_dx_plain(g, wt)
    if g.shape[-1] != COUT:
        raise ValueError(f"wconv dx takes a {COUT}-channel cotangent, got {tuple(g.shape)}")
    dx = _launch_conv(g, dx_weight(wt), None)
    conv3d_dx.launches += 1
    return dx


conv3d_dx.launches = 0


def conv3d_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dL/dw of ``conv3d`` in the packed (27, 64, cin) layout, f32: x (B, D,
    H, W, cin) the forward's input, g (B, D, H, W, 64) the cotangent.  A CPU
    tensor takes ``conv3d_dw_plain``; a CUDA tensor launches the kernel
    (bf16 only) or raises."""
    if x.device.type == "cpu":
        return conv3d_dw_plain(x, g)
    b, d, h, w, cin = x.shape
    if x.dim() != 5 or cin % 8 or tuple(g.shape) != (b, d, h, w, COUT):
        raise ValueError(f"wconv dw does not take x {tuple(x.shape)}, g {tuple(g.shape)}")
    _check_operand("x", x, x.device, torch.bfloat16)
    _check_operand("g", g, x.device, torch.bfloat16)
    voxels = b * d * h * w
    tiles = -(-27 * cin // _DW_TILE)
    chunks = max(1, min(-(-_TARGET_BLOCKS // tiles), -(-voxels // _DW_MIN_VOXELS)))
    part = torch.empty((chunks, 27 * cin, COUT), dtype=torch.float32, device=x.device)
    dw = torch.empty((27, COUT, cin), dtype=torch.float32, device=x.device)
    lib = build.load("wconv_dw")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.nc_wconv_dw_bf16(x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(),
                                    b, d, h, w, cin, chunks, stream)
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
            db = gy.to(_acc_dtype(gy)).sum(dim=(0, 1, 2, 3))
        return dx, dw, db, None
