"""3x3x3 SAME convolution with 64 output channels: the port of
``neuroclear_tpu/ops/pallas_wconv.py`` (forward only).

``conv3d`` launches the hand-written CUDA kernel ``csrc/wconv.cu`` on a CUDA
tensor and runs ``conv3d_plain`` (the same implicit GEMM in PyTorch, f32
accumulation) on a CPU tensor.  It serves the U-Net's two full-resolution
64-output-channel convs, ``double_conv1.conv1`` (64 -> 64) and
``ex_conv1_1.conv0`` (128 -> 64), inside the JAX package's shape gate.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

COUT = 64


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
    """Torch-layout weight (64, cin, 3, 3, 3) -> the kernel's (27, 64, cin):
    tap-major (z, y, x), input channels contiguous."""
    cout, cin = w.shape[:2]
    return w.permute(2, 3, 4, 0, 1).reshape(27, cout, cin).contiguous()


def conv3d_plain(x: torch.Tensor, wt: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: for each of the 27 taps, the
    shifted input (B, D, H, W, cin) times the tap's (cin, 64) weights, summed
    in f32, plus the bias, rounded once to x's dtype."""
    b, d, h, w, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    acc = torch.zeros((b, d, h, w, wt.shape[1]), dtype=torch.float32, device=x.device)
    for t in range(27):
        dz, dy, dx = t // 9, (t // 3) % 3, t % 3
        acc += xp[:, dz:dz + d, dy:dy + h, dx:dx + w, :] @ wt[t].float().t()
    return (acc + bias.float()).to(x.dtype)


def conv3d(x: torch.Tensor, wt: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x (B, D, H, W, cin) NDHWC, wt (27, 64, cin) from ``pack_weight``,
    bias (64,) f32.  A CPU tensor takes ``conv3d_plain``; a CUDA tensor
    launches the kernel (bf16 only) or raises."""
    if x.device.type == "cpu":
        return conv3d_plain(x, wt, bias)
    b, d, h, w, cin = x.shape
    if not supported(x.shape, cin, wt.shape[1], 3, 1, 1, 3):
        raise ValueError(f"wconv kernel does not take x {tuple(x.shape)}, "
                         f"weights {tuple(wt.shape)}")
    if x.dtype != torch.bfloat16 or wt.dtype != torch.bfloat16 or bias.dtype != torch.float32:
        raise TypeError(f"wconv kernel takes bf16 x and weights and f32 bias, "
                        f"got {x.dtype}, {wt.dtype}, {bias.dtype}")
    if tuple(wt.shape) != (27, COUT, cin) or tuple(bias.shape) != (COUT,):
        raise ValueError(f"wconv weights {tuple(wt.shape)} / bias {tuple(bias.shape)} "
                         f"do not match cin {cin}")
    for name, t in (("x", x), ("wt", wt), ("bias", bias)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"wconv {name} must be a contiguous, 16-byte aligned "
                             f"tensor on {x.device}")
    y = torch.empty((b, d, h, w, COUT), dtype=torch.bfloat16, device=x.device)
    lib = build.load("wconv")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.nc_wconv3x3x3_bf16(x.data_ptr(), wt.data_ptr(), bias.data_ptr(),
                                      y.data_ptr(), b, d, h, w, cin, stream)
    build.check(lib, code, "wconv3x3x3 launch")
    conv3d.launches += 1
    return y


conv3d.launches = 0
