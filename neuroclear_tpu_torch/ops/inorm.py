"""Instance norm (affine-free, eps 1e-5, biased variance) with a fused
activation: the port of ``neuroclear_tpu/ops/pallas_ops.py`` (forward only).

Two kernels, in ``csrc/inorm.cu``, carry it on the card:
  * ``pair_sums``: per (n, c) [sum x, sum x^2] in f32 over an (N, R, C) view
    (replaces ``_pair_sums`` with b = None);
  * ``affine_map_act``: y = act(x * scale + shift) with per-(n, c) f32
    coefficients (replaces ``_affine_map``, with the ReLU of
    ``instance_norm_act`` fused in).
Each wrapper runs its plain PyTorch version on a CPU tensor and launches its
kernel on a CUDA tensor (bf16 or f32), or raises.  ``instance_norm_act``
derives mean and rstd from the sums exactly as ``_inorm_fwd_impl`` does
(fold = 1).
"""

from __future__ import annotations

import torch

from . import build

EPS = 1e-5
ACTS = (None, "relu")
_TARGET_BLOCKS = 4 * 132  # pair_sums: about four blocks per H100 SM
_THREADS = 256            # csrc/inorm.cu THREADS


def _check_act(act) -> None:
    if act not in ACTS:
        raise NotImplementedError(f"activation {act!r}: the port has {ACTS}")


def pair_sums_plain(x3: torch.Tensor) -> torch.Tensor:
    """(N, R, C) -> (N, 2, C) f32: [sum x, sum x^2] over R."""
    xf = x3.float()
    return torch.stack([xf.sum(dim=1), (xf * xf).sum(dim=1)], dim=1)


def affine_map_act_plain(x3: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                         act=None) -> torch.Tensor:
    """y = act(x * scale + shift) in f32, rounded once to x's dtype."""
    _check_act(act)
    y = x3.float() * scale[:, None, :] + shift[:, None, :]
    if act == "relu":
        y = torch.relu(y)
    return y.to(x3.dtype)


def _check_cuda_view(x3: torch.Tensor, what: str) -> int:
    """Validate a kernel operand; returns its vector width (elements per
    16-byte load)."""
    if x3.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} kernel takes bf16 or f32, got {x3.dtype}")
    if x3.dim() != 3 or not x3.is_contiguous() or x3.data_ptr() % 16:
        raise ValueError(f"{what} kernel takes a contiguous, 16-byte aligned "
                         f"(N, R, C) tensor, got {tuple(x3.shape)}")
    vec = 16 // x3.element_size()
    c = x3.shape[2]
    if c % vec or _THREADS % (c // vec):
        raise ValueError(f"{what} kernel takes C with C / {vec} dividing "
                         f"{_THREADS}, got C = {c}")
    return vec


def pair_sums(x3: torch.Tensor) -> torch.Tensor:
    """Per-(n, c) [sum x, sum x^2] in f32, shape (N, 2, C).  The kernel on a
    CUDA tensor, ``pair_sums_plain`` on a CPU tensor."""
    if x3.device.type == "cpu":
        return pair_sums_plain(x3)
    vec = _check_cuda_view(x3, "pair_sums")
    n, rows, c = x3.shape
    rows_per_sweep = _THREADS // (c // vec)
    chunks = max(1, min(-(-_TARGET_BLOCKS // n), -(-rows // rows_per_sweep)))
    part = torch.empty((n, chunks, 2, c), dtype=torch.float32, device=x3.device)
    out = torch.empty((n, 2, c), dtype=torch.float32, device=x3.device)
    lib = build.load("inorm")
    with torch.cuda.device(x3.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.nc_pair_sums(x3.data_ptr(), part.data_ptr(), out.data_ptr(), n, rows, c,
                                chunks, int(x3.dtype == torch.bfloat16), stream)
    build.check(lib, code, "pair_sums launch")
    pair_sums.launches += 1
    return out


pair_sums.launches = 0


def affine_map_act(x3: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                   act=None) -> torch.Tensor:
    """y = act(x * scale + shift), scale and shift (N, C) f32.  The kernel on
    a CUDA tensor, ``affine_map_act_plain`` on a CPU tensor."""
    if x3.device.type == "cpu":
        return affine_map_act_plain(x3, scale, shift, act)
    _check_act(act)
    _check_cuda_view(x3, "affine_map_act")
    n, rows, c = x3.shape
    for name, t in (("scale", scale), ("shift", shift)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (n, c) or not t.is_contiguous()
                or t.device != x3.device or t.data_ptr() % 16):
            raise ValueError(f"affine_map_act {name} must be a contiguous f32 ({n}, {c}) "
                             f"tensor on {x3.device}")
    y = torch.empty_like(x3)
    lib = build.load("inorm")
    with torch.cuda.device(x3.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.nc_affine_map_act(x3.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                                     y.data_ptr(), n, rows, c, int(act == "relu"),
                                     int(x3.dtype == torch.bfloat16), stream)
    build.check(lib, code, "affine_map_act launch")
    affine_map_act.launches += 1
    return y


affine_map_act.launches = 0


def norm_coefficients(sums: torch.Tensor, rows: int):
    """(N, 2, C) sums -> (scale, shift) = (rstd, -mean * rstd), as
    ``_inorm_fwd_impl`` computes them."""
    mean = sums[:, 0] / rows
    var = torch.clamp(sums[:, 1] / rows - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + EPS)
    return rstd.contiguous(), (-mean * rstd).contiguous()


def instance_norm_act(x: torch.Tensor, act=None, plain: bool = False) -> torch.Tensor:
    """InstanceNorm(affine=False, eps=1e-5) over the spatial dims of a
    channels-last (N, *spatial, C) tensor, then ``act``.  ``plain`` runs the
    plain versions whatever the device (the reference a run on the card is
    held against)."""
    n, c = x.shape[0], x.shape[-1]
    rows = x.numel() // (n * c)
    x3 = x.reshape(n, rows, c)
    sums = pair_sums_plain(x3) if plain else pair_sums(x3)
    scale, shift = norm_coefficients(sums, rows)
    mapped = affine_map_act_plain if plain else affine_map_act
    return mapped(x3, scale, shift, act).reshape(x.shape)
