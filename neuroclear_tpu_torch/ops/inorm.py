"""Instance norm (affine-free, eps 1e-5, biased variance) with a fused
activation, forward and backward: the port of
``neuroclear_tpu/ops/pallas_ops.py``.

Four kernel wrappers, in ``csrc/inorm.cu``, carry it on the card, each with
its own launch count:
  * ``pair_sums``: per (n, c) [sum x, sum x^2] in f32 over an (N, R, C) view
    (replaces ``_pair_sums`` with b = None);
  * ``affine_map_act``: y = act(x * scale + shift) with per-(n, c) f32
    coefficients (replaces ``_affine_map``, with the ReLU or LeakyReLU(0.2)
    of ``instance_norm_act`` fused in); for training it also returns the
    pre-activation y;
  * ``pair_sums_gy``: per (n, c) [sum g', sum g' * y] with g' = g * act'(y)
    (replaces ``_pair_sums(g3, y3)`` of ``_inorm_bwd``, the activation's
    backward folded in);
  * ``bwd_map``: dx = rstd * (g' - mean g' - y * mean(g' y)) (replaces
    ``_bwd_map``).
Each wrapper runs its plain PyTorch version on a CPU tensor and launches its
kernel on a CUDA tensor (bf16 or f32), or raises.  ``instance_norm_act``
derives mean and rstd from the sums exactly as ``_inorm_fwd_impl`` does
(fold = 1); ``InstanceNormFn`` derives the backward's means as
``_inorm_bwd`` does.
"""

from __future__ import annotations

import torch

from . import build

EPS = 1e-5
ACTS = (None, "relu", "leaky")
LEAKY_SLOPE = 0.2          # nn/discriminators.py: leaky_relu(x, 0.2)
_ACT_CODE = {None: 0, "relu": 1, "leaky": 2}  # csrc/inorm.cu ACT_*
_TARGET_BLOCKS = 4 * 132   # pair_sums: about four blocks per H100 SM
_THREADS = 256             # csrc/inorm.cu THREADS


def _check_act(act) -> None:
    if act not in ACTS:
        raise NotImplementedError(f"activation {act!r}: the port has {ACTS}")


def activation(y: torch.Tensor, act) -> torch.Tensor:
    """act(y) in y's dtype: ReLU, or LeakyReLU(0.2) as ``x >= 0 ? x : 0.2 x``."""
    if act == "relu":
        return torch.relu(y)
    if act == "leaky":
        return torch.where(y >= 0, y, y * LEAKY_SLOPE)
    return y


def _acc(t: torch.Tensor) -> torch.Tensor:
    """t in the plain versions' arithmetic type: f32, or f64 for f64 input."""
    return t.double() if t.dtype == torch.float64 else t.float()


def act_grad_plain(g: torch.Tensor, y: torch.Tensor, act) -> torch.Tensor:
    """g * act'(y), with act'(0) as JAX takes it: 0 for relu, 1 for leaky."""
    if act == "relu":
        return torch.where(y > 0, g, torch.zeros_like(g))
    if act == "leaky":
        return torch.where(y >= 0, g, g * LEAKY_SLOPE)
    return g


def pair_sums_plain(x3: torch.Tensor) -> torch.Tensor:
    """(N, R, C) -> (N, 2, C) f32 (f64 for f64 input): [sum x, sum x^2]
    over R."""
    xf = _acc(x3)
    return torch.stack([xf.sum(dim=1), (xf * xf).sum(dim=1)], dim=1)


def pair_sums_gy_plain(g3: torch.Tensor, y3: torch.Tensor, act=None) -> torch.Tensor:
    """(N, R, C) twice -> (N, 2, C) f32: [sum g', sum g' * y] over R, with
    g' = g * act'(y) in f32 (f64 for f64 input)."""
    _check_act(act)
    yf = _acc(y3)
    gf = act_grad_plain(_acc(g3), yf, act)
    return torch.stack([gf.sum(dim=1), (gf * yf).sum(dim=1)], dim=1)


def affine_map_act_plain(x3: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                         act=None, keep_pre: bool = False):
    """y = x * scale + shift in f32 (f64 for f64 input), rounded once to x's
    dtype, then act(y) in that dtype.  Returns act(y), or (y, act(y)) when
    ``keep_pre``."""
    _check_act(act)
    y = (_acc(x3) * scale[:, None, :] + shift[:, None, :]).to(x3.dtype)
    a = activation(y, act)
    return (y, a) if keep_pre else a


def bwd_map_plain(g3: torch.Tensor, y3: torch.Tensor, rstd: torch.Tensor, mg: torch.Tensor,
                  mgy: torch.Tensor, act=None) -> torch.Tensor:
    """dx = rstd * ((g' - mg) - y * mgy) in f32 (f64 for f64 input) with
    g' = g * act'(y), rounded once to g's dtype."""
    _check_act(act)
    yf = _acc(y3)
    gf = act_grad_plain(_acc(g3), yf, act)
    dx = rstd[:, None, :] * ((gf - mg[:, None, :]) - yf * mgy[:, None, :])
    return dx.to(g3.dtype)


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


def _check_pair(a3: torch.Tensor, b3: torch.Tensor, what: str) -> None:
    _check_cuda_view(b3, what)
    if b3.shape != a3.shape or b3.dtype != a3.dtype or b3.device != a3.device:
        raise ValueError(f"{what}: operands differ: {tuple(a3.shape)} {a3.dtype} "
                         f"vs {tuple(b3.shape)} {b3.dtype}")


def _check_coef(name: str, t: torch.Tensor, x3: torch.Tensor, what: str) -> None:
    n, _, c = x3.shape
    if (t.dtype != torch.float32 or tuple(t.shape) != (n, c) or not t.is_contiguous()
            or t.device != x3.device or t.data_ptr() % 16):
        raise ValueError(f"{what} {name} must be a contiguous f32 ({n}, {c}) "
                         f"tensor on {x3.device}")


def _launch_sums(a3: torch.Tensor, b3, act) -> torch.Tensor:
    vec = _check_cuda_view(a3, "pair_sums")
    if b3 is not None:
        _check_pair(a3, b3, "pair_sums")
    n, rows, c = a3.shape
    rows_per_sweep = _THREADS // (c // vec)
    chunks = max(1, min(-(-_TARGET_BLOCKS // n), -(-rows // rows_per_sweep)))
    part = torch.empty((n, chunks, 2, c), dtype=torch.float32, device=a3.device)
    out = torch.empty((n, 2, c), dtype=torch.float32, device=a3.device)
    lib = build.load("inorm")
    with torch.cuda.device(a3.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.nc_pair_sums(a3.data_ptr(), None if b3 is None else b3.data_ptr(),
                                part.data_ptr(), out.data_ptr(), n, rows, c, chunks,
                                _ACT_CODE[act], int(a3.dtype == torch.bfloat16), stream)
    build.check(lib, code, "pair_sums launch")
    return out


def pair_sums(x3: torch.Tensor) -> torch.Tensor:
    """Per-(n, c) [sum x, sum x^2] in f32, shape (N, 2, C).  The kernel on a
    CUDA tensor, ``pair_sums_plain`` on a CPU tensor."""
    if x3.device.type == "cpu":
        return pair_sums_plain(x3)
    out = _launch_sums(x3, None, None)
    pair_sums.launches += 1
    return out


pair_sums.launches = 0


def pair_sums_gy(g3: torch.Tensor, y3: torch.Tensor, act=None) -> torch.Tensor:
    """Per-(n, c) [sum g', sum g' * y] in f32, shape (N, 2, C), g' = g *
    act'(y).  The kernel on a CUDA tensor, ``pair_sums_gy_plain`` on a CPU
    tensor."""
    if g3.device.type == "cpu":
        return pair_sums_gy_plain(g3, y3, act)
    _check_act(act)
    out = _launch_sums(g3, y3, act)
    pair_sums_gy.launches += 1
    return out


pair_sums_gy.launches = 0


def affine_map_act(x3: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                   act=None, keep_pre: bool = False):
    """act(x * scale + shift), scale and shift (N, C) f32; with ``keep_pre``
    the pair (pre-activation, activation).  The kernel on a CUDA tensor,
    ``affine_map_act_plain`` on a CPU tensor."""
    if x3.device.type == "cpu":
        return affine_map_act_plain(x3, scale, shift, act, keep_pre)
    _check_act(act)
    _check_cuda_view(x3, "affine_map_act")
    _check_coef("scale", scale, x3, "affine_map_act")
    _check_coef("shift", shift, x3, "affine_map_act")
    n, rows, c = x3.shape
    y = torch.empty_like(x3)
    pre = torch.empty_like(x3) if keep_pre and act is not None else None
    lib = build.load("inorm")
    with torch.cuda.device(x3.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.nc_affine_map_act(x3.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                                     None if pre is None else pre.data_ptr(), y.data_ptr(),
                                     n, rows, c, _ACT_CODE[act],
                                     int(x3.dtype == torch.bfloat16), stream)
    build.check(lib, code, "affine_map_act launch")
    affine_map_act.launches += 1
    if not keep_pre:
        return y
    return (y if pre is None else pre), y


affine_map_act.launches = 0


def bwd_map(g3: torch.Tensor, y3: torch.Tensor, rstd: torch.Tensor, mg: torch.Tensor,
            mgy: torch.Tensor, act=None) -> torch.Tensor:
    """dx = rstd * ((g' - mg) - y * mgy), g' = g * act'(y), coefficients (N, C)
    f32, dx in g's dtype.  The kernel on a CUDA tensor, ``bwd_map_plain`` on a
    CPU tensor."""
    if g3.device.type == "cpu":
        return bwd_map_plain(g3, y3, rstd, mg, mgy, act)
    _check_act(act)
    _check_cuda_view(g3, "bwd_map")
    _check_pair(g3, y3, "bwd_map")
    for name, t in (("rstd", rstd), ("mg", mg), ("mgy", mgy)):
        _check_coef(name, t, g3, "bwd_map")
    n, rows, c = g3.shape
    dx = torch.empty_like(g3)
    lib = build.load("inorm")
    with torch.cuda.device(g3.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.nc_bwd_map(g3.data_ptr(), y3.data_ptr(), rstd.data_ptr(), mg.data_ptr(),
                              mgy.data_ptr(), dx.data_ptr(), n, rows, c, _ACT_CODE[act],
                              int(g3.dtype == torch.bfloat16), stream)
    build.check(lib, code, "bwd_map launch")
    bwd_map.launches += 1
    return dx


bwd_map.launches = 0


def norm_coefficients(sums: torch.Tensor, rows: int):
    """(N, 2, C) sums -> (scale, shift) = (rstd, -mean * rstd), as
    ``_inorm_fwd_impl`` computes them."""
    mean = sums[:, 0] / rows
    var = torch.clamp(sums[:, 1] / rows - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + EPS)
    return rstd.contiguous(), (-mean * rstd).contiguous()


def _view3(x: torch.Tensor) -> torch.Tensor:
    n, c = x.shape[0], x.shape[-1]
    return x.contiguous().reshape(n, x.numel() // (n * c), c)


class InstanceNormFn(torch.autograd.Function):
    """The norm and its activation with the backward of ``_inorm_bwd``: the
    forward keeps the pre-activation y (in x's dtype, as JAX saves ``y3``)
    and rstd; the backward takes [sum g', sum g' y] by ``pair_sums_gy``,
    mg and mgy as their means, and dx by ``bwd_map``."""

    @staticmethod
    def forward(ctx, x, act, plain):
        x3 = _view3(x)
        rows = x3.shape[1]
        sums = (pair_sums_plain if plain else pair_sums)(x3)
        rstd, shift = norm_coefficients(sums, rows)
        mapped = affine_map_act_plain if plain else affine_map_act
        y3, a3 = mapped(x3, rstd, shift, act, keep_pre=True)
        ctx.save_for_backward(y3, rstd)
        ctx.act, ctx.plain, ctx.shape = act, plain, x.shape
        return a3.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        y3, rstd = ctx.saved_tensors
        rows = y3.shape[1]
        g3 = g.contiguous().reshape(y3.shape)
        sums = (pair_sums_gy_plain if ctx.plain else pair_sums_gy)(g3, y3, ctx.act)
        mg = (sums[:, 0] / rows).contiguous()
        mgy = (sums[:, 1] / rows).contiguous()
        dx3 = (bwd_map_plain if ctx.plain else bwd_map)(g3, y3, rstd, mg, mgy, ctx.act)
        return dx3.reshape(ctx.shape), None, None


def instance_norm_act(x: torch.Tensor, act=None, plain: bool = False) -> torch.Tensor:
    """InstanceNorm(affine=False, eps=1e-5) over the spatial dims of a
    channels-last (N, *spatial, C) tensor, then ``act``.  When a gradient is
    needed it runs ``InstanceNormFn``; otherwise only the activated output
    is written.  ``plain`` runs the plain versions whatever the device (the
    reference a run on the card is held against)."""
    _check_act(act)
    if torch.is_grad_enabled() and x.requires_grad:
        return InstanceNormFn.apply(x, act, plain)
    x3 = _view3(x)
    sums = pair_sums_plain(x3) if plain else pair_sums(x3)
    scale, shift = norm_coefficients(sums, x3.shape[1])
    mapped = affine_map_act_plain if plain else affine_map_act
    return mapped(x3, scale, shift, act).reshape(x.shape)
