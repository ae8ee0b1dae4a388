"""Instance norm (affine-free, eps 1e-5, biased variance) with a fused
activation, forward and backward: the port of
``neuroclear_tpu/ops/pallas_ops.py``.

Four kernel wrappers, in ``csrc/inorm.cu``, carry it on the card, each with
its own launch count:
  * ``pair_sums``: per (n, c) [sum x, sum x^2] in f32 over an (N, R, C) view
    and the coefficients (scale, shift) = (rstd, -mean * rstd) derived from
    them (replaces ``_pair_sums`` with b = None and the coefficient lines of
    ``_inorm_fwd_impl``);
  * ``affine_map_act``: y = act(x * scale + shift) with per-(n, c) f32
    coefficients (replaces ``_affine_map``, with the ReLU or LeakyReLU(0.2)
    of ``instance_norm_act`` fused in); for training it also returns the
    pre-activation y;
  * ``pair_sums_gy``: per (n, c) [sum g', sum g' * y] with g' = g * act'(y)
    and their means (mg, mgy) (replaces ``_pair_sums(g3, y3)`` of
    ``_inorm_bwd`` and its divisions, the activation's backward folded in);
  * ``bwd_map``: dx = rstd * (g' - mean g' - y * mean(g' y)) (replaces
    ``_bwd_map``).
Each wrapper runs its plain PyTorch version on a CPU tensor and launches its
kernel on a CUDA tensor (bf16 or f32), or raises.  The two statistics
wrappers are one launch each (``stats_plan`` tiles it), so on the card a
norm runs two launches forward and two backward and nothing between them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import build

EPS = 1e-5
ACTS = (None, "relu", "leaky")
LEAKY_SLOPE = 0.2          # nn/discriminators.py: leaky_relu(x, 0.2)
_ACT_CODE = {None: 0, "relu": 1, "leaky": 2}  # csrc/inorm.cu ACT_*
_THREADS = 256             # csrc/inorm.cu THREADS
# stats_plan: blocks of a streaming pass (two per H100 SM), the bytes of an
# operand that one block reads whole without a cross-block step, the
# partials' bytes that one block adds at the end, and the narrowest row
# segment (bytes) a block reads in either case
_STREAM_BLOCKS = 2 * 132
_ONE_BLOCK_BYTES = 64 << 10
_PARTIAL_BYTES = 128 << 10
_MIN_SEGMENT_ONE_BLOCK = 32
_MIN_SEGMENT_STREAM = 128
_MAX_TICKETS = 1024        # the counters of the cross-block step, per device


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


def pair_sums_plain(x3: torch.Tensor):
    """(N, R, C) -> ([sum x, sum x^2] over R as (N, 2, C), scale, shift) in
    f32 (f64 for f64 input), the coefficients by ``norm_coefficients``."""
    xf = _acc(x3)
    sums = torch.stack([xf.sum(dim=1), (xf * xf).sum(dim=1)], dim=1)
    return (sums, *norm_coefficients(sums, x3.shape[1]))


def pair_sums_gy_plain(g3: torch.Tensor, y3: torch.Tensor, act=None):
    """(N, R, C) twice -> ([sum g', sum g' * y] over R as (N, 2, C), mg, mgy)
    in f32 (f64 for f64 input), g' = g * act'(y), mg and mgy the sums over
    R."""
    _check_act(act)
    yf = _acc(y3)
    gf = act_grad_plain(_acc(g3), yf, act)
    sums = torch.stack([gf.sum(dim=1), (gf * yf).sum(dim=1)], dim=1)
    return (sums, *sum_means(sums, y3.shape[1]))


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


class StatsPlan(NamedTuple):
    """How csrc/inorm.cu's statistics kernel tiles an (N, R, C) view: blocks
    (chunk, s, n) for ``chunks`` x ``slabs`` x N, block (k, s, n) reading rows
    ``chunk_rows(k, R)`` of channels [s * slab, (s + 1) * slab).  With one
    chunk each block finishes its own (n, slab) group; with more, the groups'
    partials (``scratch`` f32 values) are added by each group's last block,
    which ``tickets`` counters (one per group) elect."""
    slab: int
    slabs: int
    chunks: int
    rows_per_chunk: int
    scratch: int
    tickets: int

    def chunk_rows(self, k: int, rows: int) -> range:
        return range(k * self.rows_per_chunk, min(rows, (k + 1) * self.rows_per_chunk))


def _split_slab(slab: int, vec: int, itemsize: int, min_segment: int) -> bool:
    half = slab // 2
    return half % vec == 0 and half * itemsize >= min_segment


@functools.lru_cache(maxsize=512)
def stats_plan(n: int, rows: int, c: int, itemsize: int) -> StatsPlan:
    """The plan for an (n, rows, c) view of ``itemsize``-byte elements, C / V
    dividing 256 (V = 16 / itemsize elements per 16-byte load).  When one
    block can read a slab of channels whole (at most ``_ONE_BLOCK_BYTES``,
    slabs narrowed to 32-byte row segments until about ``_STREAM_BLOCKS``
    blocks run), one chunk.  Otherwise slabs of at least 128-byte segments and
    chunks of whole sweeps of the block's rows, about ``_STREAM_BLOCKS``
    blocks, with no more than ``_PARTIAL_BYTES`` of partials per group."""
    vec = 16 // itemsize
    slab = c
    while n * (c // slab) < _STREAM_BLOCKS and _split_slab(slab, vec, itemsize,
                                                            _MIN_SEGMENT_ONE_BLOCK):
        slab //= 2
    if rows * slab * itemsize <= _ONE_BLOCK_BYTES:
        return StatsPlan(slab, c // slab, 1, rows, 0, 0)

    def per_group(slab):
        sweep = _THREADS * vec // slab  # rows per sweep of a block
        return max(1, min(-(-_STREAM_BLOCKS // (n * (c // slab))),
                          _PARTIAL_BYTES // (2 * slab * 4), -(-rows // sweep)))

    slab = c
    while (n * (c // slab) * per_group(slab) < _STREAM_BLOCKS
           and _split_slab(slab, vec, itemsize, _MIN_SEGMENT_STREAM)):
        slab //= 2
    sweep = _THREADS * vec // slab
    per_chunk = -(-rows // per_group(slab))
    per_chunk = -(-per_chunk // sweep) * sweep
    chunks = -(-rows // per_chunk)
    if chunks == 1:
        return StatsPlan(slab, c // slab, 1, rows, 0, 0)
    slabs = c // slab
    if n * slabs > _MAX_TICKETS:
        raise ValueError(f"pair_sums: {n * slabs} groups need more than {_MAX_TICKETS} tickets")
    return StatsPlan(slab, slabs, chunks, per_chunk, n * slabs * chunks * 2 * slab, n * slabs)


_TICKETS: dict = {}  # device index -> zeroed int32 counters of csrc/inorm.cu


def _tickets(device: torch.device) -> torch.Tensor:
    """The statistics kernel's counters on ``device``: allocated zeroed once;
    every launch leaves them zero again."""
    t = _TICKETS.get(device.index)
    if t is None:
        t = _TICKETS[device.index] = torch.zeros(_MAX_TICKETS, dtype=torch.int32, device=device)
    return t


def _launch_sums(a3: torch.Tensor, b3, act):
    """One launch: (sums (N, 2, C), c0 (N, C), c1 (N, C)), f32 views of one
    buffer whose coefficients lie as (2, N, C)."""
    _check_cuda_view(a3, "pair_sums")
    if b3 is not None:
        _check_pair(a3, b3, "pair_sums")
    n, rows, c = a3.shape
    plan = stats_plan(n, rows, c, a3.element_size())
    out = torch.empty(4 * n * c, dtype=torch.float32, device=a3.device)
    part = tickets = None
    if plan.chunks > 1:
        part = torch.empty(plan.scratch, dtype=torch.float32, device=a3.device)
        tickets = _tickets(a3.device)
    lib = build.load("inorm")
    with torch.cuda.device(a3.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.nc_pair_sums(a3.data_ptr(), None if b3 is None else b3.data_ptr(),
                                None if part is None else part.data_ptr(),
                                None if tickets is None else tickets.data_ptr(),
                                out.data_ptr(), out.data_ptr() + 8 * n * c, n, rows, c,
                                plan.slab, plan.chunks, plan.rows_per_chunk, _ACT_CODE[act],
                                int(a3.dtype == torch.bfloat16), stream)
    build.check(lib, code, "pair_sums launch")
    coef = out[2 * n * c:].view(2, n, c)
    return out[:2 * n * c].view(n, 2, c), coef[0], coef[1]


def pair_sums(x3: torch.Tensor):
    """(sums, scale, shift): per-(n, c) [sum x, sum x^2] in f32, shape (N, 2,
    C), and the norm's coefficients (rstd, -mean * rstd), each (N, C) f32.
    The kernel on a CUDA tensor (one launch), ``pair_sums_plain`` on a CPU
    tensor."""
    if x3.device.type == "cpu":
        return pair_sums_plain(x3)
    out = _launch_sums(x3, None, None)
    pair_sums.launches += 1
    return out


pair_sums.launches = 0


def pair_sums_gy(g3: torch.Tensor, y3: torch.Tensor, act=None):
    """(sums, mg, mgy): per-(n, c) [sum g', sum g' * y] in f32, shape (N, 2,
    C), g' = g * act'(y), and their means over R, each (N, C) f32.  The
    kernel on a CUDA tensor (one launch), ``pair_sums_gy_plain`` on a CPU
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


def sum_means(sums: torch.Tensor, rows: int):
    """(N, 2, C) sums -> their means over ``rows``, (mg, mgy), as
    ``_inorm_bwd`` computes them."""
    return (sums[:, 0] / rows).contiguous(), (sums[:, 1] / rows).contiguous()


def _view3(x: torch.Tensor) -> torch.Tensor:
    n, c = x.shape[0], x.shape[-1]
    return x.contiguous().reshape(n, x.numel() // (n * c), c)


class InstanceNormFn(torch.autograd.Function):
    """The norm and its activation with the backward of ``_inorm_bwd``: the
    forward keeps the pre-activation y (in x's dtype, as JAX saves ``y3``)
    and rstd; the backward takes mg and mgy by ``pair_sums_gy`` and dx by
    ``bwd_map``."""

    @staticmethod
    def forward(ctx, x, act, plain):
        x3 = _view3(x)
        _, rstd, shift = (pair_sums_plain if plain else pair_sums)(x3)
        mapped = affine_map_act_plain if plain else affine_map_act
        y3, a3 = mapped(x3, rstd, shift, act, keep_pre=True)
        ctx.save_for_backward(y3, rstd)
        ctx.act, ctx.plain, ctx.shape = act, plain, x.shape
        return a3.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        y3, rstd = ctx.saved_tensors
        g3 = g.contiguous().reshape(y3.shape)
        _, mg, mgy = (pair_sums_gy_plain if ctx.plain else pair_sums_gy)(g3, y3, ctx.act)
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
    _, scale, shift = (pair_sums_plain if plain else pair_sums)(x3)
    mapped = affine_map_act_plain if plain else affine_map_act
    return mapped(x3, scale, shift, act).reshape(x.shape)
