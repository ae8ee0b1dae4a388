#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (neuroclear_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, each printed with its name, seconds and result:
  1. environment: torch/CUDA versions and the card (exits nonzero without one);
  2. build: every CUDA kernel from ops/csrc with nvcc (sm_90a), each
     library's registers, shared memory and spills (ptxas) and its wgmma
     count in SASS (``HGMMA``; fails if the two wgmma kernels have none);
  3. kernels: each inference kernel against its plain PyTorch version on the
     card, in bf16 at the shapes one 2 x 140^3 tile batch of the inference
     path gives it (the dense-K conv at the four half-resolution 128-output
     convs, and its autograd Function once at a 54^3 training shape), with
     its time, the plain version's, one PyTorch library call's where there
     is one, and its bound at the H100's published peaks; the norm's
     statistics also against f64 sums, their coefficients against the
     PyTorch glue on the kernel's sums (whose time is printed beside), and a
     second call required bitwise equal;
  4. kernels (training): the same for the training step's kernels at the
     shapes one 108^3 Apollo step gives them: the conv's input gradient
     (64 -> 64 and 64 -> 128) and weight gradient (cin 64 and 128, run
     twice and required bitwise equal), the norm's statistics in both forms
     (each required to be one device operation per call under
     torch.profiler), its forward map with the pre-activation kept and its
     backward map, at the generator's and the discriminators' shapes;
  5. slice: ``neuroclear_tpu_torch.test_dice.main`` on a synthetic 260^3
     uint16 ``.npy`` volume with random Kaiming UNetDeconv weights in the JAX
     checkpoint format (27 tiles of 140^3, bf16, tile_batch 2), the launch
     counts of every kernel checked, and the output held against the same
     pipeline on the plain versions on the card;
  6. dice CLI: ``neuroclear_tpu_torch.test_dice.main`` with
     ``NEUROCLEAR_PALLAS_CONV=1`` on a synthetic 260^3 uint16 TIFF and a
     ground-truth TIFF, the slice's weights and flags, ``--save_volume
     --save_projections``: the dense-K conv launched exactly four times per
     generator application beside the slice's kernels, the TIFF streamed
     during the harvest read back equal to the volume in memory, the output
     held on the slice's bounds against the slice's f32 plain output and
     against the same route on the plain versions in bf16, and the device
     metrics against the host float64 path;
  7. train: ``neuroclear_tpu_torch.train_onecube.main`` on a synthetic 160^3
     uint16 volume at the production Apollo configuration (108^3 crops,
     bf16, Kaiming weights from the seed): one warm-up step and five timed
     ones on the card's clock (the trainer syncs only at the end), the
     launches of every kernel per step checked exactly; then one step from
     identical weights, crop and draws three ways (kernels in bf16, plain
     versions in bf16, plain versions in f32), the kernel path's losses and
     gradients held against f32 no worse than the plain bf16 path's, and
     each gradient tensor against the plain bf16 step's; and the written G_A
     checkpoint run through ``test_dice.main``;
  8. profile (only with --profile): a warm run of the slice's tile pipeline
     (without and with the dense-K conv) and a warm training step under
     torch.profiler, device time by kernel and the device's idle share, and
     warm steps with and without a sync after each.
Then a ``{"kernels": [...]}`` line (the forward norm's two rows also carry
the 108^3 step's sums as ``step_*``), the nvidia-smi name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.  Any failure raises and
exits nonzero before that line.  The whole run has a 600 s budget.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

import neuroclear_tpu_torch.ops as kernel_ops
from neuroclear_tpu_torch import test_dice, train_onecube
from neuroclear_tpu_torch.data.dicing import DiceGrid
from neuroclear_tpu_torch.data.singlevolume_dataset import SingleVolumeDataset
from neuroclear_tpu_torch.models.axial_to_lateral_gan_apollo_model import (
    D_NAMES, G_NAMES, LOSS_NAMES, ApolloModel)
from neuroclear_tpu_torch.nn.factory import define_G
from neuroclear_tpu_torch.nn.generators import UNetDeconv
from neuroclear_tpu_torch.ops import build, conv3x3, inorm, wconv
from neuroclear_tpu_torch.parallel import metrics as device_metrics
from neuroclear_tpu_torch.parallel.dice_infer import DiceInferencePipeline
from neuroclear_tpu_torch.utils import tiffio
from neuroclear_tpu_torch.utils.imageops import dtype_inv_scale, pad_for_dicing
from neuroclear_tpu_torch.utils.weights import kaiming_flat, params_from_numpy

BUDGET_S = 600
WGMMA_SOURCES = ("conv3x3", "wconv_dw")  # the kernels built on wgmma and TMA
# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
SLEEP_CYCLES_S = 1.98e9  # the H100 SXM's boost clock: torch.cuda._sleep counts cycles

# One 2 x 140^3 tile batch of the main path (dice 120, border_cut 10): for
# the convs (x shape, cout), one launch each per batch; for the norms
# (shape, launches per batch)
TILE = 140
CONV_SHAPES = [((2, TILE, TILE, TILE, 64), 64),   # double_conv1.conv1
               ((2, TILE, TILE, TILE, 128), 64)]  # ex_conv1_1.conv0
# The dense-K conv (NEUROCLEAR_PALLAS_CONV=1) at the half-resolution
# 128-output convs
CONV3X3_SHAPES = [((2, TILE // 2, TILE // 2, TILE // 2, 64), 128),    # double_conv2.conv0
                  ((2, TILE // 2, TILE // 2, TILE // 2, 128), 128),   # double_conv2.conv1
                  ((2, TILE // 2, TILE // 2, TILE // 2, 256), 128),   # ex_double_conv2.conv0
                  ((2, TILE // 2, TILE // 2, TILE // 2, 128), 128)]   # ex_double_conv2.conv1
NORM_SHAPES = [((2, TILE ** 3, 64), 3),           # double_conv1 x2, ex_conv1_1
               ((2, (TILE // 2) ** 3, 128), 4),   # double_conv2 x2, ex_double_conv2 x2
               ((2, (TILE // 4) ** 3, 256), 3)]   # bottom_layer x3

# Slice: the shipped inference configuration (README.md, test_dice.py example)
SLICE_ARGS = ["--dice_size", "120", "120", "120", "--overlap", "15", "--border_cut", "10",
              "--tile_batch", "2", "--precision", "bfloat16", "--data_type", "uint16"]
VOLUME = 260
# bf16 output held against the f32 output of the plain versions (TF32 off):
# the kernels change only the order of f32 sums, so the kernel path may be no
# less accurate than the plain versions run in bf16.  Its mean error may
# exceed theirs by a quarter, its worst voxel by two bf16 steps at the top of
# the range (2^-8 apart in [0.5, 1): 256 uint16 LSB each).
SLICE_MEAN_RATIO = 1.25
SLICE_MAX_EXTRA_LSB = 2 * 256
# The kernel path against the plain versions, both bf16: sum order flips
# bf16 roundings through ten norms (measured on an H100: max 1280, mean 83
# LSB at seed 0).  Bound: 8 bf16 steps for the worst voxel, half a step for
# the mean.
SLICE_KP_MAX_LSB = 8 * 256
SLICE_KP_MEAN_LSB = 128

# Train: the production Apollo configuration (train_onecube.py:11-18,
# bench.py leg_train), bf16 compute with f32 master weights
CROP = 108
TRAIN_VOLUME = 160
TRAIN_ITERS = 6  # one warm-up step, then five timed ones
TRAIN_ARGS = ["--model", "axial_to_lateral_gan_apollo", "--netG", "unet_deconv",
              "--netG_B", "deep_linear_gen", "--netD", "basic", "--gan_mode", "lsgan",
              "--init_type", "kaiming", "--norm", "instance", "--lambda_A", "5",
              "--lambda_plane", "1", "1", "1", "--lr_policy", "constant",
              "--randomize_projection_depth", "--projection_depth", "10",
              "--crop_size", str(CROP), str(CROP), str(CROP), "--precision", "bfloat16",
              "--preprocess", "randomcrop_randomflip_addColorChannel_addBatchChannel"]
# Launches per training step, derived from the nets: the W-pair conv serves
# double_conv1.conv1 and ex_conv1_1.conv0 of G_A and feat1 of G_B, forward
# and backward; every one of the 64 instance norms (G_A's 10, and 3 in each
# of the 18 discriminator applications: 6 probes in the G loss, 12 in the D
# loss) is differentiated.
STEP_LAUNCHES = {"wconv3x3x3": 3, "wconv_dx": 3, "wconv_dw": 3, "pair_sums": 64,
                 "affine_map_act": 64, "pair_sums_gy": 64, "bwd_map": 64, "conv3x3": 0}
# (forward cin, launches per step): dx has cout = cin, dw the (27, 64, cin) shape
TRAIN_CONV = [(64, 2), (128, 1)]
# (N, R, C), launches per step, activation after the norm
TRAIN_NORM = [((1, CROP ** 3, 64), 3, "relu"), ((1, (CROP // 2) ** 3, 128), 4, "relu"),
              ((1, (CROP // 4) ** 3, 256), 3, "relu"), ((1, 27 ** 2, 128), 18, "leaky"),
              ((1, 13 ** 2, 256), 18, "leaky"), ((1, 12 ** 2, 512), 18, "leaky")]
# The kernel step against the f32 plain step, beside the plain bf16 step (same
# weights, crop and draws): bf16 rounding of a random-weight GAN step moves
# losses by percents and G_A's gradients by tens of percent (measured on the
# CPU against the JAX package's own bf16 step, tests/test_torch_train_step.py),
# and two bf16 paths that round at different places land at different such
# distances.  Per loss: at most twice the plain path's distance plus 1% of the
# loss.  G_A, G_B and the four discriminators pooled: relative L2 at most 1.5
# times the plain path's plus 0.02.  Per gradient tensor, a looser tripwire:
# three times plus 0.05.  Pre-norm biases (true gradient 0) are left out.
# These hold G_A loosely: bf16 moves its gradients ~47% from f32 on both paths.
# The kernel step against the plain bf16 step, tensor by tensor (relative L2,
# limit per net), holds the backward kernels tighter.  Measured on an H100 at
# seed 0 (deterministic): largest G_A 0.394, G_B 0.0039, discriminators 0.119;
# a zeroed dx gives 1.0 on the tensors it feeds, a halved dw 0.50 on G_B's
# feat1, a bwd_map without its mgy term 1.8 on a discriminator.
STEP_LOSS_RATIO, STEP_LOSS_REL = 2.0, 1e-2
STEP_GRAD_RATIO, STEP_GRAD_ABS = 1.5, 0.02
STEP_TENSOR_RATIO, STEP_TENSOR_ABS = 3.0, 0.05
STEP_DIRECT = {"G_A": 0.6, "G_B": 0.04, "D": 0.3}
PRE_NORM = ("double_conv", "bottom_layer", "ex_double_conv2", "ex_conv1_1", "conv1",
            "conv2", "conv3")

T_START = time.monotonic()


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Prints the phase's name, then its seconds and result; a failure
    propagates with its traceback."""

    def __init__(self, name: str):
        self.name = name
        self.result = "ok"

    def __enter__(self):
        self.t0 = time.monotonic()
        log(f"[{self.name}] start")
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.monotonic() - self.t0
        if exc_type is None:
            log(f"[{self.name}] {dt:.1f} s: {self.result}")
            spent = time.monotonic() - T_START
            if spent > BUDGET_S:
                raise RuntimeError(f"over the {BUDGET_S} s budget after {self.name}: {spent:.0f} s")
        else:
            log(f"[{self.name}] {dt:.1f} s: FAILED ({exc_type.__name__}: {exc})")
        return False


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps calls, after one warm-up call.  A
    sleep kernel holds the stream while the host queues the calls, so that a
    call's host cost (a wrapper's checks and launch, 30-80 us) is not
    counted where it exceeds the kernel's own time; the sleep is lengthened
    until the last call is queued before it ends."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    sleep_s = 2.0 * (time.perf_counter() - t0) * reps + 1e-3
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    while True:
        torch.cuda._sleep(int(sleep_s * SLEEP_CYCLES_S))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()  # the sleep still ran when the last call was queued
        torch.cuda.synchronize()
        if held or sleep_s > 1.0:
            return start.elapsed_time(end) / reps
        sleep_s *= 4.0


def bound_ms(nbytes: float, ops: float, peak_ops: float) -> tuple[float, float]:
    """(bytes time, operations time) in ms at the published peaks."""
    return nbytes / PEAK_BYTES_S * 1e3, ops / peak_ops * 1e3


def within_bf16_ulp(k: torch.Tensor, p: torch.Tensor) -> bool:
    """Every element of k is equal to p or one bf16 step away from it."""
    k, p = k.float(), p.float()
    m = torch.maximum(k.abs(), p.abs())
    _, e = torch.frexp(m)
    step = torch.ldexp(torch.ones_like(m), e - 8)  # bf16: 8 significant bits
    return bool(((k - p).abs() <= torch.where(m > 0, step, torch.zeros_like(m))).all())


def check_conv(gen, dev, mod, shapes, timed=True) -> dict:
    """A conv kernel wrapper (``wconv`` or ``conv3x3``) vs its plain version
    and cuDNN's f32 conv at the path's shapes, summed over one tile batch
    (``timed=False``: the checks alone)."""
    name = mod.__name__.rsplit(".", 1)[-1]
    tot = _tot()
    for shape, cout in shapes:
        b, d, h, w, cin = shape
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        wgt = (torch.randn((cout, cin, 3, 3, 3), generator=gen, device=dev)
               * math.sqrt(2.0 / (27 * cin))).to(torch.bfloat16)
        bias = torch.randn(cout, generator=gen, device=dev) * 0.1
        wt = wconv.pack_weight(wgt)
        y = mod.conv3d(x, wt, bias)
        torch.cuda.synchronize()
        p = mod.conv3d_plain(x, wt, bias)
        err = (y.float() - p.float()).abs()
        # one bf16 rounding of sums that differ in order only: one bf16 step
        # (2^-7 relative) plus a floor for outputs near zero
        tol = 2.0 ** -7 * p.float().abs() + 2.0 ** -12 * p.float().abs().max()
        max_err = err.max().item()
        if not bool((err <= tol).all()):
            raise AssertionError(f"{name} {shape}->{cout}: max error {max_err} over tolerance")
        del p, err
        x_cl = x.permute(0, 4, 1, 2, 3)  # channels-last NCDHW view for cuDNN
        # and against cuDNN's f32 conv (TF32 off) of the same bf16 inputs
        ref32 = F.conv3d(x_cl.float(), wgt.float(), bias, 1, 1).permute(0, 2, 3, 4, 1)
        if not bool(((y.float() - ref32).abs() <= tol).all()):
            raise AssertionError(f"{name} {shape}->{cout}: off F.conv3d in f32")
        del ref32, tol
        if not timed:
            continue
        bias16 = bias.to(torch.bfloat16)
        ms = cuda_ms(lambda: mod.conv3d(x, wt, bias), 5)
        plain = cuda_ms(lambda: mod.conv3d_plain(x, wt, bias), 1)
        lib = cuda_ms(lambda: F.conv3d(x_cl, wgt, bias16, 1, 1), 5)
        m = b * d * h * w
        flops = 2.0 * m * cout * 27 * cin
        tb, to = bound_ms(m * cin * 2 + 27 * cin * cout * 2 + cout * 4 + m * cout * 2, flops,
                          PEAK_BF16_FLOPS)
        log(f"  {name} {shape}->{cout}: max_abs_err {max_err:.4g}  kernel {ms:.3f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s)  plain {plain:.3f} ms  F.conv3d {lib:.3f} ms  "
            f"bound {max(tb, to):.3f} ms")
        _add(tot, 1, max_err, ms=ms, plain_ms=plain, library_ms=lib, tb=tb, to=to)
        del x, y, x_cl
        torch.cuda.empty_cache()
    log(f"  {name} per tile batch: kernel {tot['ms']:.3f} ms, F.conv3d {tot['library_ms']:.3f} "
        f"ms, bound {max(tot['tb'], tot['to']):.3f} ms")
    return tot


def check_conv3x3_fn(gen, dev) -> None:
    """Conv3x3Fn at ex_double_conv2.conv0 of a 108^3 step: the kernel forward
    and PyTorch's bf16 conv gradients against autograd of the plain version
    in f32 on the same bf16 values: one bf16 rounding of the kernel path's
    outputs, plus a floor of one bf16 step of the largest entry for sums that
    cancel."""
    half = CROP // 2
    x = torch.randn((1, half, half, half, 256), generator=gen, device=dev).to(torch.bfloat16)
    wgt = (torch.randn((128, 256, 3, 3, 3), generator=gen, device=dev)
           * math.sqrt(2.0 / (27 * 256))).to(torch.bfloat16)
    bias = torch.randn(128, generator=gen, device=dev) * 0.1
    gy = torch.randn((1, half, half, half, 128), generator=gen, device=dev).to(torch.bfloat16)
    runs = []
    for dt, fn in ((torch.bfloat16, lambda a, wp, c: conv3x3.Conv3x3Fn.apply(a, wp, c, False)),
                   (torch.float32, conv3x3.conv3d_plain)):
        xr, wr = (t.detach().to(dt).requires_grad_(True) for t in (x, wgt))
        br = bias.clone().requires_grad_(True)
        y = fn(xr, wconv.pack_weight(wr), br)
        y.backward(gy.to(dt))
        runs.append([y.detach().float(), xr.grad.float(), wr.grad.float(), br.grad])
    torch.cuda.synchronize()
    got, ref = runs
    for name, k, p in zip(("y", "dx", "dw", "db"), got, ref):
        tol = 2.0 ** -7 * p.abs() + 2.0 ** -8 * p.abs().max()
        e = (k - p).abs().max().item()
        log(f"  Conv3x3Fn (1,{half}^3,256)->128 {name}: max_abs_err {e:.4g} of "
            f"{p.abs().max().item():.4g}")
        if not bool(((k - p).abs() <= tol).all()):
            raise AssertionError(f"Conv3x3Fn {name}: max error {e} over tolerance")
    del x, gy, runs, got, ref
    torch.cuda.empty_cache()


def within_f32_ulp(k: torch.Tensor, p: torch.Tensor, ulps: int = 2) -> bool:
    """Every element of k within ``ulps`` f32 units in the last place of the
    larger of |k| and |p|."""
    m = torch.maximum(k.abs(), p.abs())
    _, e = torch.frexp(m)
    return bool(((k - p).abs() <= ulps * torch.ldexp(torch.ones_like(m), e - 24)).all())


def check_stats(fn, args, ref, mag, glue, label: str) -> tuple:
    """A statistics kernel's (sums, c0, c1): the sums within 1e-5 of the f64
    sums of magnitudes, the coefficients within 2 f32 ulp of the PyTorch
    glue (``norm_coefficients`` or ``sum_means``) on the kernel's own sums,
    and a second call bit-equal."""
    out = fn(*args)
    again = fn(*args)
    s, c0, c1 = out
    if not bool(((s.double() - ref).abs() <= 1e-5 * mag).all()):
        raise AssertionError(f"{label}: sums off the f64 sums")
    g0, g1 = glue(s)
    if not (within_f32_ulp(c0, g0) and within_f32_ulp(c1, g1)):
        raise AssertionError(f"{label}: coefficients more than 2 f32 ulp off the glue")
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise AssertionError(f"{label}: two calls on the same inputs differ")
    return out


def one_device_operation(fn, label: str) -> None:
    """One call of a warm wrapper under torch.profiler runs exactly one
    device operation: the statistics, the cross-block step and the
    coefficients are one launch, with no PyTorch operation around it."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    ops = sum(r[2] for r in rows)
    log(f"  {label}: {ops} device operation(s) per call: "
        + ", ".join(f"{k[:60]} x{c}" for k, _, c in rows))
    if ops != 1:
        raise AssertionError(f"{label}: {ops} device operations per call, expected 1")


def check_norm(gen, dev, timed=True) -> tuple[dict, dict]:
    """pair_sums and affine_map_act kernels vs their plain versions at the
    path's three norm shapes (``timed=False``: the checks alone)."""
    sums, amap = _tot(), _tot(library=False)
    glue = 0.0
    for shape, mult in NORM_SHAPES:
        n, r, c = shape
        x3 = (torch.randn(shape, generator=gen, device=dev) * 2.0 + 0.5).to(torch.bfloat16)
        xd = x3.double()
        ref = torch.stack([xd.sum(1), (xd * xd).sum(1)], 1)
        mag = torch.stack([xd.abs().sum(1), (xd * xd).sum(1)], 1)
        del xd
        s, sc, sh = check_stats(inorm.pair_sums, (x3,), ref, mag,
                                lambda t: inorm.norm_coefficients(t, r), f"pair_sums {shape}")
        # f32 sums of bf16 values against f64: 1e-5 of the sum of magnitudes
        sp = inorm.pair_sums_plain(x3)[0]
        if not bool(((sp.double() - ref).abs() <= 1e-5 * mag).all()):
            raise AssertionError(f"pair_sums plain {shape} off the f64 sums")
        err_s = (s - sp).abs().max().item()
        y = inorm.affine_map_act(x3, sc, sh, "relu")
        yp = inorm.affine_map_act_plain(x3, sc, sh, "relu")
        if not within_bf16_ulp(y, yp):
            raise AssertionError(f"affine_map_act {shape}: more than one bf16 step off")
        err_m = (y.float() - yp.float()).abs().max().item()
        del ref, mag, sp, y, yp
        if timed:
            ms_s = cuda_ms(lambda: inorm.pair_sums(x3), 10)
            pl_s = cuda_ms(lambda: inorm.pair_sums_plain(x3), 3)
            lib_s = cuda_ms(lambda: torch.var_mean(x3, dim=1, correction=0), 10)
            gl = cuda_ms(lambda: inorm.norm_coefficients(s, r), 10)
            ms_m = cuda_ms(lambda: inorm.affine_map_act(x3, sc, sh, "relu"), 10)
            pl_m = cuda_ms(lambda: inorm.affine_map_act_plain(x3, sc, sh, "relu"), 3)
            elems = n * r * c
            tb_s, to_s = bound_ms(elems * 2 + 4 * n * c * 4, 3.0 * elems, PEAK_F32_FLOPS)
            tb_m, to_m = bound_ms(2 * elems * 2 + 2 * n * c * 4, 3.0 * elems, PEAK_F32_FLOPS)
            log(f"  pair_sums {shape}: max_abs_err {err_s:.4g} (kernel vs plain f32 sums)  "
                f"kernel {ms_s:.4f} ms (with the coefficients)  plain {pl_s:.4f} ms  var_mean "
                f"{lib_s:.4f} ms  glue it replaces (norm_coefficients) {gl:.4f} ms  bound "
                f"{max(tb_s, to_s):.4f} ms  plan {inorm.stats_plan(n, r, c, 2)}")
            log(f"  affine_map_act {shape}: max_abs_err {err_m:.4g}  kernel {ms_m:.4f} ms  plain "
                f"{pl_m:.4f} ms  bound {max(tb_m, to_m):.4f} ms")
            _add(sums, mult, err_s, ms=ms_s, plain_ms=pl_s, library_ms=lib_s, tb=tb_s, to=to_s)
            _add(amap, mult, err_m, ms=ms_m, plain_ms=pl_m, tb=tb_m, to=to_m)
            glue += mult * gl
        del x3, s, sc, sh
        torch.cuda.empty_cache()
    if timed:
        log(f"  pair_sums per tile batch: kernel {sums['ms']:.4f} ms, the glue it replaces "
            f"{glue:.4f} ms")
    return sums, amap


def _tot(library=True) -> dict:
    return {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0 if library else None, "tb": 0.0,
            "to": 0.0, "err": 0.0}


def _add(tot: dict, mult: int, err: float, **vals) -> None:
    for key, v in vals.items():
        if v is not None:
            tot[key] += mult * v
    tot["err"] = max(tot["err"], err)


def check_train_conv(gen, dev, timed=True) -> tuple[dict, dict]:
    """The conv's input and weight gradients at one 108^3 training step's
    shapes, against their plain versions and cuDNN's f32 gradients
    (``timed=False``: the checks alone)."""
    dx_tot, dw_tot = _tot(), _tot()
    m = CROP ** 3
    for cin, mult in TRAIN_CONV:
        shape = (1, CROP, CROP, CROP)
        x = torch.randn(shape + (cin,), generator=gen, device=dev).to(torch.bfloat16)
        g = torch.randn(shape + (64,), generator=gen, device=dev).to(torch.bfloat16)
        wgt = (torch.randn((64, cin, 3, 3, 3), generator=gen, device=dev)
               * math.sqrt(2.0 / (27 * cin))).to(torch.bfloat16)
        wt = wconv.pack_weight(wgt)
        x_cl, g_cl = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)

        dx = wconv.conv3d_dx(g, wt)
        torch.cuda.synchronize()
        p = wconv.conv3d_dx_plain(g, wt).float()
        tol = 2.0 ** -7 * p.abs() + 2.0 ** -12 * p.abs().max()
        err_dx = (dx.float() - p).abs().max().item()
        if not bool(((dx.float() - p).abs() <= tol).all()):
            raise AssertionError(f"wconv dx cin {cin}: max error {err_dx} over one bf16 step")
        ref32 = torch.nn.grad.conv3d_input(x_cl.shape, wgt.float(), g_cl.float(), padding=1)
        if not bool(((dx.float() - ref32.permute(0, 2, 3, 4, 1)).abs() <= tol).all()):
            raise AssertionError(f"wconv dx cin {cin}: off cuDNN's f32 input gradient")
        del p, tol, ref32
        flops = 2.0 * m * 64 * 27 * cin
        if timed:
            ms = cuda_ms(lambda: wconv.conv3d_dx(g, wt), 5)
            plain = cuda_ms(lambda: wconv.conv3d_dx_plain(g, wt), 1)
            lib = cuda_ms(lambda: torch.nn.grad.conv3d_input(x_cl.shape, wgt, g_cl, padding=1), 5)
            tb, to = bound_ms(m * 64 * 2 + 27 * cin * 64 * 2 + m * cin * 2, flops,
                              PEAK_BF16_FLOPS)
            log(f"  wconv dx (1,{CROP}^3,64)->{cin}: max_abs_err {err_dx:.4g}  kernel {ms:.3f} "
                f"ms ({flops / ms / 1e9:.1f} TFLOP/s)  plain {plain:.3f} ms  conv3d_input "
                f"{lib:.3f} ms  bound {max(tb, to):.3f} ms")
            _add(dx_tot, mult, err_dx, ms=ms, plain_ms=plain, library_ms=lib, tb=tb, to=to)
        del dx

        dw = wconv.conv3d_dw(x, g)
        torch.cuda.synchronize()
        p = wconv.conv3d_dw_plain(x, g)
        mag = wconv.conv3d_dw_plain(x.abs(), g.abs())
        err_dw = (dw - p).abs().max().item()
        # f32 sums of the same bf16 products over 1.26 M voxels in another order
        if not bool(((dw - p).abs() <= 1e-4 * mag).all()):
            raise AssertionError(f"wconv dw cin {cin}: max error {err_dw} over 1e-4 of the "
                                 "sum of magnitudes")
        ref32 = torch.nn.grad.conv3d_weight(x_cl.float(), wgt.shape, g_cl.float(), padding=1)
        if not bool(((dw - wconv.pack_weight(ref32)).abs() <= 1e-4 * mag).all()):
            raise AssertionError(f"wconv dw cin {cin}: off cuDNN's f32 weight gradient")
        # the split-K sums are combined in a fixed order: the same bits every run
        if not torch.equal(dw, wconv.conv3d_dw(x, g)):
            raise AssertionError(f"wconv dw cin {cin}: two runs on the same inputs differ")
        del p, mag, ref32
        if timed:
            ms = cuda_ms(lambda: wconv.conv3d_dw(x, g), 5)
            plain = cuda_ms(lambda: wconv.conv3d_dw_plain(x, g), 1)
            lib = cuda_ms(lambda: torch.nn.grad.conv3d_weight(x_cl, wgt.shape, g_cl, padding=1),
                          5)
            tb, to = bound_ms(m * cin * 2 + m * 64 * 2 + 27 * cin * 64 * 4, flops,
                              PEAK_BF16_FLOPS)
            log(f"  wconv dw (1,{CROP}^3,{cin}) x (1,{CROP}^3,64): max_abs_err {err_dw:.4g} (of "
                f"|dw| up to {dw.abs().max().item():.4g})  kernel {ms:.3f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s)  plain {plain:.3f} ms  conv3d_weight "
                f"{lib:.3f} ms  bound {max(tb, to):.3f} ms")
            _add(dw_tot, mult, err_dw, ms=ms, plain_ms=plain, library_ms=lib, tb=tb, to=to)
            # and the forward at this step's shapes (its row keeps the inference batch)
            bias = torch.zeros(64, device=dev)
            fwd = cuda_ms(lambda: wconv.conv3d(x, wt, bias), 5)
            log(f"  wconv forward (1,{CROP}^3,{cin})->64: kernel {fwd:.3f} ms")
        del x, g, x_cl, g_cl, dw
        torch.cuda.empty_cache()
    return dx_tot, dw_tot


def check_train_norm(gen, dev, timed=True) -> dict:
    """The norm's statistics (both forms), its forward map keeping the
    pre-activation and its backward map at one 108^3 training step's shapes
    (``timed=False``: the checks alone).  Returns the step's totals:
    {"sums": forward statistics, "amap": forward map, "sums_gy", "bmap"}."""
    tot = {"sums": _tot(), "amap": _tot(library=False), "sums_gy": _tot(),
           "bmap": _tot(library=False)}
    glue = {"sums": 0.0, "sums_gy": 0.0}
    for shape, mult, act in TRAIN_NORM:
        n, r, c = shape
        x = (torch.randn(shape, generator=gen, device=dev) * 2.0 + 0.5).to(torch.bfloat16)
        g = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        xd = x.double()
        ref = torch.stack([xd.sum(1), (xd * xd).sum(1)], 1)
        mag = torch.stack([xd.abs().sum(1), (xd * xd).sum(1)], 1)
        del xd
        s_f, sc, sh = check_stats(inorm.pair_sums, (x,), ref, mag,
                                  lambda t: inorm.norm_coefficients(t, r), f"pair_sums {shape}")
        err_f = (s_f - inorm.pair_sums_plain(x)[0]).abs().max().item()
        pre, a = inorm.affine_map_act(x, sc, sh, act, keep_pre=True)
        pre_p, a_p = inorm.affine_map_act_plain(x, sc, sh, act, keep_pre=True)
        if not (within_bf16_ulp(pre, pre_p) and within_bf16_ulp(a, a_p)):
            raise AssertionError(f"affine_map_act keep_pre {act} {shape}: off its plain version")
        err_a = max((pre.float() - pre_p.float()).abs().max().item(),
                    (a.float() - a_p.float()).abs().max().item())
        gd = inorm.act_grad_plain(g.double(), pre.double(), act)
        ref = torch.stack([gd.sum(1), (gd * pre.double()).sum(1)], 1)
        mag = torch.stack([gd.abs().sum(1), (gd * pre.double()).abs().sum(1)], 1)
        del gd
        s, mg, mgy = check_stats(inorm.pair_sums_gy, (g, pre, act), ref, mag,
                                 lambda t: inorm.sum_means(t, r), f"pair_sums_gy {act} {shape}")
        sp = inorm.pair_sums_gy_plain(g, pre, act)[0]
        if not bool(((sp.double() - ref).abs() <= 1e-5 * mag).all()):
            raise AssertionError(f"pair_sums_gy plain {shape}: off the f64 sums")
        err_s = (s - sp).abs().max().item()
        dx = inorm.bwd_map(g, pre, sc, mg, mgy, act)
        dxp = inorm.bwd_map_plain(g, pre, sc, mg, mgy, act)
        if not within_bf16_ulp(dx, dxp):
            raise AssertionError(f"bwd_map {act} {shape}: more than one bf16 step off")
        err_m = (dx.float() - dxp.float()).abs().max().item()
        del ref, mag, sp, pre_p, a_p, dxp
        if timed:
            ms_f = cuda_ms(lambda: inorm.pair_sums(x), 10)
            pl_f = cuda_ms(lambda: inorm.pair_sums_plain(x), 3)
            lib_f = cuda_ms(lambda: torch.var_mean(x, dim=1, correction=0), 10)
            gl_f = cuda_ms(lambda: inorm.norm_coefficients(s_f, r), 10)
            ms_a = cuda_ms(lambda: inorm.affine_map_act(x, sc, sh, act, keep_pre=True), 10)
            pl_a = cuda_ms(lambda: inorm.affine_map_act_plain(x, sc, sh, act, keep_pre=True), 3)
            ms_s = cuda_ms(lambda: inorm.pair_sums_gy(g, pre, act), 10)
            pl_s = cuda_ms(lambda: inorm.pair_sums_gy_plain(g, pre, act), 3)
            lib_s = cuda_ms(lambda: (g.float() * pre.float()).sum(1), 10)
            gl_s = cuda_ms(lambda: inorm.sum_means(s, r), 10)
            ms_m = cuda_ms(lambda: inorm.bwd_map(g, pre, sc, mg, mgy, act), 10)
            pl_m = cuda_ms(lambda: inorm.bwd_map_plain(g, pre, sc, mg, mgy, act), 3)
            elems = n * r * c
            tb_f, to_f = bound_ms(elems * 2 + 4 * n * c * 4, 3.0 * elems, PEAK_F32_FLOPS)
            tb_a, to_a = bound_ms(3 * elems * 2 + 2 * n * c * 4, 3.0 * elems, PEAK_F32_FLOPS)
            tb_s, to_s = bound_ms(2 * elems * 2 + 4 * n * c * 4, 4.0 * elems, PEAK_F32_FLOPS)
            tb_m, to_m = bound_ms(3 * elems * 2 + 3 * n * c * 4, 5.0 * elems, PEAK_F32_FLOPS)
            plan = inorm.stats_plan(n, r, c, 2)
            log(f"  pair_sums {shape}: kernel {ms_f:.4f} ms  plain {pl_f:.4f} ms  var_mean "
                f"{lib_f:.4f} ms  glue it replaces (norm_coefficients) {gl_f:.4f} ms  bound "
                f"{max(tb_f, to_f):.4f} ms  plan {plan}")
            log(f"  affine_map_act {act} keep_pre {shape}: kernel {ms_a:.4f} ms  plain "
                f"{pl_a:.4f} ms  bound {max(tb_a, to_a):.4f} ms")
            log(f"  pair_sums_gy {act} {shape}: max_abs_err {err_s:.4g} (kernel vs plain f32 "
                f"sums)  kernel {ms_s:.4f} ms  plain {pl_s:.4f} ms  (g*y).sum {lib_s:.4f} ms  glue "
                f"it replaces (two divisions) {gl_s:.4f} ms  bound {max(tb_s, to_s):.4f} ms")
            log(f"  bwd_map {act} {shape}: max_abs_err {err_m:.4g}  kernel {ms_m:.4f} ms  plain "
                f"{pl_m:.4f} ms  bound {max(tb_m, to_m):.4f} ms")
            _add(tot["sums"], mult, err_f, ms=ms_f, plain_ms=pl_f, library_ms=lib_f, tb=tb_f,
                 to=to_f)
            _add(tot["amap"], mult, err_a, ms=ms_a, plain_ms=pl_a, tb=tb_a, to=to_a)
            _add(tot["sums_gy"], mult, err_s, ms=ms_s, plain_ms=pl_s, library_ms=lib_s, tb=tb_s,
                 to=to_s)
            _add(tot["bmap"], mult, err_m, ms=ms_m, plain_ms=pl_m, tb=tb_m, to=to_m)
            glue["sums"] += mult * gl_f
            glue["sums_gy"] += mult * gl_s
        if timed and shape == TRAIN_NORM[0][0]:
            one_device_operation(lambda: inorm.pair_sums(x), f"pair_sums {shape}")
            one_device_operation(lambda: inorm.pair_sums_gy(g, pre, act),
                                 f"pair_sums_gy {act} {shape}")
        del x, g, pre, a, dx, s, s_f
        torch.cuda.empty_cache()
    if timed:
        log(f"  per 108^3 step: pair_sums {tot['sums']['ms']:.4f} ms (glue it replaces "
            f"{glue['sums']:.4f} ms), pair_sums_gy {tot['sums_gy']['ms']:.4f} ms (glue it "
            f"replaces {glue['sums_gy']:.4f} ms)")
    return tot


def synthetic_volume(seed: int, size: int = VOLUME, noise: float = 3000.0) -> np.ndarray:
    """A smooth random field with noise, uint16, from the seed (noise 0:
    the field alone, the ground truth of the noisy volume)."""
    rng = np.random.default_rng(seed)
    ax = np.arange(size, dtype=np.float32)
    ph = rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
    field = (np.sin(ax / 9.0 + ph[0])[:, None, None] * np.cos(ax / 13.0 + ph[1])[None, :, None]
             * np.sin(ax / 7.0 + ph[2])[None, None, :])
    vol = 20000.0 + 15000.0 * field + rng.normal(0.0, noise, field.shape).astype(np.float32)
    return np.clip(vol, 0, 65535).astype(np.uint16)


def lsb_stats(a: np.ndarray, ref: np.ndarray) -> dict:
    d = np.abs(a.astype(np.int64) - ref)
    return {"max_lsb": int(d.max()), "mean_lsb": float(d.mean()),
            "p999_lsb": float(np.quantile(d, 0.999))}


def plain_outputs(flat: dict, vol: np.ndarray, dev, precisions) -> tuple[dict, dict]:
    """The slice's tile pipeline on the plain versions, on the card: {precision:
    int64 output} and {precision: seconds}; no kernel may launch."""
    vp = pad_for_dicing(vol, 120, 15)
    grid = DiceGrid(vp.shape, 120, 15, 10)
    plain = define_G(1, 1, 64, "unet_deconv", plain=True)
    plain.load_state_dict(params_from_numpy(flat, plain))
    plain.to(dev).eval()
    outs, secs = {}, {}
    before = kernel_ops.launches()
    for precision in precisions:
        pipe = DiceInferencePipeline(plain, grid, dtype_inv_scale(vp.dtype), tile_batch=2,
                                     precision=precision, out_dtype=np.uint16,
                                     orig_shape=vol.shape, device=dev)
        t0 = time.perf_counter()
        outs[precision] = pipe.run_streaming(vp).astype(np.int64)
        secs[precision] = time.perf_counter() - t0
    if kernel_ops.launches() != before:
        raise AssertionError("the plain pipeline launched a kernel")
    return outs, secs


def check_against_plain(label: str, out: np.ndarray, ref: np.ndarray, p_err: dict,
                        plain_bf16: np.ndarray) -> tuple[dict, np.ndarray]:
    """The slice's bounds: the kernel path's bf16 output no less accurate
    against the f32 plain output than the plain versions in bf16, and within
    SLICE_KP_* of that plain bf16 output."""
    k_err = lsb_stats(out, ref)
    kp = np.abs(out.astype(np.int64) - plain_bf16)
    log(f"  against the f32 plain output: {label} (bf16) {k_err}; plain versions (bf16) "
        f"{p_err}; {label} vs plain (bf16): max {int(kp.max())} LSB, mean "
        f"{float(kp.mean()):.3f} LSB, {float((kp > 0).mean()):.4f} of voxels differ; "
        f"output mean {out.mean():.1f} std {out.std():.1f}")
    if (k_err["mean_lsb"] > SLICE_MEAN_RATIO * p_err["mean_lsb"]
            or k_err["max_lsb"] > p_err["max_lsb"] + SLICE_MAX_EXTRA_LSB):
        raise AssertionError(f"{label} less accurate than the plain path: {k_err} vs {p_err}")
    if kp.max() > SLICE_KP_MAX_LSB or kp.mean() > SLICE_KP_MEAN_LSB:
        raise AssertionError(f"{label} off the plain path: max {kp.max()}, mean {kp.mean()}")
    return k_err, kp


def run_slice(seed: int, dev, tmp: str) -> dict:
    vol = synthetic_volume(seed)
    os.makedirs(os.path.join(tmp, "data"))
    np.save(os.path.join(tmp, "data", "volume.npy"), vol)
    flat = kaiming_flat(UNetDeconv(1, 1), seed)
    os.makedirs(os.path.join(tmp, "ckpt", "smoke"))
    np.savez(os.path.join(tmp, "ckpt", "smoke", "iter_1_net_G_A.npz"), **flat)

    roi, overlap = 120, 15
    grid = DiceGrid(pad_for_dicing(vol, roi, overlap).shape, roi, overlap, 10)
    per_slab = -(-(grid.y_steps * grid.x_steps) // 2)
    batches = grid.z_steps * per_slab
    expected = {name: 0 for name in kernel_ops.KERNELS}  # no backward kernel runs
    expected.update({"wconv3x3x3": 2 * batches, "pair_sums": 10 * batches,
                     "affine_map_act": 10 * batches})
    log(f"  {len(grid)} tiles of {roi + 20}^3 in {batches} batches of <= 2")

    def run(results):
        return test_dice.main(["--dataroot", os.path.join(tmp, "data"), "--name", "smoke",
                               "--checkpoints_dir", os.path.join(tmp, "ckpt"), "--load_iter",
                               "1", "--model_suffix", "_A", "--results_dir",
                               os.path.join(tmp, results), *SLICE_ARGS])

    kernel_ops.reset_launches()
    res = run("results")
    launches = kernel_ops.launches()
    log(f"  launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    warm = run("warm")
    out = res["fake"]
    if out.shape != vol.shape or out.dtype != np.uint16 or out.std() == 0:
        raise AssertionError(f"output {out.shape} {out.dtype} std {out.std()}")

    # the same pipeline on the plain versions, on the card, in bf16 and f32
    outs, plain_s = plain_outputs(flat, vol, dev, ("bfloat16", "float32"))
    ref = outs["float32"]
    p_err = lsb_stats(outs["bfloat16"], ref)
    k_err, _ = check_against_plain("kernels", out, ref, p_err, outs["bfloat16"])
    vps = res["voxels"] / res["seconds"]
    log(f"  pipeline and post-processing {res['seconds']:.3f} s = {vps:.4g} voxel/s with the "
        f"kernels (bf16, first run), {warm['seconds']:.3f} s = "
        f"{res['voxels'] / warm['seconds']:.4g} voxel/s (second); "
        + "; ".join(f"{t:.3f} s = {res['voxels'] / t:.4g} voxel/s pipeline on the plain "
                    f"versions ({p})" for p, t in plain_s.items()))
    return {"launches": launches, "k_err": k_err, "seconds": res["seconds"], "ref": ref,
            "p_err": p_err, "out": out}


@contextlib.contextmanager
def dense_k_route():
    """NEUROCLEAR_PALLAS_CONV=1 for the duration: the dense-K conv route."""
    os.environ["NEUROCLEAR_PALLAS_CONV"] = "1"
    try:
        yield
    finally:
        del os.environ["NEUROCLEAR_PALLAS_CONV"]


def run_dice_cli(seed: int, dev, tmp: str, sl: dict) -> dict:
    """The test_dice CLI with the dense-K conv switched on: its launches, the
    streamed TIFF, the output on the slice's bounds against the slice phase's
    f32 plain output and against the same route on the plain versions in
    bf16, and the device metrics against the host path."""
    vol = synthetic_volume(seed)
    tiffio.imwrite(os.path.join(tmp, "data", "volume.tif"), vol)
    tiffio.imwrite(os.path.join(tmp, "gt", "volume.tif"), synthetic_volume(seed, noise=0.0))
    os.makedirs(os.path.join(tmp, "ckpt", "smoke"))
    flat = kaiming_flat(UNetDeconv(1, 1), seed)
    np.savez(os.path.join(tmp, "ckpt", "smoke", "iter_1_net_G_A.npz"), **flat)
    grid = DiceGrid(pad_for_dicing(vol, 120, 15).shape, 120, 15, 10)
    batches = grid.z_steps * -(-(grid.y_steps * grid.x_steps) // 2)
    expected = {name: 0 for name in kernel_ops.KERNELS}
    expected.update({"wconv3x3x3": 2 * batches, "conv3x3": 4 * batches,
                     "pair_sums": 10 * batches, "affine_map_act": 10 * batches})

    with dense_k_route():
        kernel_ops.reset_launches()
        res = test_dice.main(["--dataroot", os.path.join(tmp, "data"),
                              "--dataroot_gt", os.path.join(tmp, "gt"), "--name", "smoke",
                              "--checkpoints_dir", os.path.join(tmp, "ckpt"), "--load_iter", "1",
                              "--model_suffix", "_A", "--results_dir",
                              os.path.join(tmp, "results"), "--serial_batches", "--preprocess",
                              "addColorChannel", "--dataset_mode", "diceImage", "--netG",
                              "unet_deconv", "--image_dimension", "3", "--save_volume",
                              "--save_projections", *SLICE_ARGS])
        launches = kernel_ops.launches()
        route_plain, route_plain_s = plain_outputs(flat, vol, dev, ("bfloat16",))
    log(f"  launches {launches}, expected {expected} ({batches} generator applications)")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")

    out = res["fake"]
    if out.shape != vol.shape or out.dtype != np.uint16 or out.std() == 0:
        raise AssertionError(f"output {out.shape} {out.dtype} std {out.std()}")
    if res["fake_streamed"] is None:
        raise AssertionError("the output volume was not streamed during the harvest")
    if not np.array_equal(tiffio.imread(res["fake_streamed"]), out):
        raise AssertionError("the streamed TIFF differs from the volume in memory")
    k_err, _ = check_against_plain("dense-K route", out, sl["ref"], sl["p_err"],
                                   route_plain["bfloat16"])
    vs_slice = np.abs(out.astype(np.int64) - sl["out"].astype(np.int64))
    log(f"  against the slice's kernel output (cuDNN for those four convs): max "
        f"{int(vs_slice.max())} LSB, mean {float(vs_slice.mean()):.3f} LSB; the route's plain "
        f"pipeline (bf16) {route_plain_s['bfloat16']:.3f} s")

    gt = tiffio.imread(os.path.join(tmp, "gt", "volume.tif"))
    t0 = time.perf_counter()
    dev_m = device_metrics.protocol_metrics(res["real"], out, gt, device=dev)
    dev_s = time.perf_counter() - t0
    if any(abs(dev_m[k] - res["metrics"][k]) > 1e-6 for k in dev_m):
        raise AssertionError(f"device metrics {dev_m} differ from the CLI's {res['metrics']}")
    t0 = time.perf_counter()
    host = test_dice.host_metrics(res["real"], out, gt)
    host_s = time.perf_counter() - t0
    log(f"  metrics: device {dev_m} ({dev_s:.2f} s, again); host float64 {host} "
        f"({host_s:.1f} s)")
    for k in host:
        tol = 1e-3 if k.startswith("psnr") else 1e-4
        if abs(dev_m[k] - host[k]) >= tol:
            raise AssertionError(f"device metric {k} {dev_m[k]} off the host's {host[k]}")
    with open(os.path.join(res["web_dir"], "metrics.txt")) as f:
        for line in f.read().splitlines():
            log(f"    metrics.txt | {line}")
    log(f"  CLI pipeline and post-processing {res['seconds']:.3f} s = "
        f"{res['voxels'] / res['seconds']:.4g} voxel/s (first run, bf16, dense-K route)")
    return {"launches": launches, "k_err": k_err, "seconds": res["seconds"], "metrics": dev_m}


def _grads_by_name(model, g_grads, d_grads) -> dict:
    """{NET.param: f32 gradient} in the order of the model's parameters."""
    names = [f"{n}.{pn}" for n in G_NAMES + D_NAMES for pn, _ in model.nets[n].named_parameters()]
    return {k: g.detach().float() for k, g in zip(names, list(g_grads) + list(d_grads))}


def _is_pre_norm_bias(key: str) -> bool:
    parts = key.split(".")
    return parts[-1] == "bias" and any(q.startswith(PRE_NORM) for q in parts[1:-1])


def _rel_l2(a: dict, b: dict, keys) -> float:
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in keys)
    return math.sqrt(num / sum(float((b[k] ** 2).sum()) for k in keys))


def step_three_ways(seed: int, vol: np.ndarray, dev) -> dict:
    """One step from identical weights, crop and draws: {label: (losses,
    gradients)} for the kernels in bf16 and the plain versions in bf16 and
    in f32."""
    opt = train_onecube.build_parser().parse_args(["--dataroot", "unused", *TRAIN_ARGS])
    dataset = SingleVolumeDataset(vol, (CROP,) * 3, opt.preprocess, dev)
    gen = torch.Generator().manual_seed(seed + 1)
    real = dataset.sample(gen)
    draws, runs = None, {}
    for label, plain, precision in (("kernels bf16", False, "bfloat16"),
                                    ("plain bf16", True, "bfloat16"),
                                    ("plain f32", True, "float32")):
        opt.precision = precision
        model = ApolloModel(opt, dev, plain=plain)
        model.init_weights(seed)
        if draws is None:
            draws = model.draw_probes((CROP,) * 3, gen)
        before = kernel_ops.launches()
        losses, _, _, g_grads, d_grads = model.gradients(real, draws)
        torch.cuda.synchronize()
        if plain and kernel_ops.launches() != before:
            raise AssertionError(f"the {label} step launched a kernel")
        runs[label] = ({k: float(v) for k, v in losses.items()},
                       _grads_by_name(model, g_grads, d_grads))
        del model, g_grads, d_grads
        torch.cuda.empty_cache()
    return runs


def judge_step(runs: dict) -> tuple[list, dict]:
    """(failures, stats) of the kernel step against the plain steps."""
    (lk, gk), (lp, gp), (lf, gf) = runs["kernels bf16"], runs["plain bf16"], runs["plain f32"]
    bad, stats = [], {"pooled": {}, "direct": {}}
    for name in LOSS_NAMES:
        ek, ep = abs(lk[name] - lf[name]), abs(lp[name] - lf[name])
        if not ek <= STEP_LOSS_RATIO * ep + STEP_LOSS_REL * abs(lf[name]):  # NaN fails
            bad.append(f"loss {name}: {ek:.4g} vs plain {ep:.4g}")
    keys = [k for k in gf if not _is_pre_norm_bias(k)]
    for group, nets in (("G_A", ["G_A"]), ("G_B", ["G_B"]), ("D", D_NAMES)):
        ks = [k for k in keys if k.split(".")[0] in nets]
        ek, ep = _rel_l2(gk, gf, ks), _rel_l2(gp, gf, ks)
        stats["pooled"][group] = (ek, ep)
        if not ek <= STEP_GRAD_RATIO * ep + STEP_GRAD_ABS:
            bad.append(f"gradients {group}: {ek:.4g} vs plain {ep:.4g}")
        # the kernel step against the plain bf16 step, tensor by tensor
        direct = sorted(((_rel_l2(gk, gp, [k]), k) for k in ks), reverse=True)
        stats["direct"][group] = direct[:3]
        for d, k in direct:
            if not d <= STEP_DIRECT[group]:
                bad.append(f"gradient {k}: {d:.4g} off the plain bf16 step "
                           f"(limit {STEP_DIRECT[group]})")
    for k in keys:
        ek, ep = _rel_l2(gk, gf, [k]), _rel_l2(gp, gf, [k])
        if not ek <= STEP_TENSOR_RATIO * ep + STEP_TENSOR_ABS:
            bad.append(f"gradient {k}: {ek:.4g} vs plain {ep:.4g}")
    return bad, stats


def check_step_three_ways(seed: int, vol: np.ndarray, dev) -> dict:
    """The kernel step's losses and gradients against the f32 plain step, no
    worse than the plain bf16 step's, and against the plain bf16 step."""
    runs = step_three_ways(seed, vol, dev)
    bad, stats = judge_step(runs)
    (lk, _), (lp, _), (lf, _) = runs["kernels bf16"], runs["plain bf16"], runs["plain f32"]
    log("  step at 108^3, relative error against the plain f32 step (kernels bf16 / plain "
        "bf16): " + "; ".join(f"{g} gradients {ek:.4g} / {ep:.4g}"
                              for g, (ek, ep) in stats["pooled"].items()))
    log("  losses (f32 | kernels bf16 | plain bf16): " + "; ".join(
        f"{n} {lf[n]:.5g} | {lk[n]:.5g} | {lp[n]:.5g}" for n in LOSS_NAMES))
    log("  kernel step against the plain bf16 step, largest relative L2 per tensor: " + "; ".join(
        f"{g} " + ", ".join(f"{d:.4g} ({k})" for d, k in top)
        for g, top in stats["direct"].items()))
    if bad:
        raise AssertionError("kernel step off the plain steps: " + "; ".join(bad))
    return stats["pooled"]


def run_train(seed: int, dev, tmp: str) -> dict:
    """The trainer at the production configuration, its launch counts, the
    three-way step check and its checkpoint through inference."""
    vol = synthetic_volume(seed, TRAIN_VOLUME)
    data = os.path.join(tmp, "train_data")
    os.makedirs(data)
    np.save(os.path.join(data, "volume.npy"), vol)
    ckpt = os.path.join(tmp, "train_ckpt")
    kernel_ops.reset_launches()
    res = train_onecube.main(["--dataroot", data, "--name", "smoke", "--checkpoints_dir", ckpt,
                              "--max_iters", str(TRAIN_ITERS), "--save_latest_freq",
                              str(TRAIN_ITERS), "--save_by_iter", "--print_freq",
                              str(TRAIN_ITERS),
                              "--seed", str(seed), *TRAIN_ARGS])
    launches = kernel_ops.launches()
    expected = {k: TRAIN_ITERS * v for k, v in STEP_LAUNCHES.items()}
    log(f"  launches over {TRAIN_ITERS} steps {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    for step in res["losses"]:
        if not all(math.isfinite(v) for v in step.values()):
            raise AssertionError(f"a loss is not finite: {step}")
    timed = sorted(res["step_seconds"][1:])
    step_ms = 1e3 * timed[len(timed) // 2]
    log(f"  step ms: first {1e3 * res['step_seconds'][0]:.1f}, then "
        + ", ".join(f"{1e3 * t:.1f}" for t in res["step_seconds"][1:])
        + f"; median {step_ms:.1f} ms ({CROP}^3, bf16)")
    log("  last losses: " + ", ".join(f"{k} {v:.5g}" for k, v in res["losses"][-1].items()))

    pooled = check_step_three_ways(seed, vol, dev)

    small = os.path.join(tmp, "infer_data")
    os.makedirs(small)
    np.save(os.path.join(small, "volume.npy"), synthetic_volume(seed + 2, 72))
    out = test_dice.main(["--dataroot", small, "--name", "smoke", "--checkpoints_dir", ckpt,
                          "--load_iter", str(TRAIN_ITERS), "--model_suffix", "_A",
                          "--dice_size", "48", "48", "48", "--overlap", "8", "--border_cut",
                          "4", "--precision", "bfloat16", "--results_dir",
                          os.path.join(tmp, "train_out")])
    vol_out = out["fake"]
    if vol_out.shape != (72, 72, 72) or vol_out.dtype != np.uint16 or vol_out.std() == 0:
        raise AssertionError(f"trained G_A output {vol_out.shape} {vol_out.dtype} "
                             f"std {vol_out.std()}")
    return {"launches": launches, "step_ms": step_ms, "losses": res["losses"][-1],
            "pooled": pooled}


def profile_pipeline(dev, seed: int) -> None:
    """Where the time of the slice goes: a warm run of the tile pipeline
    timed on the host clock, then the same run under torch.profiler, device
    time by kernel name (the profiler's own overhead stays out of the wall
    time)."""
    log(f"  tile pipeline, NEUROCLEAR_PALLAS_CONV={int(conv3x3.enabled())}:")
    vol = synthetic_volume(seed)
    vp = pad_for_dicing(vol, 120, 15)
    net = UNetDeconv(1, 1)
    net.load_state_dict(params_from_numpy(kaiming_flat(net, seed), net))
    net.to(dev).eval()
    pipe = DiceInferencePipeline(net, DiceGrid(vp.shape, 120, 15, 10), dtype_inv_scale(vp.dtype),
                                 tile_batch=2, precision="bfloat16", out_dtype=np.uint16,
                                 orig_shape=vol.shape, device=dev)
    pipe.run_streaming(vp)
    t0 = time.perf_counter()
    pipe.run_streaming(vp)
    wall = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        pipe.run_streaming(vp)
    rows = _device_rows(prof)
    busy = sum(r[1] for r in rows)
    log(f"  warm pipeline wall {wall:.1f} ms; device time {busy:.1f} ms "
        f"(idle share {max(0.0, 1 - busy / wall):.3f}); {sum(r[2] for r in rows)} device "
        "operations")
    for key, ms, count in rows[:16]:
        log(f"    {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{count:<4d} {key[:90]}")


def _device_rows(prof):
    """(name, device ms, count) of each kernel, most time first.  Annotated
    ranges (torch.optim's Optimizer.step#Adam.step) span kernels that have
    rows of their own, and are left out."""
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    rows.sort(key=lambda r: -r[1])
    return rows


def profile_train_step(dev, seed: int) -> None:
    """Where the time of a 108^3 training step goes: a warm step timed on
    the host clock, then one under torch.profiler, device time by kernel."""
    opt = train_onecube.build_parser().parse_args(["--dataroot", "unused", *TRAIN_ARGS])
    dataset = SingleVolumeDataset(synthetic_volume(seed, TRAIN_VOLUME), (CROP,) * 3,
                                  opt.preprocess, dev)
    model = ApolloModel(opt, dev)
    model.init_weights(seed)
    gen = torch.Generator().manual_seed(seed)

    def step(sync=True):
        model.optimize_parameters(dataset.sample(gen), model.draw_probes((CROP,) * 3, gen))
        if sync:
            torch.cuda.synchronize()

    def steps_ms(n, sync_each):
        t0 = time.perf_counter()
        for _ in range(n):
            step(sync_each)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    step()
    step()
    # what the host gains by queuing a step while the card runs the one before
    ab = [steps_ms(5, True), steps_ms(5, False), steps_ms(5, False), steps_ms(5, True)]
    log(f"  warm steps, wall ms per step over 5 (order: sync after each, one sync at the end, "
        f"one sync at the end, sync after each): {', '.join(f'{t:.1f}' for t in ab)}")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    step()
    wall = (time.perf_counter() - t0) * 1e3
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
    rows = _device_rows(prof)
    busy = sum(r[1] for r in rows)
    log(f"  warm training step wall {wall:.1f} ms; device time {busy:.1f} ms "
        f"(idle share {max(0.0, 1 - busy / wall):.3f}); {sum(r[2] for r in rows)} device "
        f"operations; peak device memory {peak_gib:.2f} GiB")
    for key, ms, count in rows[:24]:
        log(f"    {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{count:<4d} {key[:90]}")


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile a warm run of the slice's tile pipeline (without and "
                         "with the dense-K conv) and a warm training step")
    args = ap.parse_args(argv)
    faulthandler.dump_traceback_later(BUDGET_S + 60, exit=True)  # a hang ends the run

    with Phase("environment") as ph:
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: no CUDA device; this smoke runs on the card")
        smi = nvidia_smi()
        ph.result = (f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
                     f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
                     f"{torch.cuda.device_count()}, nvidia-smi: {smi}")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    with Phase("build") as ph:
        secs = build.build_all()
        for name in secs:
            build.load(name)
        regs = [ln.strip() for name in secs for ln in build.ptxas_report(name).splitlines()
                if "registers" in ln or "spill" in ln or "C7515" in ln]
        hgmma = {name: build.sass_wgmma_count(name) for name in secs}
        missing = [name for name in WGMMA_SOURCES if not hgmma.get(name)]
        if missing:
            raise AssertionError(f"no HGMMA (wgmma) instruction in the SASS of {missing}")
        ph.result = (f"nvcc sm_90a {secs}; HGMMA instructions in SASS {hgmma}; "
                     + " | ".join(regs))

    with Phase("kernels") as ph:
        conv = check_conv(gen, dev, wconv, CONV_SHAPES)
        c3 = check_conv(gen, dev, conv3x3, CONV3X3_SHAPES)
        check_conv3x3_fn(gen, dev)
        sums, amap = check_norm(gen, dev)
        ph.result = "all kernels within tolerance of their plain versions"

    with Phase("kernels (training)") as ph:
        dx, dw = check_train_conv(gen, dev)
        step_norm = check_train_norm(gen, dev)
        sums_gy, bmap = step_norm["sums_gy"], step_norm["bmap"]
        ph.result = "all training kernels within tolerance of their plain versions"

    with Phase("slice") as ph, tempfile.TemporaryDirectory() as tmp:
        sl = run_slice(args.seed, dev, tmp)
        ph.result = (f"{VOLUME}^3 uint16 in {sl['seconds']:.3f} s, error against the f32 "
                     f"plain output {sl['k_err']}")

    with Phase("dice CLI") as ph, tempfile.TemporaryDirectory() as tmp:
        dc = run_dice_cli(args.seed, dev, tmp, sl)
        ph.result = (f"{VOLUME}^3 uint16 TIFF in {dc['seconds']:.3f} s, error against the f32 "
                     f"plain output {dc['k_err']}, metrics {dc['metrics']}")

    with Phase("train") as ph, tempfile.TemporaryDirectory() as tmp:
        tr = run_train(args.seed, dev, tmp)
        ph.result = (f"{CROP}^3 Apollo step {tr['step_ms']:.1f} ms (median of "
                     f"{TRAIN_ITERS - 1}), gradient error against f32 (kernels / plain bf16) "
                     f"{tr['pooled']}")

    if args.profile:
        with Phase("profile"):
            profile_pipeline(dev, args.seed)
            with dense_k_route():
                profile_pipeline(dev, args.seed)
            profile_train_step(dev, args.seed)

    # Times: the inference kernels' rows sum one 2 x 140^3 tile batch's
    # launches, the training kernels' rows one 108^3 step's; the forward
    # norm's rows (pair_sums, affine_map_act) carry the step's sums beside
    # the batch's as step_*; launches are the counts of the slice's run, the
    # dice CLI's run and the trainer's.
    rows = []
    csrc = "neuroclear_tpu_torch/ops/csrc/"
    for name, src, replaces, tot in (
            ("wconv3x3x3", "conv3x3.cu", "pallas_wconv.py:124", conv),
            ("wconv_dx", "conv3x3.cu", "pallas_wconv.py:387", dx),
            ("wconv_dw", "wconv_dw.cu", "pallas_wconv.py:231", dw),
            ("pair_sums", "inorm.cu", "pallas_ops.py:69", sums),
            ("affine_map_act", "inorm.cu", "pallas_ops.py:111", amap),
            ("pair_sums_gy", "inorm.cu", "pallas_ops.py:69", sums_gy),
            ("bwd_map", "inorm.cu", "pallas_ops.py:143", bmap),
            ("conv3x3", "conv3x3.cu", "pallas_conv.py:93", c3)):
        by_path = {"slice": sl["launches"][name], "dice": dc["launches"][name],
                   "train": tr["launches"][name]}
        rows.append({"name": name, "route": "cuda", "source": csrc + src,
                     "replaces": "neuroclear_tpu/ops/" + replaces,
                     "launches": sum(by_path.values()), "launches_by_path": by_path,
                     "max_abs_err": tot["err"],
                     "ms": tot["ms"], "plain_ms": tot["plain_ms"],
                     "bound_ms": max(tot["tb"], tot["to"]),
                     "bound_by": "operations" if tot["to"] > tot["tb"] else "bytes",
                     "library_ms": tot["library_ms"]})
        step = {"pair_sums": step_norm["sums"], "affine_map_act": step_norm["amap"]}.get(name)
        if step is not None:
            rows[-1].update({"step_ms": step["ms"], "step_plain_ms": step["plain_ms"],
                             "step_bound_ms": max(step["tb"], step["to"]),
                             "step_library_ms": step["library_ms"]})
    faulthandler.cancel_dump_traceback_later()
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
