#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (neuroclear_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, each printed with its name, seconds and result:
  1. environment: torch/CUDA versions and the card (exits nonzero without one);
  2. build: every CUDA kernel from ops/csrc with nvcc (sm_90a);
  3. kernels: each kernel against its plain PyTorch version on the card, in
     bf16 at the shapes one 2 x 140^3 tile batch of the main path gives it,
     with its time, the plain version's, one PyTorch library call's where
     there is one, and its bound at the H100's published peaks;
  4. slice: ``neuroclear_tpu_torch.infer.main`` on a synthetic 260^3 uint16
     volume with random Kaiming UNetDeconv weights in the JAX checkpoint
     format (27 tiles of 140^3, bf16, tile_batch 2), the launch counts of
     every kernel checked, and the output held against the same pipeline on
     the plain versions on the card;
  5. profile (only with --profile): a warm run of the slice's tile pipeline
     under torch.profiler, device time by kernel and the device's idle share.
Then a ``{"kernels": [...]}`` line, the nvidia-smi name and power limit, and
as the last line ``{"ok": true, "device": {...}}``.  Any failure raises and
exits nonzero before that line.  The whole run has a 600 s budget.
"""

from __future__ import annotations

import argparse
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
from neuroclear_tpu_torch import infer
from neuroclear_tpu_torch.data.dicing import DiceGrid
from neuroclear_tpu_torch.nn.factory import define_G
from neuroclear_tpu_torch.nn.generators import UNetDeconv
from neuroclear_tpu_torch.ops import build, inorm, wconv
from neuroclear_tpu_torch.parallel.dice_infer import DiceInferencePipeline
from neuroclear_tpu_torch.utils.imageops import dtype_inv_scale, pad_for_dicing
from neuroclear_tpu_torch.utils.weights import kaiming_flat, params_from_numpy

BUDGET_S = 600
# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12

# One 2 x 140^3 tile batch of the main path (dice 120, border_cut 10):
# (shape, launches per batch) for each kernel
TILE = 140
CONV_SHAPES = [((2, TILE, TILE, TILE, 64), 1),    # double_conv1.conv1
               ((2, TILE, TILE, TILE, 128), 1)]   # ex_conv1_1.conv0
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
    """Mean device time of fn over reps calls, after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def check_conv(gen, dev) -> dict:
    """wconv kernel vs its plain version at both of the path's shapes."""
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "tb": 0.0, "to": 0.0, "err": 0.0}
    for shape, mult in CONV_SHAPES:
        b, d, h, w, cin = shape
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        wgt = (torch.randn((64, cin, 3, 3, 3), generator=gen, device=dev)
               * math.sqrt(2.0 / (27 * cin))).to(torch.bfloat16)
        bias = torch.randn(64, generator=gen, device=dev) * 0.1
        wt = wconv.pack_weight(wgt)
        y = wconv.conv3d(x, wt, bias)
        torch.cuda.synchronize()
        p = wconv.conv3d_plain(x, wt, bias)
        err = (y.float() - p.float()).abs()
        # one bf16 rounding of sums that differ in order only: one bf16 step
        # (2^-7 relative) plus a floor for outputs near zero
        tol = 2.0 ** -7 * p.float().abs() + 2.0 ** -12 * p.float().abs().max()
        max_err = err.max().item()
        if not bool((err <= tol).all()):
            raise AssertionError(f"wconv {shape}: max error {max_err} over tolerance")
        del p, err
        x_cl = x.permute(0, 4, 1, 2, 3)  # channels-last NCDHW view for cuDNN
        # and against cuDNN's f32 conv (TF32 off) of the same bf16 inputs
        ref32 = F.conv3d(x_cl.float(), wgt.float(), bias, 1, 1).permute(0, 2, 3, 4, 1)
        if not bool(((y.float() - ref32).abs() <= tol).all()):
            raise AssertionError(f"wconv {shape}: off F.conv3d in f32")
        del ref32, tol
        bias16 = bias.to(torch.bfloat16)
        ms = cuda_ms(lambda: wconv.conv3d(x, wt, bias), 5)
        plain = cuda_ms(lambda: wconv.conv3d_plain(x, wt, bias), 1)
        lib = cuda_ms(lambda: F.conv3d(x_cl, wgt, bias16, 1, 1), 5)
        m = b * d * h * w
        flops = 2.0 * m * 64 * 27 * cin
        tb, to = bound_ms(m * cin * 2 + 27 * cin * 64 * 2 + 64 * 4 + m * 64 * 2, flops,
                          PEAK_BF16_FLOPS)
        log(f"  wconv {shape}: max_abs_err {max_err:.4g}  kernel {ms:.3f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s)  plain {plain:.3f} ms  F.conv3d {lib:.3f} ms  "
            f"bound {max(tb, to):.3f} ms")
        tot["err"] = max(tot["err"], max_err)
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("tb", tb),
                       ("to", to)):
            tot[key] += mult * v
        del x, y, x_cl
        torch.cuda.empty_cache()
    return tot


def check_norm(gen, dev) -> tuple[dict, dict]:
    """pair_sums and affine_map_act kernels vs their plain versions at the
    path's three norm shapes."""
    sums = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "tb": 0.0, "to": 0.0, "err": 0.0}
    amap = {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "tb": 0.0, "to": 0.0, "err": 0.0}
    for shape, mult in NORM_SHAPES:
        n, r, c = shape
        x3 = (torch.randn(shape, generator=gen, device=dev) * 2.0 + 0.5).to(torch.bfloat16)
        s = inorm.pair_sums(x3)
        sp = inorm.pair_sums_plain(x3)
        xd = x3.double()
        ref = torch.stack([xd.sum(1), (xd * xd).sum(1)], 1)
        scale = torch.stack([xd.abs().sum(1), (xd * xd).sum(1)], 1)
        del xd
        # f32 sums of bf16 values against f64: 1e-5 of the sum of magnitudes
        for name, got in (("kernel", s), ("plain", sp)):
            if not bool(((got.double() - ref).abs() <= 1e-5 * scale).all()):
                raise AssertionError(f"pair_sums {name} {shape} off the f64 sums")
        err_s = (s - sp).abs().max().item()
        sc, sh = inorm.norm_coefficients(s, r)
        y = inorm.affine_map_act(x3, sc, sh, "relu")
        yp = inorm.affine_map_act_plain(x3, sc, sh, "relu")
        if not within_bf16_ulp(y, yp):
            raise AssertionError(f"affine_map_act {shape}: more than one bf16 step off")
        err_m = (y.float() - yp.float()).abs().max().item()
        ms_s = cuda_ms(lambda: inorm.pair_sums(x3), 10)
        pl_s = cuda_ms(lambda: inorm.pair_sums_plain(x3), 3)
        lib_s = cuda_ms(lambda: torch.var_mean(x3, dim=1, correction=0), 10)
        ms_m = cuda_ms(lambda: inorm.affine_map_act(x3, sc, sh, "relu"), 10)
        pl_m = cuda_ms(lambda: inorm.affine_map_act_plain(x3, sc, sh, "relu"), 3)
        elems = n * r * c
        tb_s, to_s = bound_ms(elems * 2 + n * 2 * c * 4, 3.0 * elems, PEAK_F32_FLOPS)
        tb_m, to_m = bound_ms(2 * elems * 2 + 2 * n * c * 4, 3.0 * elems, PEAK_F32_FLOPS)
        log(f"  pair_sums {shape}: max_abs_err {err_s:.4g} (kernel vs plain f32 sums)  kernel "
            f"{ms_s:.4f} ms  plain {pl_s:.4f} ms  var_mean {lib_s:.4f} ms  bound "
            f"{max(tb_s, to_s):.4f} ms")
        log(f"  affine_map_act {shape}: max_abs_err {err_m:.4g}  kernel {ms_m:.4f} ms  plain "
            f"{pl_m:.4f} ms  bound {max(tb_m, to_m):.4f} ms")
        for tot, vals in ((sums, (ms_s, pl_s, lib_s, tb_s, to_s, err_s)),
                          (amap, (ms_m, pl_m, None, tb_m, to_m, err_m))):
            for key, v in zip(("ms", "plain_ms", "library_ms", "tb", "to"), vals[:5]):
                if v is not None:
                    tot[key] += mult * v
            tot["err"] = max(tot["err"], vals[5])
        del x3, s, sp, y, yp
        torch.cuda.empty_cache()
    return sums, amap


def synthetic_volume(seed: int) -> np.ndarray:
    """A smooth random field with noise, uint16, from the seed."""
    rng = np.random.default_rng(seed)
    ax = np.arange(VOLUME, dtype=np.float32)
    ph = rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
    field = (np.sin(ax / 9.0 + ph[0])[:, None, None] * np.cos(ax / 13.0 + ph[1])[None, :, None]
             * np.sin(ax / 7.0 + ph[2])[None, None, :])
    vol = 20000.0 + 15000.0 * field + rng.normal(0.0, 3000.0, field.shape).astype(np.float32)
    return np.clip(vol, 0, 65535).astype(np.uint16)


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
    expected = {"wconv3x3x3": 2 * batches, "pair_sums": 10 * batches,
                "affine_map_act": 10 * batches}
    log(f"  {len(grid)} tiles of {roi + 20}^3 in {batches} batches of <= 2")

    kernel_ops.reset_launches()
    res = infer.main(["--dataroot", os.path.join(tmp, "data"), "--name", "smoke",
                      "--checkpoints_dir", os.path.join(tmp, "ckpt"), "--load_iter", "1",
                      "--model_suffix", "_A", "--results_dir", os.path.join(tmp, "results"),
                      *SLICE_ARGS])
    launches = kernel_ops.launches()
    log(f"  launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    warm = infer.main(["--dataroot", os.path.join(tmp, "data"), "--name", "smoke",
                       "--checkpoints_dir", os.path.join(tmp, "ckpt"), "--load_iter", "1",
                       "--model_suffix", "_A", "--results_dir", os.path.join(tmp, "warm"),
                       *SLICE_ARGS])
    out = np.load(res["output"])
    if out.shape != vol.shape or out.dtype != np.uint16 or out.std() == 0:
        raise AssertionError(f"output {out.shape} {out.dtype} std {out.std()}")

    # the same pipeline on the plain versions, on the card, in bf16 and f32
    plain = define_G(1, 1, 64, "unet_deconv", plain=True)
    plain.load_state_dict(params_from_numpy(flat, plain))
    plain.to(dev).eval()
    vp = pad_for_dicing(vol, roi, overlap)
    outs, plain_s = {}, {}
    before = kernel_ops.launches()
    for precision in ("bfloat16", "float32"):
        pipe = DiceInferencePipeline(plain, grid, dtype_inv_scale(vp.dtype), tile_batch=2,
                                     precision=precision, out_dtype=np.uint16,
                                     orig_shape=vol.shape, device=dev)
        t0 = time.perf_counter()
        outs[precision] = pipe.run_streaming(vp).astype(np.int64)
        plain_s[precision] = time.perf_counter() - t0
    if kernel_ops.launches() != before:
        raise AssertionError("the plain pipeline launched a kernel")
    ref = outs["float32"]

    def lsb_stats(a):
        d = np.abs(a - ref)
        return {"max_lsb": int(d.max()), "mean_lsb": float(d.mean()),
                "p999_lsb": float(np.quantile(d, 0.999))}

    k_err, p_err = lsb_stats(out.astype(np.int64)), lsb_stats(outs["bfloat16"])
    kp = np.abs(out.astype(np.int64) - outs["bfloat16"])
    log(f"  against the f32 plain output: kernels (bf16) {k_err}; plain versions (bf16) "
        f"{p_err}; kernels vs plain (bf16): max {int(kp.max())} LSB, mean "
        f"{float(kp.mean()):.3f} LSB, {float((kp > 0).mean()):.4f} of voxels differ; "
        f"output mean {out.mean():.1f} std {out.std():.1f}")
    if (k_err["mean_lsb"] > SLICE_MEAN_RATIO * p_err["mean_lsb"]
            or k_err["max_lsb"] > p_err["max_lsb"] + SLICE_MAX_EXTRA_LSB):
        raise AssertionError(f"kernel path less accurate than the plain path: {k_err} vs {p_err}")
    if kp.max() > SLICE_KP_MAX_LSB or kp.mean() > SLICE_KP_MEAN_LSB:
        raise AssertionError(f"kernel path off the plain path: max {kp.max()}, mean {kp.mean()}")
    vps = res["voxels"] / res["seconds"]
    log(f"  pipeline {res['seconds']:.3f} s = {vps:.4g} voxel/s with the kernels (bf16, first "
        f"run), {warm['seconds']:.3f} s = {res['voxels'] / warm['seconds']:.4g} voxel/s (second); "
        + "; ".join(f"{t:.3f} s = {res['voxels'] / t:.4g} voxel/s on the plain versions ({p})"
                    for p, t in plain_s.items()))
    return {"launches": launches, "k_err": k_err, "seconds": res["seconds"]}


def profile_pipeline(dev, seed: int) -> None:
    """Where the time of the slice goes: a warm run of the tile pipeline
    timed on the host clock, then the same run under torch.profiler, device
    time by kernel name (the profiler's own overhead stays out of the wall
    time)."""
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
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"  warm pipeline wall {wall:.1f} ms; device time {busy:.1f} ms "
        f"(idle share {max(0.0, 1 - busy / wall):.3f})")
    for key, ms, count in rows[:16]:
        log(f"    {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{count:<4d} {key[:90]}")


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile a warm run of the slice's tile pipeline")
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
                if "registers" in ln]
        ph.result = f"nvcc sm_90a {secs}; " + " | ".join(regs)

    with Phase("kernels") as ph:
        conv = check_conv(gen, dev)
        sums, amap = check_norm(gen, dev)
        ph.result = "all kernels within tolerance of their plain versions"

    with Phase("slice") as ph, tempfile.TemporaryDirectory() as tmp:
        sl = run_slice(args.seed, dev, tmp)
        ph.result = (f"{VOLUME}^3 uint16 in {sl['seconds']:.3f} s, error against the f32 "
                     f"plain output {sl['k_err']}")

    if args.profile:
        with Phase("profile"):
            profile_pipeline(dev, args.seed)

    rows = []
    for name, src, replaces, tot in (
            ("wconv3x3x3", "neuroclear_tpu_torch/ops/csrc/wconv.cu",
             "neuroclear_tpu/ops/pallas_wconv.py:124", conv),
            ("pair_sums", "neuroclear_tpu_torch/ops/csrc/inorm.cu",
             "neuroclear_tpu/ops/pallas_ops.py:69", sums),
            ("affine_map_act", "neuroclear_tpu_torch/ops/csrc/inorm.cu",
             "neuroclear_tpu/ops/pallas_ops.py:111", amap)):
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": sl["launches"][name], "max_abs_err": tot["err"],
                     "ms": tot["ms"], "plain_ms": tot["plain_ms"],
                     "bound_ms": max(tot["tb"], tot["to"]),
                     "bound_by": "operations" if tot["to"] > tot["tb"] else "bytes",
                     "library_ms": tot["library_ms"]})
    faulthandler.cancel_dump_traceback_later()
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
