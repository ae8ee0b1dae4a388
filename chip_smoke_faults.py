#!/usr/bin/env python3
"""Fault check of ``chip_smoke.py``'s training-step and kernel checks on one
NVIDIA GPU.

    python3 chip_smoke_faults.py [--seed N]

Runs the smoke's three-way step (``step_three_ways``: kernels in bf16, plain
versions in bf16 and in f32, 108^3, identical weights, crop and draws) once
as it is and once per fault, and judges each with the smoke's own
``judge_step``; then the smoke's untimed kernel checks (``check_conv`` on
the W-pair forward, ``check_train_conv``, ``check_norm`` and
``check_train_norm``) with the same fault in place.  A fault is either a
faulty wrapper standing in for one kernel in the kernel step only, or a
faulty statistics kernel: ``csrc/inorm.cu`` with one line changed, built
beside the real library and loaded in its place (its counters reset before
and after).  It prints, per run, the gradient errors against f32, the
largest tensor errors against the plain bf16 step and the failures of each
check, and exits nonzero unless the run as it is passes both and every
fault fails one.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import subprocess
import sys

import torch

import chip_smoke as cs
from neuroclear_tpu_torch.ops import build, conv3x3, inorm, wconv


def _dx_zero_on_call(n):
    """dx zeroed on the n-th call of a step: the backward reaches G_B's
    feat1 first, then G_A's ex_conv1_1.conv0, then double_conv1.conv1."""
    def wrap(f):
        calls = [0]

        def fn(g, wt):
            calls[0] += 1
            dx = f(g, wt)
            return torch.zeros_like(dx) if calls[0] == n else dx
        return fn
    return wrap


def _dw_centre_tap_zeroed(f):
    def fn(x, g):
        dw = f(x, g).clone()
        dw[13] = 0
        return dw
    return fn


def _fwd_last_stage_dropped(f):
    """The forward conv without its last channel stage (the kernel's last 64
    input channels, or 32 where cin is an odd multiple of 32) at cin 128,
    ex_conv1_1.conv0: the weights of those channels zeroed."""
    def fn(x, wt, bias):
        cin = wt.shape[2]
        if cin < 128:
            return f(x, wt, bias)
        kc = conv3x3.conv_plan(x.shape, cin, wt.shape[1]).kc
        wt = wt.clone()
        wt[:, :, cin - kc:] = 0
        return f(x, wt, bias)
    return fn


def _dw_last_box_of_each_chunk_skipped(f):
    """dw without the last voxel box of each chunk of its plan: g zeroed
    there, so those voxels add nothing."""
    def fn(x, g):
        plan = wconv.dw_plan(x.shape, x.shape[-1])
        (bz, by, bx), (nz, ny, nx) = plan.box, plan.counts
        g = g.clone()
        for k in range(plan.chunks):
            i = plan.chunk_boxes(k)[-1]
            ix, iy, iz, ib = i % nx, i // nx % ny, i // (nx * ny) % nz, i // (nx * ny * nz)
            g[ib, iz * bz:(iz + 1) * bz, iy * by:(iy + 1) * by, ix * bx:(ix + 1) * bx] = 0
        return f(x, g)
    return fn


@contextlib.contextmanager
def _swapped(module, name, wrap):
    """``module.name`` replaced by ``wrap`` of it for the duration."""
    kernel = getattr(module, name)
    setattr(module, name, functools.update_wrapper(wrap(kernel), kernel))  # keeps .launches
    try:
        yield
    finally:
        setattr(module, name, kernel)


# Faulty statistics kernels: (label, line of csrc/inorm.cu, its replacement)
STATS_FAULTS = [
    ("stats combine without the last chunk's partial",
     "const int k1 = min(chunks, k0 + per);", "const int k1 = min(chunks - 1, k0 + per);"),
    ("stats ticket left unrestored", "if (threadIdx.x == 0) tickets[group] = 0u;", ""),
]


def _build_stats_faults() -> list:
    """Build every faulty inorm library at once (one nvcc each); returns
    their paths in the order of STATS_FAULTS."""
    src = (build.CSRC / "inorm.cu").read_text()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, (label, old, new) in enumerate(STATS_FAULTS):
        if src.count(old) != 1:
            raise RuntimeError(f"fault {label!r}: {old!r} is not one line of inorm.cu")
        cu = build.BUILD_DIR / f"inorm_fault{i}.cu"
        cu.write_text(src.replace(old, new))
        so = cu.with_suffix(".so")
        jobs.append((so, subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                                           str(build.CSRC), "-o", str(so), str(cu)],
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True)))
    for so, proc in jobs:
        out, _ = proc.communicate(timeout=build.BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {so.name}:\n{out}")
    return [so for so, _ in jobs]


@contextlib.contextmanager
def _stats_kernel(path):
    """The inorm library at ``path`` in place of the real one, with fresh
    counters before and after."""
    real = build.load("inorm")
    build._LIBS["inorm"] = build.bind(ctypes.CDLL(str(path)), "inorm")
    inorm._TICKETS.clear()
    try:
        yield
    finally:
        torch.cuda.synchronize()
        build._LIBS["inorm"] = real
        inorm._TICKETS.clear()


FAULTS = [
    ("dx zeroed", wconv, "conv3d_dx", lambda f: lambda g, wt: torch.zeros_like(f(g, wt))),
    ("dx zeroed at G_A double_conv1.conv1", wconv, "conv3d_dx", _dx_zero_on_call(3)),
    ("dx halved on the 128-channel output", wconv, "conv3d_dx",
     lambda f: lambda g, wt: f(g, wt) * (0.5 if wt.shape[2] == 128 else 1.0)),
    ("dw halved", wconv, "conv3d_dw", lambda f: lambda x, g: f(x, g) * 0.5),
    ("dw centre tap zeroed", wconv, "conv3d_dw", _dw_centre_tap_zeroed),
    ("bwd_map without its mgy term", inorm, "bwd_map",
     lambda f: lambda g3, y3, rstd, mg, mgy, act: f(g3, y3, rstd, mg, torch.zeros_like(mgy), act)),
    ("pair_sums_gy without the activation's derivative", inorm, "pair_sums_gy",
     lambda f: lambda g3, y3, act=None: f(g3, y3, None)),
    ("forward conv without its last channel stage at cin 128", wconv, "conv3d",
     _fwd_last_stage_dropped),
    ("dw without the last voxel box of each chunk", wconv, "conv3d_dw",
     _dw_last_box_of_each_chunk_skipped),
]


def kernel_checks(dev, seed) -> list:
    """The smoke's kernel checks (the kernels phases' W-pair forward and norm
    at the tile batch's shapes, dx, dw and the norm at the 108^3 step's),
    untimed: the failures they raise."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bad = []
    for check in (lambda: cs.check_conv(gen, dev, wconv, cs.CONV_SHAPES, timed=False),
                  lambda: cs.check_train_conv(gen, dev, timed=False),
                  lambda: cs.check_norm(gen, dev, timed=False),
                  lambda: cs.check_train_norm(gen, dev, timed=False)):
        try:
            check()
        except AssertionError as e:
            bad.append(f"kernel check: {e}")
        torch.cuda.empty_cache()
    return bad


def run(label, seed, vol, dev) -> int:
    runs = cs.step_three_ways(seed, vol, dev)
    bad, stats = cs.judge_step(runs)
    step_bad = len(bad)
    bad += kernel_checks(dev, seed)
    cs.log(f"== {label}: {len(bad)} failures ({step_bad} of the step check, "
           f"{len(bad) - step_bad} of the kernel checks)")
    cs.log("   relative L2 against f32 (kernels / plain bf16): " + ", ".join(
        f"{g} {ek:.4g} / {ep:.4g}" for g, (ek, ep) in stats["pooled"].items()))
    for g, top in stats["direct"].items():
        cs.log(f"   against the plain bf16 step, {g}: "
               + ", ".join(f"{d:.4g} ({k})" for d, k in top))
    for b in bad[:4] + bad[step_bad:][:2]:
        cs.log(f"   {b}")
    return len(bad)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke_faults: no CUDA device; this check runs on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    vol = cs.synthetic_volume(args.seed, cs.TRAIN_VOLUME)
    stats_libs = _build_stats_faults()
    ok = run("as it is", args.seed, vol, dev) == 0
    faults = [(label, _swapped(module, name, wrap)) for label, module, name, wrap in FAULTS]
    faults += [(label, _stats_kernel(path)) for (label, _, _), path in zip(STATS_FAULTS,
                                                                           stats_libs)]
    for label, fault in faults:
        with fault:
            ok &= run(label, args.seed, vol, dev) > 0
    cs.log("every fault fails a check" if ok else "FAILED: see above")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
