#!/usr/bin/env python3
"""Fault check of ``chip_smoke.py``'s training-step check on one NVIDIA GPU.

    python3 chip_smoke_faults.py [--seed N]

Runs the smoke's three-way step (``step_three_ways``: kernels in bf16, plain
versions in bf16 and in f32, 108^3, identical weights, crop and draws) once
as it is and once per fault, where a faulty wrapper stands in for one
backward kernel in the kernel step only, and judges each with the smoke's own
``judge_step``.  It prints, per run, the gradient errors against f32, the
largest tensor errors against the plain bf16 step and the failures, and
exits nonzero unless the run as it is passes and every fault fails.
"""

from __future__ import annotations

import argparse
import functools
import sys

import torch

import chip_smoke as cs
from neuroclear_tpu_torch.ops import inorm, wconv


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
]


def run(label, seed, vol, dev) -> int:
    runs = cs.step_three_ways(seed, vol, dev)
    bad, stats = cs.judge_step(runs)
    cs.log(f"== {label}: {len(bad)} failures")
    cs.log("   relative L2 against f32 (kernels / plain bf16): " + ", ".join(
        f"{g} {ek:.4g} / {ep:.4g}" for g, (ek, ep) in stats["pooled"].items()))
    for g, top in stats["direct"].items():
        cs.log(f"   against the plain bf16 step, {g}: "
               + ", ".join(f"{d:.4g} ({k})" for d, k in top))
    for b in bad[:4]:
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
    ok = run("as it is", args.seed, vol, dev) == 0
    for label, module, name, wrap in FAULTS:
        kernel = getattr(module, name)
        fault = functools.update_wrapper(wrap(kernel), kernel)  # keeps .launches
        setattr(module, name, fault)
        try:
            ok &= run(label, args.seed, vol, dev) > 0
        finally:
            setattr(module, name, kernel)
    cs.log("every fault fails the step check" if ok else "FAILED: see above")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
