#!/usr/bin/env python3
"""Fault check of ``chip_smoke.py``'s rotation, training-step and kernel
checks on one NVIDIA GPU.

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
check.  Before those, the smoke's rotation check (``check_rotation``: the
rotated crops of the sampler against a float64 reference) runs as it is and
with each faulty sampler: the rotation's angle with its sign flipped, and
its inverse affine transposed (the geometry the sampler reads replaced; the
reference keeps the real one).  Last, the study phase's two checks at
148^3 from the trained nets: the accumulation (``check_accumulation``)
with an accumulator that drops the last crop and with one that divides by
N - 1, and remat against no remat (``check_remat``) with a remat whose
recomputation runs a U-Net skip block on a zeroed skip half; and its
trained-weight step check with the faulty wrappers above that it must
catch (``TRAINED_STEP_FAULTS``).  Then the checks of the slice's other
models and of the host chain (``NEW_FAULTS``): Athena's losses against
their restated formulas (``check_athena_terms``) with D_A_yz probing the
real crop on the source axis, and with ``all_slices`` slicing the next
axis; Dryops' accumulation (``check_dryops_accumulation``) with an
accumulator that redraws the probes for each crop; the host chain's
rotation (``check_host_rotation``) with a warp whose source coordinates
are 1/32 pixel off.  It exits nonzero unless the runs as they are pass
their checks and every fault fails one.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

import chip_smoke as cs
from neuroclear_tpu_torch import test_dice
from neuroclear_tpu_torch.data import warp
from neuroclear_tpu_torch.data.dicing import DiceCube
from neuroclear_tpu_torch.models import axial_to_lateral_gan_athena_model as athena
from neuroclear_tpu_torch.models import gan_common
from neuroclear_tpu_torch.models.axial_to_lateral_gan_apollo_model import ApolloModel
from neuroclear_tpu_torch.models.axial_to_lateral_gan_dryops_model import DryopsModel
from neuroclear_tpu_torch.nn import generators
from neuroclear_tpu_torch.ops import augment, build, conv3x3, inorm, wconv
from neuroclear_tpu_torch.utils.assemble import Assemble_Dice


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


def _angle_sign_flipped(f):
    return lambda w, h, angle: f(w, h, -angle)


def _inverse_transposed(f):
    def fn(w, h, angle):
        g = f(w, h, angle)
        i00, i01, i02, i10, i11, i12 = g.inv
        return g._replace(inv=(i00, i10, i02, i01, i11, i12))
    return fn


SAMPLER_FAULTS = [("rotation angle's sign flipped", _angle_sign_flipped),
                  ("inverse affine transposed", _inverse_transposed)]


def _yx_steps_swapped(f):
    """A DiceCube that cuts cube (z, x, y) where (z, y, x) is asked for."""
    def fn(self, index):
        z, y, x = self.grid.index_to_3d(index)
        g = self.grid
        return f(self, (z * g.y_steps + x) * g.x_steps + y)
    return fn


def _last_cube_dropped(f):
    """An Assemble_Dice that never stacks the last cube."""
    def fn(self, cube):
        if len(self.cube_queue["fake"]) < self.len_cube_queue - 1:
            f(self, cube)
    return fn


HOST_FAULTS = [("DiceCube with the y and x steps swapped", DiceCube, "__getitem__",
                _yx_steps_swapped),
               ("Assemble_Dice without the last cube", Assemble_Dice, "addToStack",
                _last_cube_dropped)]


def _last_crop_dropped(f):
    """An accumulator that never runs the last crop (and so divides by
    N - 1)."""
    def fn(self, crop, n, draws):
        return f(self, crop, n - 1, draws)
    return fn


def _divided_by_n_minus_1(f):
    def fn(self, crop, n, draws):
        losses, real, fake, rec, g_acc, d_acc = f(self, crop, n, draws)
        scale = n / (n - 1)
        return losses, real, fake, rec, [g * scale for g in g_acc], [g * scale for g in d_acc]
    return fn


def _skip_zeroed_on_recompute(f):
    """A remat whose recomputation of a U-Net skip block (the checkpoints
    of two inputs) runs it on a zeroed skip half."""
    def fn(block, *args):
        if len(args) != 2:
            return f(block, *args)
        calls = [0]

        def faulty(skip, up):
            calls[0] += 1
            return block(skip if calls[0] == 1 else torch.zeros_like(skip), up)
        return f(faulty, *args)
    return fn


ACCUM_FAULTS = [("accumulator without the last crop", ApolloModel, "accumulate",
                 _last_crop_dropped),
                ("accumulator divided by N - 1", ApolloModel, "accumulate",
                 _divided_by_n_minus_1)]
REMAT_FAULTS = [("remat recomputing a skip block without its skip half", generators,
                 "checkpointed", _skip_zeroed_on_recompute)]
# The faulty wrappers the trained-weight step check must catch: all but the
# dw that skips one voxel box of each chunk (at most 1 in 32 of its voxels),
# which moves that step less than bf16 rounding does (measured on an H100:
# the check passes it); the kernel checks of ``run`` catch it
TRAINED_STEP_FAULTS = [f for f in FAULTS if f[0] != "dw without the last voxel box of each chunk"]


def _d_a_yz_real_on_source(pairs):
    """Athena's D step with D_A_yz probing the real crop on the source axis
    (the symmetric-looking pairing the JAX step does not have)."""
    return [("D_A_yz", "source", "fake", "source") if p[0] == "D_A_yz" else p for p in pairs]


def _next_axis(f):
    """``all_slices`` slicing the next axis."""
    def fn(vol, axis):
        return f(vol, (axis + 1) % 3)
    return fn


def _redraws_per_crop(f):
    """An accumulator that draws new probes for every crop after the first
    (JAX closes one step's draws over all N)."""
    def fn(self, crop, n, draws):
        gen = torch.Generator().manual_seed(1234)
        outs = []
        for i in range(n):
            d = draws if i == 0 else self.draw_probes(tuple(crop(i).shape[1:4]), gen)
            outs.append(f(self, lambda _, i=i: crop(i), 1, d))
        losses = {k: torch.stack([o[0][k] for o in outs]).mean() for k in outs[0][0]}
        g = [sum(o[-2][j] for o in outs) / n for j in range(len(outs[0][-2]))]
        d = [sum(o[-1][j] for o in outs) / n for j in range(len(outs[0][-1]))]
        return (losses, *outs[-1][1:-2], g, d)
    return fn


def _off_by_a_32nd(f):
    """The warp's source x coordinates 1/32 pixel off."""
    def fn(m_inv, width, height):
        sx, sy = f(m_inv, width, height)
        return sx + np.float32(1 / 32), sy
    return fn


@contextlib.contextmanager
def _replaced(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def new_model_failures(seed, dev) -> bool:
    """Athena's restated-loss check, Dryops' accumulation check and the host
    rotation check as they are (each must pass) and with each of their
    faults (each must fail); returns whether all did as they must."""
    vol = cs.synthetic_volume(seed + 10, cs.ATHENA_VOLUME)
    flats = cs.athena_flats()
    real, _ = cs.athena_inputs(vol, dev, seed + 11)(None)
    train_vol = cs.synthetic_volume(seed + 12, cs.TRAIN_VOLUME)
    checks = [
        ("Athena losses", lambda: cs.check_athena_terms(cs.athena_model(flats, dev), real),
         [("D_A_yz's real probed on the source axis",
           _replaced(athena, "D_PAIRS", _d_a_yz_real_on_source(athena.D_PAIRS))),
          ("all_slices on the next axis", _swapped(gan_common, "all_slices", _next_axis))]),
        ("Dryops accumulation", lambda: cs.check_dryops_accumulation(train_vol, dev, seed),
         [("Dryops accumulator redrawing per crop",
           _swapped(DryopsModel, "accumulate", _redraws_per_crop))]),
        ("host rotation", lambda: cs.check_host_rotation(cs.synthetic_volume(seed + 20,
                                                                             cs.TRAIN_VOLUME)),
         [("host warp 1/32 pixel off", _swapped(warp, "_source_coords", _off_by_a_32nd))]),
    ]
    ok = True
    for name, check, faults in checks:
        for i, (label, fault) in enumerate([(f"{name} as it is", contextlib.nullcontext())]
                                           + faults):
            try:
                with fault:
                    check()
            except AssertionError as e:
                cs.log(f"== {label}: the {name} check fails: {str(e)[:300]}")
                ok &= i > 0
            else:
                cs.log(f"== {label}: the {name} check passes")
                ok &= i == 0
            torch.cuda.empty_cache()
    return ok


def study_failures(seed, dev) -> bool:
    """The study phase's accumulation and remat checks as they are (each
    must pass) and with each of their faults (each must fail), and its
    trained-weight step check with each of TRAINED_STEP_FAULTS;
    returns whether all did as they must."""
    flats, vol = cs.study_flats(), cs.synthetic_volume(seed, cs.STUDY_VOLUME)

    def step():
        runs, _ = cs.accum_step_three_ways(flats, vol, dev, seed)
        bad, _ = cs.judge_step(runs, cs.STUDY_DIRECT)
        if bad:
            raise AssertionError(f"{len(bad)} failures: " + "; ".join(bad[:3]))

    def accumulation():
        model = cs.study_model(flats, dev)
        crop, draws = cs.study_inputs(vol, dev, seed + 7, 2, model)
        cs.check_accumulation(model, crop, 2, draws)

    def remat():
        cs.check_remat(flats, vol, dev, seed)

    ok = True
    for check, name, faults in ((accumulation, "accumulation", ACCUM_FAULTS),
                                (remat, "remat", REMAT_FAULTS),
                                (step, "trained-weight step", TRAINED_STEP_FAULTS)):
        runs = [(f"{name} as it is", contextlib.nullcontext())]
        runs += [(label, _swapped(owner, attr, wrap)) for label, owner, attr, wrap in faults]
        for i, (label, fault) in enumerate(runs):
            try:
                with fault:
                    check()
            except AssertionError as e:
                cs.log(f"== {label}: the {name} check fails: {e}")
                ok &= i > 0
            else:
                cs.log(f"== {label}: the {name} check passes")
                ok &= i == 0
            torch.cuda.empty_cache()
    return ok


def legacy_failures(seed, dev) -> bool:
    """The per-cube loop's check as it is (must pass) and with each host
    fault (each must fail it); returns whether all did as they must."""
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        argv, _, vol, root = cs.legacy_inputs(seed, tmp, cs.VOLUME)
        expected = cs.per_cube_launches(len(cs.legacy_grid(vol)))
        fused = test_dice.main([a for a in argv if a != "--legacy_pipeline"]
                               + ["--precision", "float32", "--results_dir",
                                  os.path.join(root, "fused")])["fake"]
        for i, (label, fault) in enumerate([("per-cube loop as it is", contextlib.nullcontext())]
                                           + [(label, _swapped(cls, name, wrap))
                                              for label, cls, name, wrap in HOST_FAULTS]):
            try:
                with fault:
                    res, _ = cs.run_per_cube(argv, os.path.join(root, f"r{i}"), expected)
                    cs.check_lsb(label, res["fake"], fused, cs.LEGACY_MAX_LSB,
                                 cs.LEGACY_MEAN_LSB)
            except AssertionError as e:
                cs.log(f"== {label}: the per-cube check fails: {e}")
                ok &= i > 0
            else:
                cs.log(f"== {label}: the per-cube check passes")
                ok &= i == 0
    return ok


def rotation_failures(label, vol, dev, seed) -> int:
    """1 if the smoke's rotation check fails, else 0."""
    try:
        cs.check_rotation(vol, dev, seed)
    except AssertionError as e:
        cs.log(f"== {label}: the rotation check fails: {e}")
        return 1
    cs.log(f"== {label}: the rotation check passes")
    return 0


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
    ok = rotation_failures("sampler as it is", vol, dev, args.seed) == 0
    for label, wrap in SAMPLER_FAULTS:
        with _swapped(augment, "rotation_geometry", wrap):
            ok &= rotation_failures(label, vol, dev, args.seed) > 0
    stats_libs = _build_stats_faults()
    ok &= run("as it is", args.seed, vol, dev) == 0
    faults = [(label, _swapped(module, name, wrap)) for label, module, name, wrap in FAULTS]
    faults += [(label, _stats_kernel(path)) for (label, _, _), path in zip(STATS_FAULTS,
                                                                           stats_libs)]
    for label, fault in faults:
        with fault:
            ok &= run(label, args.seed, vol, dev) > 0
    ok &= legacy_failures(args.seed, dev)
    ok &= study_failures(args.seed, dev)
    ok &= new_model_failures(args.seed, dev)
    cs.log("every fault fails a check" if ok else "FAILED: see above")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
