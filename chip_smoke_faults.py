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
are 1/32 pixel off.  Last, the checks of the zoo slice (``zoo_failures``):
the spectral norm against its restatement (``check_spectral``) with a
spectral norm that runs one power iteration and updates ``u`` in place, as
``torch.nn.utils.spectral_norm`` does; the batch-norm refresh against its
restated formula (``batchnorm_lockstep``'s ``check_refresh``) with a refresh
that takes the unbiased variance; ``test_dice --norm batch`` against its
plain path (``batchnorm_dice``) with a ``TestModel`` that switches the
generator to its running statistics without ``--eval``; ResNet's transposed
conv against the restated scatter (``check_resnet_transpose``) with the
transpose's kernel unflipped (a correlation, as JAX's ``conv_transpose``
computes without the flip).  Last, the dp phase's gloo checks
(``dp_failures``: two ranks of ``chip_smoke.py --dp-rank`` on the card with a
fault installed in each): one rank skipping the gradient all-reduce (the
ranks' state must diverge), the run generator seeded with seed + rank (the
step is no longer the ``--grad_accum 2`` step), batch norm on per-rank
statistics (no longer the batched step), one rank's slab delta dropped (the
sharded pipeline leaves its one-LSB bound).  Last, the quality-study
phase's checks (``quality_failures``): the generated volumes' digest with
the generator's axial sigma applied along x; the checkpoint selection
(``check_selection``) with a selection of the newest eval instead of the
argmax; the accum-2 study step three ways (``quality_accum_three_ways``)
with a host window sliced one voxel off in y and with a fused form that
cuts its crops from other draws than the step's.  Last, the checks of the
JAX argv (``cli_failures``): the train phase's ``--min_projection_depth``
steps and depth draws (``run_min_depth``) with a depth sampler that keeps
the lower bound 2, and ``test_dice --model test --add_date --verbose``
(``dice_jax_flags_run``) with a parser that has no ``--model`` (argparse
then reads ``--model test`` as ``--model_suffix test``).  Last, the tools
phase's checks (``tools_failures``): the 148^3 step count on the card
against its count from shapes (``tools_count``) with hand kernels that add
no FLOPs (``flops.hand`` a no-op), and the profiler's compute leg against
``run_streaming`` (``tools_profile``) with a compute leg that skips a slab.
It exits nonzero unless the runs as they are pass their checks and every fault fails one.
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
import torch.nn.functional as F

import chip_smoke as cs
from neuroclear_tpu_torch import test_dice
from neuroclear_tpu_torch.data import warp
from neuroclear_tpu_torch.data.dicing import DiceCube
from neuroclear_tpu_torch.data.singlevolume_dataset import SingleVolumeDataset
from neuroclear_tpu_torch.models import axial_to_lateral_gan_athena_model as athena
from neuroclear_tpu_torch.models import gan_common
from neuroclear_tpu_torch.models.axial_to_lateral_gan_apollo_model import ApolloModel
from neuroclear_tpu_torch.models.axial_to_lateral_gan_dryops_model import DryopsModel
from neuroclear_tpu_torch.models.test_model import TestModel
from neuroclear_tpu_torch.nn import core, norms
from neuroclear_tpu_torch.nn.factory import define_D, define_G
from neuroclear_tpu_torch.utils.weights import init_flat, params_from_numpy
from neuroclear_tpu_torch.nn import generators
from neuroclear_tpu_torch.ops import augment, build, conv3x3, flops, inorm, wconv
from neuroclear_tpu_torch.options import test_options
from neuroclear_tpu_torch.scripts import profile_inference, select_checkpoint
from neuroclear_tpu_torch.utils import synthetic
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


def _one_iteration_u_updated(f):
    """The spectral norm as ``torch.nn.utils.spectral_norm`` runs it: one
    power iteration from ``u``, and ``u`` updated in place."""
    def fn(self, n_iter=3):
        with torch.no_grad():
            wm = self.weight.reshape(self.out_c, -1)
            v = wm.t() @ self.u
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
            u = wm @ v
            u = u / (torch.linalg.vector_norm(u) + 1e-12)
            self.u.copy_(u)
            sigma = u @ (wm @ v)
        return self.weight / sigma
    return fn


def _unbiased_statistics(f):
    """Batch norm handing the refresh the unbiased variance (torch's
    BatchNorm's running update)."""
    def fn(self, x):
        outer = norms._STATS_COLLECTOR
        if outer is None or self.use_running:
            return f(self, x)
        with norms.collect_batch_stats() as mine:
            y = f(self, x)
        n = x.numel() // x.shape[-1]
        outer.extend((m, mean, var * n / (n - 1)) for m, mean, var in mine)
        return y
    return fn


def _running_statistics_always(f):
    """TestModel putting its generator on the running statistics whether or
    not --eval is given."""
    def fn(self, opt, device=None):
        f(self, opt, device)
        norms.set_eval(self.netG)
    return fn


def _kernel_unflipped(f):
    """The transposed conv on its kernel flipped spatially."""
    def fn(self, x):
        conv = F.conv_transpose3d if self.dim == 3 else F.conv_transpose2d
        w = self.weight.flip(tuple(range(2, self.weight.dim())))
        y = core._channels_last(conv(core._channels_first(x), w.to(x.dtype), None, self.stride,
                                     self.padding, self.output_padding))
        return y + self.bias.to(y.dtype) if self.bias is not None else y
    return fn


def _spectral_check(seed, dev):
    """The zoo phase's spectral check on a basic_SN discriminator after a
    forward and backward at the probe shape."""
    net = define_D(1, 64, "basic_SN", 3, "instance")
    net.load_state_dict(params_from_numpy(init_flat(net, seed=seed), net))
    net.to(dev)
    x = torch.rand(cs.ZOO_D_SHAPE, device=dev)
    net(x).float().sum().backward()
    cs.check_spectral(net)


def _batchnorm_checkpoint(seed, root) -> str:
    """A --norm batch UNetDeconv checkpoint with running statistics of its
    own (random means and variances), written under ``root``."""
    net = define_G(1, 1, 64, "unet_deconv", "batch")
    flat = init_flat(net, seed=seed)
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if k.endswith(".running_mean"):
            flat[k] = (rng.normal(size=v.shape) * 0.1).astype(np.float32)
        elif k.endswith(".running_var"):
            flat[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    path = os.path.join(root, "bn_net_G_A.npz")
    np.savez(path, **flat)
    return path


# The dp phase's faults, installed in each gloo rank (``--dp-fault
# chip_smoke_faults:<function>``, called with the rank before its tasks):
# none may hang a collective, so a faulty rank still joins every one.


def dp_fault_reduce_skipped(rank):
    """Rank 1 joins the gradient all-reduce on a copy and steps on its own
    gradients: the ranks' parameters diverge."""
    from neuroclear_tpu_torch.parallel import train_parallel

    reduce = train_parallel.DataParallel.reduce

    def fn(self, losses, g, d):
        out = reduce(self, losses, [x.clone() for x in g], [x.clone() for x in d])
        return (out[0], list(g), list(d)) if rank == 1 else out
    train_parallel.DataParallel.reduce = fn


def dp_fault_seed_plus_rank(rank):
    """Each rank's run generator seeded with seed + rank: its crop and probe
    draws are not the --grad_accum step's."""
    main = sys.modules["__main__"]
    main.dp_generator = lambda seed, r: torch.Generator().manual_seed(seed + r)


def dp_fault_local_batch_stats(rank):
    """Batch norm on each rank's own statistics (DataParallel's cross-rank
    sum never installed)."""
    norms.set_cross_rank = lambda fn, world: None


def dp_fault_delta_dropped(rank):
    """Rank 1's slab delta zeroed before the all-reduce: its tiles are
    missing from the assembled volume."""
    from neuroclear_tpu_torch.parallel.dice_infer import DiceInferencePipeline

    def merge(delta):
        if rank == 1:
            delta.zero_()
        torch.distributed.all_reduce(delta)
    DiceInferencePipeline._merge = staticmethod(merge)


DP_FAULTS = [("one rank skipping the gradient all-reduce", "dp_fault_reduce_skipped", "apollo"),
             ("the run generator seeded with seed + rank", "dp_fault_seed_plus_rank", "apollo"),
             ("batch norm on per-rank statistics", "dp_fault_local_batch_stats", "batchnorm"),
             ("one rank's slab delta dropped", "dp_fault_delta_dropped", "dice")]


def dp_failures(seed) -> bool:
    """The dp phase's gloo checks with each fault (each must fail; the
    phase as it is runs in chip_smoke.py); returns whether all did."""
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for label, fn, task in DP_FAULTS:
            ranks = cs.dp_gloo(seed, tmp, (task,), f"chip_smoke_faults:{fn}")
            try:
                cs.judge_dp(task, ranks)
            except AssertionError as e:
                cs.log(f"== {label}: the dp {task} check fails: {str(e)[:300]}")
            else:
                cs.log(f"== {label}: the dp {task} check passes")
                ok = False
    return ok


def zoo_failures(seed, dev) -> bool:
    """The zoo slice's checks as they are (each must pass) and with each of
    their faults (each must fail); returns whether all did as they must."""
    vol = cs.synthetic_volume(seed + 31, cs.TRAIN_VOLUME)
    dice_vol = cs.synthetic_volume(seed)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        g_a = _batchnorm_checkpoint(seed, tmp)
        runs = iter(range(1000))
        checks = [
            ("spectral norm", lambda: _spectral_check(seed, dev),
             [("spectral norm with one iteration, u updated in place",
               _swapped(core.Conv, "spectral_weight", _one_iteration_u_updated))]),
            ("batch-norm refresh", lambda: cs.batchnorm_lockstep(vol, dev, seed, 1),
             [("refresh with the unbiased variance",
               _swapped(norms.BatchNorm, "forward", _unbiased_statistics))]),
            ("test_dice --norm batch", lambda: cs.batchnorm_dice(
                g_a, dice_vol, os.path.join(tmp, f"r{next(runs)}"), dev),
             [("TestModel on the running statistics without --eval",
               _swapped(TestModel, "__init__", _running_statistics_always))]),
            ("ResNet transposed conv", lambda: cs.check_resnet_transpose(dev, seed),
             [("transposed conv with its kernel unflipped",
               _swapped(core.ConvTranspose, "forward", _kernel_unflipped))]),
        ]
        for name, check, faults in checks:
            for i, (label, fault) in enumerate([(f"{name} as it is",
                                                 contextlib.nullcontext())] + faults):
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


def _window_shifted_in_y(f):
    """A host window sliced one voxel off in y from the place its plan
    gives the gather."""
    def fn(self, angle, offsets, flips):
        plan = augment.window_plan(self.shape, angle, offsets, self.crop_size)
        (z0, z1), (y0, y1), (x0, x1) = plan
        dy = 1 if y1 < self.shape[1] else -1
        window = self._upload(self.host_vol[z0:z1, y0 + dy:y1 + dy, x0:x1])
        out = augment.sample_window_crop(window, plan, self.shape, angle, offsets,
                                         self.crop_size, self.inv_scale, flips)
        return out[None, ..., None]
    return fn


def _newest_selected(f):
    """A selection that takes the newest eval instead of the argmax."""
    return lambda rows: rows[-1] if rows else None


def _axial_sigma_along_x(f):
    """The generator's blur with its sigmas reversed: the axial sigma
    applied along x."""
    return lambda vol, sigmas: f(vol, tuple(sigmas)[::-1])


def _fused_from_other_keys(f):
    """A resident batch cut from draws of another generator than the
    step's."""
    def fn(self, generator, n):
        return f(self, torch.Generator().manual_seed(int(generator.initial_seed()) + 1), n)
    return fn


def _quality_logs(logd: str) -> None:
    """Two eval logs as the port's ``test_dice`` prints them, the earlier
    the better, and the driver's selection on them."""
    os.makedirs(logd)
    for it, (p_in, p_out, s_out) in ((11002, (21.49, 20.75, 0.33)),
                                     (11006, (21.49, 19.86, 0.25))):
        with open(os.path.join(logd, f"eval_{it}.log"), "w") as f:
            f.write("Network Input vs. Groundtruth\n(psnr: %.4f) \n(ssim: 0.4590) \n"
                    "---------------------------------------------------------\n"
                    "Network Output vs. Groundtruth\n(psnr: %.4f) \n(ssim: %.4f) \n"
                    % (p_in, p_out, s_out))
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        select_checkpoint.main([logd, "--write"])


def quality_failures(seed, dev) -> bool:
    """The quality-study phase's checks as they are (each must pass) and
    with each fault (each must fail): the volumes' digest
    (``check_quality_volumes``) with the axial sigma along x; the selection
    (``check_selection``) with a selection of the newest eval; the accum-2
    study step three ways (``quality_accum_three_ways``) with a host window
    shifted by one voxel in y and with a fused form that cuts its crops from
    other draws.  Returns whether all did as they must."""
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        cs.check_quality_volumes(data)
        n = [0]

        def fresh():
            n[0] += 1
            return os.path.join(tmp, f"run{n[0]}")

        def volumes():
            cs.check_quality_volumes(fresh())

        def selection():
            d = fresh()
            _quality_logs(os.path.join(d, "log"))
            cs.check_selection(os.path.join(d, "log"), d)

        bank = cs.quality_bank(tmp)

        def three_ways():
            d = fresh()
            os.makedirs(d)
            cs.quality_accum_three_ways(data, bank, d, dev, seed)

        checks = [
            ("quality volumes", volumes,
             [("the axial sigma applied along x",
               _swapped(synthetic, "_gaussian_blur_separable", _axial_sigma_along_x))]),
            ("selection", selection,
             [("the newest eval selected", _swapped(select_checkpoint, "select",
                                                    _newest_selected))]),
            ("accum-2 three ways", three_ways,
             [("a host window shifted by one voxel in y",
               _swapped(SingleVolumeDataset, "window_crop", _window_shifted_in_y)),
              ("the fused crops cut from other draws",
               _swapped(SingleVolumeDataset, "sample_batch", _fused_from_other_keys))]),
        ]
        for name, check, faults in checks:
            for i, (label, fault) in enumerate([(f"{name} as it is",
                                                 contextlib.nullcontext())] + faults):
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


def _min_depth_ignored(f):
    def fn(cfg, generator):
        if not cfg.randomize_projection_depth:
            return cfg.projection_depth
        return int(torch.randint(2, cfg.projection_depth + 1, (), generator=generator))
    return fn


def _model_flag_dropped(f):
    """The test parser without ``--model`` (its default kept): argparse
    expands ``--model test`` to ``--model_suffix test`` by prefix."""
    def fn(argv=None):
        p = f(argv)
        action = p._option_string_actions.pop("--model")
        p._actions.remove(action)
        for group in p._action_groups:
            if action in group._group_actions:
                group._group_actions.remove(action)
        p.set_defaults(model="test")
        return p
    return fn


def cli_failures(seed, dev) -> bool:
    """The JAX argv's checks as they are and with their faults."""
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        cs.tiffio.imwrite(os.path.join(data, "volume.tif"),
                          cs.synthetic_volume(seed, cs.TRAIN_VOLUME))
        n = iter(range(100))

        def min_depth():
            cs.run_min_depth(seed, data, os.path.join(tmp, f"ck{next(n)}"))

        def dice_flags():
            cs.dice_jax_flags_run(seed, os.path.join(tmp, f"dice{next(n)}"))

        checks = [
            ("--min_projection_depth", min_depth,
             [("the depth drawn from 2", _swapped(gan_common, "sample_projection_depth",
                                                  _min_depth_ignored))]),
            ("test_dice JAX flags", dice_flags,
             [("--model read as --model_suffix", _swapped(test_options, "build_parser",
                                                          _model_flag_dropped))]),
        ]
        for name, check, faults in checks:
            for i, (label, fault) in enumerate([(f"{name} as it is",
                                                 contextlib.nullcontext())] + faults):
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


def _hand_flops_dropped(f):
    def fn(kind, n):
        return None
    return fn


def _slab_skipped(f):
    def fn(pipe, vp, chunks):
        st = pipe.prepare(vp, chunks)
        rows = []
        for i in range(pipe.grid.z_steps):  # slab 1's rows emitted without its tiles
            batches, st.batches = st.batches, [] if i == 1 else st.batches
            rows.append(pipe.slab_rows(st, i))
            st.batches = batches
        return st, rows
    return fn


def tools_failures(dev) -> bool:
    """The tools phase's two checks as they are and with their faults: the
    step count on the card against the count from shapes with hand kernels
    that add no FLOPs, and the profiler's compute leg against
    ``run_streaming`` with a compute leg that skips a slab."""
    ok = True
    checks = [
        ("count_step_flops", lambda: cs.tools_count(True),
         [("hand kernels counting no FLOPs", _swapped(flops, "hand", _hand_flops_dropped))]),
        ("profile_inference", lambda: cs.tools_profile(*cs.TOOLS_PROFILE, dev),
         [("a compute leg skipping a slab", _swapped(profile_inference, "compute_rows",
                                                     _slab_skipped))]),
    ]
    for name, check, faults in checks:
        for i, (label, fault) in enumerate([(f"{name} as it is",
                                             contextlib.nullcontext())] + faults):
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
    ok &= zoo_failures(args.seed, dev)
    ok &= dp_failures(args.seed)
    ok &= quality_failures(args.seed, dev)
    ok &= cli_failures(args.seed, dev)
    ok &= tools_failures(dev)
    cs.log("every fault fails a check" if ok else "FAILED: see above")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
