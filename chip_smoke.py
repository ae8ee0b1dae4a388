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
     path gives it (the norm's also in f32 at one 140^3 cube's of the
     per-cube loop) (the dense-K conv at the four half-resolution 128-output
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
  7. legacy: ``test_dice.main --legacy_pipeline`` (the per-cube loop, each
     cube alone in f32 through the model and back to the host, then
     ``Assemble_Dice``) on the slice's volume, weights and flags (27 cubes of
     140^3): its launches exact (the norm's two kernels ten times per cube,
     no W-pair conv), its wall time and cubes per second, its output held
     against the same loop on the plain versions and against the fused path
     in f32, its two galleries (every PNG's signature and IHDR); then
     ``--repetition --histogram_match`` on a 160^3 volume (8 cubes x 4 flips)
     against the plain versions; then the non-streaming entry point
     (``DiceInferencePipeline.run``, bf16) against ``run_streaming``, bit
     for bit, with its launches;
  8. train: ``neuroclear_tpu_torch.train_onecube.main`` with the production
     command of ``train_onecube.py`` (``random3Drotate``, 108^3 crops,
     ``--display_histogram --add_date``) plus ``--precision bfloat16``, as
     the JAX study passes it, on a synthetic 160^3 uint16 TIFF, Kaiming
     weights from the seed: one warm-up step and five timed ones on the
     card's clock (the trainer syncs only at the end), the launches of every
     kernel per step checked exactly, the step median printed beside the
     same run without rotation; the command verbatim (f32, the default)
     for two steps, its launches exact (no W-pair conv, the norm's kernels
     in f32); rotated
     crops of the sampler on the card held against an independent float64
     reference (``scipy.ndimage.map_coordinates``, order 1, over the slab at
     the port's host geometry), the sampler run with
     ``torch.cuda.set_sync_debug_mode("error")`` (any device-to-host sync
     fails), its device time and operations; one step from identical
     weights, crop and draws three ways (kernels in bf16, plain versions in
     bf16, plain versions in f32), the kernel path's losses and gradients
     held against f32 no worse than the plain bf16 path's, and each gradient
     tensor against the plain bf16 step's; and the written G_A checkpoint
     run through ``test_dice.main``;
  9. resume: the production command with ``--lr_policy linear`` for three
     steps, then ``--continue_train --load_iter 3``: the reloaded
     parameters, Adam state and schedule position equal to the first run's
     at its save, the next step from both (same crop and draws) as close as
     two runs of that step from one state, and the resumed trainer's two
     steps through its entry point with their launches and checkpoint names;
  10. study: the JAX study's ga8 training command
     (``scripts/run_quality_study.sh``: 148^3 crops, ``--grad_accum 8
     --remat --precision bfloat16 --seed 0``) through ``train_onecube.main``
     on a synthetic 320^3 uint16 TIFF, resumed from the six nets the study
     trained (``study_state/apollo148s4``, iteration 11000) with a fresh
     Adam: one warm-up step and three timed ones, the launches of every
     kernel exact with remat's recomputations counted; one accum-8 step from
     those nets with and without ``--remat``, bitwise equal, with each
     one's peak device memory (remat's lower); one accum-2 step three ways
     judged as the train phase's, printed beside its random-weight errors,
     and its accumulation against the mean of the per-crop gradients;
  11. athena: the JAX study's Athena command (``--model
     axial_to_lateral_gan_athena --conversion_plane yz xy``, 128^3 crops,
     ``--remat``, bf16) through ``train_onecube.main`` on a synthetic 256^3
     TIFF from the eight nets the study trained (``study_state/athena148``)
     with a fresh Adam: four steps, launches exact per step (every
     discriminator norm over 128 slices), the step median; one step with
     and without remat, bitwise equal, with each peak; the 15 losses against
     the JAX step's formulas restated here; one step three ways judged with
     ``ATHENA_DIRECT``;
  12. dryops: ``--model axial_to_lateral_gan_dryops`` at 108^3 from random
     Kaiming weights: four steps, launches exact, the step median, the
     three-way step, and two crops' accumulation under one set of draws;
  13. epoch: the epoch trainer (``neuroclear_tpu_torch.train.main``) with the
     cube dataset over three synthetic 160^3 TIFFs, the production flags in
     bf16, one epoch with the host chain on a prefetching thread: launches
     exact, the host chain's seconds per item beside the step times, the
     epoch's checkpoints, the device's idle share over the epoch loop (the
     epoch again under torch.profiler, its ``epoch_loop`` range), and the
     host chain's rotation against scipy float64;
  14. trained G_A: the slice's tile pipeline on the JAX study's trained
     Apollo G_A, its launches, its bf16 output against the plain versions
     in f32 and in bf16 within ``TRAINED_KP_*``;
  15. profile (only with --profile): a warm run of the slice's tile pipeline
     (without and with the dense-K conv), three warm cubes of the per-cube
     loop (with its copies), a warm training step, a warm study step and a
     warm Athena step under torch.profiler, device time by kernel and the
     device's idle share, and warm steps with and without a sync after each.
Then a ``{"kernels": [...]}`` line (the forward norm's two rows also carry
the 108^3 step's sums as ``step_*`` and one f32 cube's as ``legacy_*``), the nvidia-smi name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.  Any failure raises and
exits nonzero before that line.  The whole run has a 900 s budget.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
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
from neuroclear_tpu_torch import test_dice, train, train_onecube
from neuroclear_tpu_torch.data import find_dataset_using_name, warp
from neuroclear_tpu_torch.data.dicing import DiceGrid
from neuroclear_tpu_torch.data.singlevolume_dataset import SingleVolumeDataset
from neuroclear_tpu_torch.models import create_model
from neuroclear_tpu_torch.models.axial_to_lateral_gan_apollo_model import (
    D_NAMES, G_NAMES, LOSS_NAMES, MODEL_NAMES, ApolloModel)
from neuroclear_tpu_torch.models.axial_to_lateral_gan_athena_model import (
    D_NAMES as ATHENA_D_NAMES, LOSS_NAMES as ATHENA_LOSS_NAMES,
    MODEL_NAMES as ATHENA_MODEL_NAMES)
from neuroclear_tpu_torch.models.axial_to_lateral_gan_dryops_model import (
    D_NAMES as DRYOPS_D_NAMES, LOSS_NAMES as DRYOPS_LOSS_NAMES)
from neuroclear_tpu_torch.nn.factory import define_G
from neuroclear_tpu_torch.nn.losses import gan_loss, l1_loss
from neuroclear_tpu_torch.nn.generators import UNetDeconv
from neuroclear_tpu_torch.ops import build, conv3x3, inorm, rotation, wconv
from neuroclear_tpu_torch.ops.augment import crop_draws
from neuroclear_tpu_torch.options import train_options
from neuroclear_tpu_torch.parallel import metrics as device_metrics
from neuroclear_tpu_torch.parallel.dice_infer import DiceInferencePipeline
from neuroclear_tpu_torch.utils import png, tiffio
from neuroclear_tpu_torch.utils.imageops import dtype_inv_scale, pad_for_dicing
from neuroclear_tpu_torch.utils.weights import init_flat, load_npz, params_from_numpy

BUDGET_S = 900
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
# The per-cube loop (--legacy_pipeline) runs each cube alone and in f32
# whatever --precision says, as the JAX package does: its norms per cube
LEGACY_NORM_SHAPES = [((1, TILE ** 3, 64), 3), ((1, (TILE // 2) ** 3, 128), 4),
                      ((1, (TILE // 4) ** 3, 256), 3)]

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

# Legacy: the per-cube loop with the slice's flags (27 cubes of 140^3, batch
# 1, f32; the W-pair conv's gate is bf16-only, so cuDNN runs every conv) on
# the slice's volume and weights.  Two f32 runs of the generator that differ
# only in sum order (the norm's statistics: kernel against plain; or the
# batch a cube runs in and the input's rounding, f32(x / 65535) against
# f32(x) * f32(1 / 65535): the loop against the fused path in f32) move an
# output by ~1e-6 relative, a few hundredths of a uint16 LSB, which the
# truncating cast turns into 1-LSB flips.  Bound: the generator's own f32
# bound on the CPU (tests/test_torch_dice.py, E2E_LSB) for the worst voxel,
# half an LSB for the mean.
LEGACY_ARGS = [*SLICE_ARGS, "--legacy_pipeline", "--serial_batches", "--preprocess",
               "addColorChannel", "--dataset_mode", "diceImage", "--netG", "unet_deconv",
               "--image_dimension", "3", "--save_volume"]
LEGACY_MAX_LSB, LEGACY_MEAN_LSB = 8, 0.5
# Flip-TTA with histogram matching on a smaller volume (8 cubes, 4 flips
# each), kernel against plain: a voxel whose f32 output lies within the two
# runs' difference of another's may swap ranks with it and take the input
# cube's value at the other rank, so the worst voxel is not bounded.
# Bounds on the mean and on the share of voxels off by more than
# LEGACY_MAX_LSB; measured on an H100 at seed 0: mean 0.035 LSB, 0.024% of
# voxels over 8 LSB (2.4% differ at all, the worst by 2744).
TTA_VOLUME = 160
TTA_ARGS = ["--repetition", "--histogram_match"]
TTA_MEAN_LSB, TTA_FRAC_OVER = 1.0, 0.01

# Train: the production command of train_onecube.py:11-17, verbatim (bf16
# compute with f32 master weights is the port's default precision)
CROP = 108
TRAIN_VOLUME = 160
TRAIN_ITERS = 6  # one warm-up step, then five timed ones
PRODUCTION_ARGS = [
    "--dataset_mode", "singlevolume",
    "--preprocess", "random3Drotate_randomcrop_randomflip_addColorChannel_addBatchChannel",
    "--model", "axial_to_lateral_gan_apollo", "--netG", "unet_deconv",
    "--netG_B", "deep_linear_gen", "--netD", "basic", "--gan_mode", "lsgan",
    "--init_type", "kaiming", "--norm", "instance", "--batch_size", "1", "--lambda_A", "5",
    "--crop_size", str(CROP), str(CROP), str(CROP), "--lambda_plane", "1", "1", "1",
    "--save_by_iter", "--save_latest_freq", "500", "--lr_policy", "constant",
    "--randomize_projection_depth", "--projection_depth", "10", "--display_histogram",
    "--add_date"]
# bf16 compute with f32 master weights, as the JAX study runs it
# (scripts/run_quality_study.sh:91): the timed steps, the resume and the
# profile; the production command as it is (f32 by default) runs F32_ITERS
TRAIN_ARGS = [*PRODUCTION_ARGS, "--precision", "bfloat16"]
F32_ITERS = 2
NO_ROTATION = ["--preprocess", "randomcrop_randomflip_addColorChannel_addBatchChannel"]
# Rotated crops held against scipy's float64 bilinear map over the slab:
# angles away from the multiples of 90 degrees (where sin or cos is zero and
# a flipped sign or a transposed map would not show), and the bound: the
# card's f32 source coordinates (up to ~250, a few ulp of 1.5e-5 each) move
# a sample by at most that times the step between neighbours (< 1 on the
# [0, 1] scale)
ROT_ANGLES = (37.0, 113.0, 211.0, 302.0)
ROT_ATOL = 1e-4
# Resume: a schedule that moves every step (linear decay from iteration 2
# over 8), so a schedule position restored wrong changes the next step
RESUME_ARGS = ["--lr_policy", "linear", "--n_epochs", "2", "--n_epochs_decay", "8"]
# Launches per training step, derived from the nets: the W-pair conv serves
# double_conv1.conv1 and ex_conv1_1.conv0 of G_A and feat1 of G_B, forward
# and backward; every one of the 64 instance norms (G_A's 10, and 3 in each
# of the 18 discriminator applications: 6 probes in the G loss, 12 in the D
# loss) is differentiated.
STEP_LAUNCHES = {"wconv3x3x3": 3, "wconv_dx": 3, "wconv_dw": 3, "pair_sums": 64,
                 "affine_map_act": 64, "pair_sums_gy": 64, "bwd_map": 64, "conv3x3": 0}
# The same with --remat, per crop.  Each U-Net block runs under its own
# checkpoint and each of its n units under one more.  PyTorch's recomputation
# stops at the last tensor its checkpoint saved (early stop, the default):
# a block's is the input of its last unit, so the block's recomputation runs
# its first n - 1 units, and each unit's own recomputation runs it once more.
# A unit's norm is therefore run 3n - 1 times, not n: 5 + 5 + 8 + 5 + 2 = 25
# for G_A's blocks of 2, 2, 3, 2 and 1 units instead of 10, so 64 + 15 of
# each forward norm kernel.  The W-pair conv: double_conv1.conv1 and
# ex_conv1_1.conv0 are their blocks' last units (run twice), and G_B, whole
# under one checkpoint, runs feat1 twice: 6.  The backward is unchanged.
REMAT_STEP_LAUNCHES = {**STEP_LAUNCHES, "wconv3x3x3": 6, "pair_sums": 79,
                       "affine_map_act": 79}
# Athena's step per crop: the same nets' generators, and 18 discriminator
# applications as Apollo's (six all-slices probes in the G loss, twelve in
# the D loss), each a batch of every slice of the crop: so the same launches
# per crop, each norm launch over N = crop slices instead of 1
ATHENA_STEP_LAUNCHES = dict(STEP_LAUNCHES)
ATHENA_REMAT_STEP_LAUNCHES = dict(REMAT_STEP_LAUNCHES)
# Dryops: G_A alone (its two W-pair convs) and nine discriminator
# applications (three in the G loss, six in the D loss): 10 + 27 norms, each
# differentiated; with remat G_A's units run 3n - 1 times (25 norms, each
# W-pair conv twice)
DRYOPS_STEP_LAUNCHES = {"wconv3x3x3": 2, "wconv_dx": 2, "wconv_dw": 2, "pair_sums": 37,
                        "affine_map_act": 37, "pair_sums_gy": 37, "bwd_map": 37, "conv3x3": 0}
DRYOPS_REMAT_STEP_LAUNCHES = {**DRYOPS_STEP_LAUNCHES, "wconv3x3x3": 4, "pair_sums": 52,
                              "affine_map_act": 52}
# The production command without --precision runs in f32: the W-pair conv's
# gate is bf16-only, so cuDNN runs every conv and the norm kernels run in f32
F32_STEP_LAUNCHES = {**STEP_LAUNCHES, "wconv3x3x3": 0, "wconv_dx": 0, "wconv_dw": 0}
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

# Study: the JAX study's training command, scripts/run_quality_study.sh:84-93
# (TRAIN_FLAGS with its default MODEL_FLAGS) as its ga8 run passes it
# (scripts/run_study_queue.sh:56-62: SAVE_FREQ 25, PRINT_FREQ 7, WATCHDOG
# 900, --grad_accum 8), resumed as its segments resume from a bank
# (--continue_train --load_iter), from the six nets the study trained
# (iter 11000 of its s4 run) and a fresh Adam (its 150 MB optimizer file is
# left out).  Cut: the volume, 320^3 instead of 700^3 (it holds the
# 148^3 crop rotated by 45 degrees), and the iterations.
STUDY_CROP, STUDY_VOLUME, STUDY_ACCUM = 148, 320, 8
STUDY_ITERS = 4  # one warm-up step, then three timed ones
STUDY_NAME, STUDY_LOAD_ITER = "apollo148ga8", 11000
STUDY_STATE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "study_state",
                           "apollo148s4")
STUDY_ARGS = [
    "--dataset_mode", "singlevolume",
    "--preprocess", "random3Drotate_randomcrop_randomflip_addColorChannel_addBatchChannel",
    "--model", "axial_to_lateral_gan_apollo", "--lambda_plane", "1", "1", "1",
    "--randomize_projection_depth", "--projection_depth", "10",
    "--netG", "unet_deconv", "--netG_B", "deep_linear_gen", "--netD", "basic",
    "--gan_mode", "lsgan", "--init_type", "kaiming", "--norm", "instance",
    "--batch_size", "1", "--lambda_A", "5",
    "--crop_size", str(STUDY_CROP), str(STUDY_CROP), str(STUDY_CROP),
    "--lr_policy", "constant", "--precision", "bfloat16", "--remat", "--save_by_iter",
    "--save_latest_freq", "25", "--print_freq", "7", "--display_freq", "1000000",
    "--seed", "0", "--watchdog_secs", "900", "--grad_accum", str(STUDY_ACCUM)]
# The accumulated gradients against the mean of the per-crop gradients that
# the smoke computes itself from the same model: the same f32 sums in the
# same order, so equal but for the device's run-to-run noise (none measured:
# the step is deterministic); a crop dropped or a wrong divisor moves them by
# tens of percent
ACCUM_REL_L2 = 1e-6
# The trained-weight step (accum-2, 148^3) judged by judge_step's rule, with
# per-tensor limits against the plain bf16 step set from its own first
# reading on an H100 at seed 0 (largest G_A 0.0744, G_B 0.0422, D 0.0516:
# the trained G_B's gradients move with bf16 rounding ten times as much as
# the random-weight ones, 0.0039, while the kernel path stays closer to f32
# than the plain path, 0.086 against 0.093 pooled), at two to three times
# those, below the faults' 0.5 and more (chip_smoke_faults.py runs them here)
STUDY_DIRECT = {"G_A": 0.15, "G_B": 0.1, "D": 0.15}

# Athena: the JAX study's Athena command (scripts/run_study_queue.sh:74-80,
# MODEL_FLAGS "--model axial_to_lateral_gan_athena --conversion_plane yz xy"
# and CROP 128, with run_quality_study.sh:84-93's TRAIN_FLAGS and their
# default SAVE_FREQ, PRINT_FREQ and WATCHDOG), resumed from the eight nets the
# study trained (iteration 501 of athena148) with a fresh Adam (its 186 MB
# optimizer file is left out), on a synthetic 256^3 uint16 TIFF.  Cut: the
# volume (256^3, not the study's 700^3; it holds the 45-degree rotated 128^2
# crop) and the iterations.  Every discriminator probe is a batch of the
# crop's 128 slices.
ATHENA_CROP, ATHENA_VOLUME, ATHENA_ITERS = 128, 256, 4
ATHENA_NAME, ATHENA_LOAD_ITER = "athena148", 501
ATHENA_STATE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "study_state",
                            "athena148")
ATHENA_ARGS = [
    "--dataset_mode", "singlevolume",
    "--preprocess", "random3Drotate_randomcrop_randomflip_addColorChannel_addBatchChannel",
    "--model", "axial_to_lateral_gan_athena", "--conversion_plane", "yz", "xy",
    "--netG", "unet_deconv", "--netG_B", "deep_linear_gen", "--netD", "basic",
    "--gan_mode", "lsgan", "--init_type", "kaiming", "--norm", "instance",
    "--batch_size", "1", "--lambda_A", "5",
    "--crop_size", str(ATHENA_CROP), str(ATHENA_CROP), str(ATHENA_CROP),
    "--lr_policy", "constant", "--precision", "bfloat16", "--remat", "--save_by_iter",
    "--save_latest_freq", "50", "--print_freq", "25", "--display_freq", "1000000",
    "--seed", "0", "--watchdog_secs", "300"]
# The trained Athena step judged by judge_step's rule, with per-tensor limits
# against the plain bf16 step set from this phase's first reading on an H100
# at seed 0 (largest G_A 0.0274, G_B 0.0177, D 0.00285: each discriminator
# gradient averages 128 slices), at about three times those
ATHENA_DIRECT = {"G_A": 0.08, "G_B": 0.05, "D": 0.01}
# The model's losses restated from make_athena_step's formulas (the smoke's
# own slicing and sums) against the model's: the same kernels on the same
# tensors, so equal but for the order of a few f32 adds
ATHENA_TERMS_REL = 1e-5
# Dryops: Apollo's production flags for the model that has no G_B (no
# --netG_B), 108^3 crops, random Kaiming weights, --randomize_projection_depth,
# bf16, on the train phase's 160^3 volume; one warm-up and three timed steps.
DRYOPS_ITERS = 4
DRYOPS_ARGS = [a for a in TRAIN_ARGS if a not in ("--netG_B", "deep_linear_gen", "--add_date")]
DRYOPS_ARGS[DRYOPS_ARGS.index("axial_to_lateral_gan_apollo")] = "axial_to_lateral_gan_dryops"
# Epoch: the epoch trainer (python -m neuroclear_tpu_torch.train) with the
# cube dataset over three synthetic 160^3 TIFFs, Apollo's production flags
# with --precision bfloat16, one epoch, the host chain on a prefetching thread
EPOCH_VOLUMES = 3
EPOCH_ARGS = [*[a for a in TRAIN_ARGS if a != "--add_date"], "--dataset_mode", "cube",
              "--n_epochs", "1", "--n_epochs_decay", "0", "--save_epoch_freq", "1",
              "--num_threads", "2", "--print_freq", "1"]
# The host chain's rotation (data/warp.py, cv2's warp without cv2) against
# scipy's float64 bilinear map of the same geometry, on uint16 slices: the
# twin rounds each voxel once, from float32 coordinates (a few 1e-5 px off
# float64); a 1/32-pixel shift moves voxels by the field's gradient over 32
# (here ~100 LSB)
HOST_ROT_ANGLES = (23, 137, 251)
HOST_ROT_MAX_LSB, HOST_ROT_MEAN_LSB = 1.0, 0.3
# Trained G_A through the tile pipeline (the JAX study's Apollo G_A,
# iteration 11000), bf16 with the kernels, on the slice's volume: bounds set
# from this phase's first reading on an H100 at seed 0 (kernels against the
# plain bf16 path max 512, mean 5.86 LSB; both ~25.7 LSB mean from f32), in
# place of the random-weight SLICE_KP_* (2048, 128): two bf16 steps more for
# the worst voxel, twice the mean
TRAINED_G_A = os.path.join(STUDY_STATE, f"iter_{STUDY_LOAD_ITER}_net_G_A.npz")
TRAINED_KP_MAX_LSB, TRAINED_KP_MEAN_LSB = 4 * 256, 12.0

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


def device_operations(fn) -> list:
    """The device rows (name, ms, count) of one call of a warm ``fn`` under
    torch.profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return _device_rows(prof)


def one_device_operation(fn, label: str) -> None:
    """One call of a warm wrapper under torch.profiler runs exactly one
    device operation: the statistics, the cross-block step and the
    coefficients are one launch, with no PyTorch operation around it."""
    rows = device_operations(fn)
    ops = sum(r[2] for r in rows)
    log(f"  {label}: {ops} device operation(s) per call: "
        + ", ".join(f"{k[:60]} x{c}" for k, _, c in rows))
    if ops != 1:
        raise AssertionError(f"{label}: {ops} device operations per call, expected 1")


def check_norm(gen, dev, timed=True, shapes=NORM_SHAPES, dtype=torch.bfloat16,
               label="tile batch") -> tuple[dict, dict]:
    """pair_sums and affine_map_act kernels vs their plain versions at the
    path's three norm shapes (``timed=False``: the checks alone): bf16 at
    the fused path's, f32 at the per-cube loop's (LEGACY_NORM_SHAPES)."""
    sums, amap = _tot(), _tot(library=False)
    glue = 0.0
    for shape, mult in shapes:
        n, r, c = shape
        x3 = (torch.randn(shape, generator=gen, device=dev) * 2.0 + 0.5).to(dtype)
        xd = x3.double()
        ref = torch.stack([xd.sum(1), (xd * xd).sum(1)], 1)
        mag = torch.stack([xd.abs().sum(1), (xd * xd).sum(1)], 1)
        del xd
        s, sc, sh = check_stats(inorm.pair_sums, (x3,), ref, mag,
                                lambda t: inorm.norm_coefficients(t, r), f"pair_sums {shape}")
        # f32 sums against f64: 1e-5 of the sum of magnitudes
        sp = inorm.pair_sums_plain(x3)[0]
        if not bool(((sp.double() - ref).abs() <= 1e-5 * mag).all()):
            raise AssertionError(f"pair_sums plain {shape} off the f64 sums")
        err_s = (s - sp).abs().max().item()
        y = inorm.affine_map_act(x3, sc, sh, "relu")
        yp = inorm.affine_map_act_plain(x3, sc, sh, "relu")
        # one rounding of the same f32 product and sum: one step of the dtype
        if not (within_bf16_ulp(y, yp) if dtype == torch.bfloat16 else within_f32_ulp(y, yp, 1)):
            raise AssertionError(f"affine_map_act {shape} {dtype}: more than one step off")
        err_m = (y.float() - yp.float()).abs().max().item()
        del ref, mag, sp, y, yp
        if timed:
            ms_s = cuda_ms(lambda: inorm.pair_sums(x3), 10)
            pl_s = cuda_ms(lambda: inorm.pair_sums_plain(x3), 3)
            lib_s = cuda_ms(lambda: torch.var_mean(x3, dim=1, correction=0), 10)
            gl = cuda_ms(lambda: inorm.norm_coefficients(s, r), 10)
            ms_m = cuda_ms(lambda: inorm.affine_map_act(x3, sc, sh, "relu"), 10)
            pl_m = cuda_ms(lambda: inorm.affine_map_act_plain(x3, sc, sh, "relu"), 3)
            elems, size = n * r * c, x3.element_size()
            tb_s, to_s = bound_ms(elems * size + 4 * n * c * 4, 3.0 * elems, PEAK_F32_FLOPS)
            tb_m, to_m = bound_ms(2 * elems * size + 2 * n * c * 4, 3.0 * elems, PEAK_F32_FLOPS)
            log(f"  pair_sums {shape} {dtype}: max_abs_err {err_s:.4g} (kernel vs plain f32 "
                f"sums)  kernel {ms_s:.4f} ms (with the coefficients)  plain {pl_s:.4f} ms  "
                f"var_mean {lib_s:.4f} ms  glue it replaces (norm_coefficients) {gl:.4f} ms  "
                f"bound {max(tb_s, to_s):.4f} ms  plan {inorm.stats_plan(n, r, c, size)}")
            log(f"  affine_map_act {shape} {dtype}: max_abs_err {err_m:.4g}  kernel {ms_m:.4f} "
                f"ms  plain {pl_m:.4f} ms  bound {max(tb_m, to_m):.4f} ms")
            _add(sums, mult, err_s, ms=ms_s, plain_ms=pl_s, library_ms=lib_s, tb=tb_s, to=to_s)
            _add(amap, mult, err_m, ms=ms_m, plain_ms=pl_m, tb=tb_m, to=to_m)
            glue += mult * gl
        del x3, s, sc, sh
        torch.cuda.empty_cache()
    if timed:
        log(f"  pair_sums per {label}: kernel {sums['ms']:.4f} ms, the glue it replaces "
            f"{glue:.4f} ms; affine_map_act {amap['ms']:.4f} ms")
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
    flat = init_flat(UNetDeconv(1, 1), seed=seed)
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
    flat = init_flat(UNetDeconv(1, 1), seed=seed)
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


def legacy_inputs(seed: int, tmp: str, size: int) -> tuple:
    """The synthetic volume of ``size`` as .npy and the slice's Kaiming
    checkpoint under ``tmp``: (the per-cube CLI's argv without
    --results_dir, the weights, the volume, the folder)."""
    vol = synthetic_volume(seed, size)
    root = os.path.join(tmp, f"legacy{size}")
    os.makedirs(os.path.join(root, "data"))
    np.save(os.path.join(root, "data", "volume.npy"), vol)
    flat = init_flat(UNetDeconv(1, 1), seed=seed)
    os.makedirs(os.path.join(root, "ckpt", "smoke"))
    np.savez(os.path.join(root, "ckpt", "smoke", "iter_1_net_G_A.npz"), **flat)
    argv = ["--dataroot", os.path.join(root, "data"), "--name", "smoke", "--checkpoints_dir",
            os.path.join(root, "ckpt"), "--load_iter", "1", "--model_suffix", "_A",
            *LEGACY_ARGS]
    return argv, flat, vol, root


def legacy_grid(vol: np.ndarray) -> DiceGrid:
    return DiceGrid(pad_for_dicing(vol, 120, 15).shape, 120, 15, 10)


def pipeline_launches(batches: int) -> dict:
    """The kernels of the fused tile pipeline in bf16: two W-pair convs and
    ten norms per generator application."""
    expected = {name: 0 for name in kernel_ops.KERNELS}
    expected.update({"wconv3x3x3": 2 * batches, "pair_sums": 10 * batches,
                     "affine_map_act": 10 * batches})
    return expected


def per_cube_launches(n_applications: int) -> dict:
    """The kernels of the per-cube loop: one statistics and one map launch
    per norm, ten norms per generator application; no W-pair conv (f32)."""
    expected = {name: 0 for name in kernel_ops.KERNELS}
    expected.update({"pair_sums": 10 * n_applications, "affine_map_act": 10 * n_applications})
    return expected


def run_per_cube(argv: list, results: str, expected: dict) -> tuple[dict, dict]:
    """test_dice.main with the per-cube loop, its launches counted from 0
    and required equal to ``expected``: (its result, the launches)."""
    kernel_ops.reset_launches()
    res = test_dice.main([*argv, "--results_dir", results])
    launches = kernel_ops.launches()
    log(f"  launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    out = res["fake"]
    if out.dtype != np.uint16 or out.std() == 0 or not np.isfinite(out).all():
        raise AssertionError(f"output {out.shape} {out.dtype} std {out.std()}")
    return res, launches


def per_cube_plain(argv: list, flat: dict, dev) -> np.ndarray:
    """The same per-cube loop (``test_dice.run_legacy``) with the model's
    generator on the plain versions, the same weights; no kernel may
    launch."""
    opt = test_dice.parse_options(argv)
    dataset = find_dataset_using_name(opt.dataset_mode)(opt)
    model = test_dice.TestModel(opt, dev)
    model.netG = define_G(1, 1, 64, "unet_deconv", plain=True)
    model.netG.load_state_dict(params_from_numpy(flat, model.netG))
    model.netG.to(dev).eval()
    before = kernel_ops.launches()
    out = test_dice.run_legacy(opt, model, dataset)["fake"]
    if kernel_ops.launches() != before:
        raise AssertionError("the plain per-cube loop launched a kernel")
    return out


def check_lsb(label: str, out: np.ndarray, ref: np.ndarray, max_lsb: float,
              mean_lsb: float) -> dict:
    if out.shape != ref.shape:
        raise AssertionError(f"{label}: shape {out.shape} against {ref.shape}")
    err = lsb_stats(out, ref)
    err["equal"] = bool(np.array_equal(out, ref))
    log(f"  {label}: {err} (bounds: max {max_lsb}, mean {mean_lsb})")
    if err["max_lsb"] > max_lsb or err["mean_lsb"] > mean_lsb:
        raise AssertionError(f"{label}: {err} over max {max_lsb} / mean {mean_lsb} LSB")
    return err


def check_galleries(web_dir: str, shape: tuple, with_input: bool) -> int:
    """Both pages written; every thumbnail a PNG whose IHDR is 8-bit
    grayscale of its source's size: an xy slice or MIP (X wide, Y high), an
    xz MIP (X, Z), a yz MIP (Y, Z).  Returns the number of thumbnails."""
    z, y, x = shape
    for page in ("index.html", "index_wholeimg.html"):
        if not os.path.isfile(os.path.join(web_dir, page)):
            raise AssertionError(f"gallery {page} not written")
    sizes = {"xy": (x, y), "xz": (x, z), "yz": (y, z)}
    found = 0
    for root, _, files in os.walk(os.path.join(web_dir, "images")):
        for f in files:
            if not f.endswith(".png"):
                continue
            plane = os.path.basename(root).split("_")[1]
            header = png.read_header(os.path.join(root, f))
            if header != (*sizes[plane], 8, 0):
                raise AssertionError(f"{f}: IHDR {header}, expected {(*sizes[plane], 8, 0)}")
            found += 1
    expected = len(range(0, z, max(1, z // 16))) * (1 + with_input) + 3 * (1 + with_input)
    if found != expected:
        raise AssertionError(f"{found} thumbnails, expected {expected}")
    return found


def run_legacy(seed: int, dev, tmp: str) -> dict:
    """The per-cube loop (--legacy_pipeline) on the slice's volume, weights
    and flags: its launches, its output against the same loop on the plain
    versions and against the fused path in f32, its galleries; then flip-TTA
    with histogram matching on a smaller volume against the plain versions;
    then the non-streaming entry point (``run``) against ``run_streaming``."""
    argv, flat, vol, root = legacy_inputs(seed, tmp, VOLUME)
    grid = legacy_grid(vol)
    t0 = time.perf_counter()
    res, launches = run_per_cube(argv, os.path.join(root, "results"),
                                 per_cube_launches(len(grid)))
    wall = time.perf_counter() - t0
    log(f"  per-cube loop: {len(grid)} cubes of {grid.roi_size + 20}^3 (f32, batch 1): "
        f"inference and assembly {res['seconds']:.3f} s = {len(grid) / res['seconds']:.3f} "
        f"cubes/s = {res['voxels'] / res['seconds']:.4g} voxel/s; the CLI {wall:.3f} s with "
        f"its galleries and volumes; {nvidia_smi()}")
    n_png = check_galleries(res["web_dir"], vol.shape, with_input=True)
    t0 = time.perf_counter()
    plain = per_cube_plain(argv, flat, dev)
    plain_s = time.perf_counter() - t0
    kp = check_lsb("per-cube loop, kernels against the plain versions (f32)", res["fake"],
                   plain, LEGACY_MAX_LSB, LEGACY_MEAN_LSB)
    fused_argv = [a for a in argv if a != "--legacy_pipeline"] + ["--precision", "float32"]
    fused = test_dice.main([*fused_argv, "--results_dir", os.path.join(root, "fused")])
    fu = check_lsb("per-cube loop against the fused path in f32 (kernels)", res["fake"],
                   fused["fake"], LEGACY_MAX_LSB, LEGACY_MEAN_LSB)
    log(f"  the plain per-cube loop {plain_s:.3f} s (with assembly); the fused path in f32 "
        f"{fused['seconds']:.3f} s; {n_png} thumbnails checked")

    # flip-TTA with histogram matching
    t_argv, t_flat, t_vol, t_root = legacy_inputs(seed + 6, tmp, TTA_VOLUME)
    t_argv += TTA_ARGS
    t_grid = legacy_grid(t_vol)
    t_res, t_launches = run_per_cube(t_argv, os.path.join(t_root, "results"),
                                     per_cube_launches(4 * len(t_grid)))
    t_plain = per_cube_plain(t_argv, t_flat, dev)
    d = np.abs(t_res["fake"].astype(np.int64) - t_plain)
    tta = {**lsb_stats(t_res["fake"], t_plain), "frac_over": float((d > LEGACY_MAX_LSB).mean()),
           "frac_differ": float((d > 0).mean())}
    log(f"  flip-TTA + histogram match, {len(t_grid)} cubes x 4 on {TTA_VOLUME}^3 in "
        f"{t_res['seconds']:.3f} s: kernels against the plain versions {tta} (bounds: mean "
        f"{TTA_MEAN_LSB}, share over {LEGACY_MAX_LSB} LSB {TTA_FRAC_OVER})")
    if tta["mean_lsb"] > TTA_MEAN_LSB or tta["frac_over"] > TTA_FRAC_OVER:
        raise AssertionError(f"flip-TTA + histogram match off the plain versions: {tta}")
    check_galleries(t_res["web_dir"], t_vol.shape, with_input=True)

    # the non-streaming entry point, bf16, against run_streaming
    net = UNetDeconv(1, 1)
    net.load_state_dict(params_from_numpy(flat, net))
    net.to(dev).eval()
    vp = pad_for_dicing(vol, grid.roi_size, grid.overlap)
    pipe = DiceInferencePipeline(net, grid, dtype_inv_scale(vp.dtype), tile_batch=2,
                                 precision="bfloat16", out_dtype=np.uint16,
                                 orig_shape=vol.shape, device=dev)
    # run is run_streaming: tile batches of 2 within each z-slab
    batches = grid.z_steps * -(-(grid.y_steps * grid.x_steps) // 2)
    expected = pipeline_launches(batches)
    kernel_ops.reset_launches()
    t0 = time.perf_counter()
    out = pipe.run(vp)
    run_s = time.perf_counter() - t0
    r_launches = kernel_ops.launches()
    log(f"  run: {len(grid)} tiles in {batches} batches, {run_s:.3f} s; launches "
        f"{r_launches}, expected {expected}")
    if r_launches != expected:
        raise AssertionError(f"launch counts {r_launches} != {expected}")
    t0 = time.perf_counter()
    stream = pipe.run_streaming(vp)
    stream_s = time.perf_counter() - t0
    rs = {**lsb_stats(out, stream), "run_s": run_s, "stream_s": stream_s}
    log(f"  run against run_streaming (bf16; run_streaming {stream_s:.3f} s): {rs}")
    if out.shape != vol.shape or not np.array_equal(out, stream):
        raise AssertionError(f"run differs from run_streaming: {rs}")
    return {"launches": launches, "tta_launches": t_launches, "run_launches": r_launches,
            "seconds": res["seconds"], "cubes": len(grid), "kp": kp, "fused": fu, "tta": tta,
            "run": rs}


def _grads_by_name(model, g_grads, d_grads) -> dict:
    """{NET.param: f32 gradient} in the order of the model's parameters."""
    names = [f"{n}.{pn}" for n in model.model_names for pn, _ in model.nets[n].named_parameters()]
    return {k: g.detach().float() for k, g in zip(names, list(g_grads) + list(d_grads))}


def _is_pre_norm_bias(key: str) -> bool:
    parts = key.split(".")
    return parts[-1] == "bias" and any(q.startswith(PRE_NORM) for q in parts[1:-1])


def _rel_l2(a: dict, b: dict, keys) -> float:
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in keys)
    return math.sqrt(num / sum(float((b[k] ** 2).sum()) for k in keys))


def model_three_ways(make, inputs, step=None, on_kernels=None) -> dict:
    """One step's losses and gradients three ways, from identical weights,
    crop and draws: {label: (losses, gradients)} for the kernels in bf16
    and the plain versions in bf16 and in f32.  ``make(plain, precision)``
    builds the model; ``inputs(model)`` -> its arguments, taken once;
    ``step(model, *inputs)`` -> (losses, ..., g_grads, d_grads)
    (``model.gradients`` by default); ``on_kernels(model, *inputs)`` runs on
    the kernel way's model before it is dropped."""
    runs, taken = {}, None
    for label, plain, precision in (("kernels bf16", False, "bfloat16"),
                                    ("plain bf16", True, "bfloat16"),
                                    ("plain f32", True, "float32")):
        model = make(plain, precision)
        if taken is None:
            taken = inputs(model)
        before = kernel_ops.launches()
        losses, *_, g_grads, d_grads = (step or type(model).gradients)(model, *taken)
        torch.cuda.synchronize()
        if plain and kernel_ops.launches() != before:
            raise AssertionError(f"the {label} step launched a kernel")
        runs[label] = ({k: float(v) for k, v in losses.items()},
                       _grads_by_name(model, g_grads, d_grads))
        del g_grads, d_grads
        if not plain and on_kernels:
            on_kernels(model, *taken)
        del model
        torch.cuda.empty_cache()
    return runs


def step_three_ways(seed: int, vol: np.ndarray, dev) -> dict:
    """One production step from identical weights, crop and draws, three
    ways (``model_three_ways``)."""
    opt = train_options.build_parser().parse_args(["--dataroot", "unused", *PRODUCTION_ARGS])
    dataset = SingleVolumeDataset(vol, (CROP,) * 3, opt.preprocess, dev)
    gen = torch.Generator().manual_seed(seed + 1)
    real = dataset.sample(gen)

    def make(plain, precision):
        opt.precision = precision
        model = ApolloModel(opt, dev, plain=plain)
        model.init_weights(seed)
        return model

    return model_three_ways(make, lambda model: (real, model.draw_probes((CROP,) * 3, gen)))


def judge_step(runs: dict, direct_limits: dict = STEP_DIRECT, loss_names=LOSS_NAMES,
               d_names=D_NAMES) -> tuple[list, dict]:
    """(failures, stats) of the kernel step against the plain steps, each
    gradient tensor against the plain bf16 step's within ``direct_limits``
    (per net group: G_A, G_B where the model has it, and the
    discriminators ``d_names``)."""
    (lk, gk), (lp, gp), (lf, gf) = runs["kernels bf16"], runs["plain bf16"], runs["plain f32"]
    bad, stats = [], {"pooled": {}, "direct": {}}
    for name in loss_names:
        ek, ep = abs(lk[name] - lf[name]), abs(lp[name] - lf[name])
        if not ek <= STEP_LOSS_RATIO * ep + STEP_LOSS_REL * abs(lf[name]):  # NaN fails
            bad.append(f"loss {name}: {ek:.4g} vs plain {ep:.4g}")
    keys = [k for k in gf if not _is_pre_norm_bias(k)]
    for group, nets in (("G_A", ["G_A"]), ("G_B", ["G_B"]), ("D", d_names)):
        ks = [k for k in keys if k.split(".")[0] in nets]
        if not ks:
            continue
        ek, ep = _rel_l2(gk, gf, ks), _rel_l2(gp, gf, ks)
        stats["pooled"][group] = (ek, ep)
        if not ek <= STEP_GRAD_RATIO * ep + STEP_GRAD_ABS:
            bad.append(f"gradients {group}: {ek:.4g} vs plain {ep:.4g}")
        # the kernel step against the plain bf16 step, tensor by tensor
        direct = sorted(((_rel_l2(gk, gp, [k]), k) for k in ks), reverse=True)
        stats["direct"][group] = direct[:3]
        for d, k in direct:
            if not d <= direct_limits[group]:
                bad.append(f"gradient {k}: {d:.4g} off the plain bf16 step "
                           f"(limit {direct_limits[group]})")
    for k in keys:
        ek, ep = _rel_l2(gk, gf, [k]), _rel_l2(gp, gf, [k])
        if not ek <= STEP_TENSOR_RATIO * ep + STEP_TENSOR_ABS:
            bad.append(f"gradient {k}: {ek:.4g} vs plain {ep:.4g}")
    return bad, stats


def report_three_ways(label: str, runs: dict, direct: dict, loss_names, d_names,
                      random_pooled=None) -> dict:
    """``judge_step`` on ``runs``, logged; raises on a failure.  Returns the
    pooled errors."""
    bad, stats = judge_step(runs, direct, loss_names, d_names)
    log(f"  {label}, relative error against the plain f32 step (kernels bf16 / plain bf16)"
        + (", beside the train phase's at random weights" if random_pooled else "") + ": "
        + "; ".join(f"{g} {ek:.4g} / {ep:.4g}"
                    + (f" (random {random_pooled[g][0]:.4g} / {random_pooled[g][1]:.4g})"
                       if random_pooled and g in random_pooled else "")
                    for g, (ek, ep) in stats["pooled"].items()))
    (lk, _), (lp, _), (lf, _) = runs["kernels bf16"], runs["plain bf16"], runs["plain f32"]
    log("  losses (f32 | kernels bf16 | plain bf16): " + "; ".join(
        f"{n} {lf[n]:.5g} | {lk[n]:.5g} | {lp[n]:.5g}" for n in loss_names))
    log("  kernel step against the plain bf16 step, largest relative L2 per tensor: " + "; ".join(
        f"{g} " + ", ".join(f"{d:.4g} ({k})" for d, k in top)
        for g, top in stats["direct"].items()))
    if bad:
        raise AssertionError(f"{label}: kernel step off the plain steps: " + "; ".join(bad))
    return stats["pooled"]


def check_step_three_ways(seed: int, vol: np.ndarray, dev) -> dict:
    """The kernel step's losses and gradients against the f32 plain step, no
    worse than the plain bf16 step's, and against the plain bf16 step."""
    return report_three_ways(f"step at {CROP}^3", step_three_ways(seed, vol, dev), STEP_DIRECT,
                             LOSS_NAMES, D_NAMES)


def rotated_reference(vol: np.ndarray, angle: float, offsets, flips) -> np.ndarray:
    """The rotated crop in float64, independently of the sampler: the
    source coordinates of each output voxel from the port's host geometry
    (``ops/rotation.py``), then ``scipy.ndimage.map_coordinates`` (order 1,
    mode "nearest") over each slice of the slab, then the flips.  The JAX
    chain clips each tap's index to the slice; above n - 1 that is "nearest",
    below 0 it samples at the coordinate's fractional part, which the
    reference maps the same way."""
    from scipy import ndimage

    z_n, y_n, x_n = vol.shape
    g = rotation.rotation_geometry(x_n, y_n, angle)
    i00, i01, i02, i10, i11, i12 = (float(c) for c in g.inv)
    z0, y0, x0 = offsets
    py = (g.y1 + y0 + np.arange(CROP, dtype=np.float64))[:, None]
    px = (g.x1 + x0 + np.arange(CROP, dtype=np.float64))[None, :]
    coords = [i10 * px + i11 * py + i12, i00 * px + i01 * py + i02]  # (y, x)
    coords = [np.where(c < 0, c - np.floor(c), c) for c in coords]
    slab = vol[z0:z0 + CROP].astype(np.float64) * dtype_inv_scale(vol.dtype)
    ref = np.stack([ndimage.map_coordinates(sl, coords, order=1, mode="nearest")
                    for sl in slab])
    return np.flip(ref, [d for d, f in enumerate(flips) if f]).copy()


def check_rotation(vol: np.ndarray, dev, seed: int) -> dict:
    """The production sampler on the card: rotated crops at ``ROT_ANGLES``
    (offsets and flips drawn from the seed) against ``rotated_reference``
    within ``ROT_ATOL``; then, with ``torch.cuda.set_sync_debug_mode
    ("error")``, three samples (draws and crop, as the trainer takes them),
    which fails on any device-to-host sync; and the sampler's device time
    and operations, with rotation and without."""
    preprocess = PRODUCTION_ARGS[PRODUCTION_ARGS.index("--preprocess") + 1]
    dataset = SingleVolumeDataset(vol, (CROP,) * 3, preprocess, dev)
    gen = torch.Generator().manual_seed(seed + 3)
    worst = 0.0
    for angle in ROT_ANGLES:
        offsets, flips = crop_draws(vol.shape, (CROP,) * 3, gen, angle)
        got = dataset.crop(angle, offsets, flips)[0, ..., 0].double().cpu().numpy()
        err = float(np.abs(got - rotated_reference(vol, angle, offsets, flips)).max())
        log(f"  rotated crop {angle:g} deg, offsets {offsets}, flips {flips}: max_abs_err "
            f"{err:.3g} against float64 map_coordinates")
        if not err <= ROT_ATOL:  # NaN fails
            raise AssertionError(f"rotated crop at {angle} deg off the float64 reference by "
                                 f"{err} (limit {ROT_ATOL})")
        worst = max(worst, err)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            dataset.sample(gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log("  three samples with set_sync_debug_mode('error'): no device-to-host sync")
    flat = SingleVolumeDataset(vol, (CROP,) * 3, NO_ROTATION[1], dev)
    out = {"max_abs_err": worst}
    for label, ds in (("rotated", dataset), ("not rotated", flat)):
        ms = cuda_ms(lambda: ds.sample(gen), 20)
        ops = sum(r[2] for r in device_operations(lambda: ds.sample(gen)))
        log(f"  sampler ({label}): {ms:.4f} ms of device time, {ops} device operations per "
            "crop")
        out[label] = {"ms": ms, "ops": ops}
    return out


def _median_ms(seconds) -> float:
    timed = sorted(seconds[1:])  # the first step is the warm-up
    return 1e3 * timed[len(timed) // 2]


def run_train(seed: int, dev, tmp: str) -> dict:
    """The trainer with the production command on a TIFF, its launch
    counts, the step median with and without rotation, the rotation check,
    the three-way step check and its checkpoint through inference."""
    vol = synthetic_volume(seed, TRAIN_VOLUME)
    data = os.path.join(tmp, "train_data")
    tiffio.imwrite(os.path.join(data, "volume.tif"), vol)
    ckpt = os.path.join(tmp, "train_ckpt")
    argv = ["--dataroot", data, "--name", "smoke", "--checkpoints_dir", ckpt, *TRAIN_ARGS,
            "--max_iters", str(TRAIN_ITERS), "--seed", str(seed)]
    kernel_ops.reset_launches()
    res = train_onecube.main(argv)
    launches = kernel_ops.launches()
    expected = {k: TRAIN_ITERS * v for k, v in STEP_LAUNCHES.items()}
    log(f"  launches over {TRAIN_ITERS} steps {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    for step in res["losses"]:
        if not all(math.isfinite(v) for v in step.values()):
            raise AssertionError(f"a loss is not finite: {step}")
    step_ms = _median_ms(res["step_seconds"])
    flat = train_onecube.main([*argv, *NO_ROTATION, "--name", "smoke_no_rotation"])
    flat_ms = _median_ms(flat["step_seconds"])
    log(f"  step ms: first {1e3 * res['step_seconds'][0]:.1f}, then "
        + ", ".join(f"{1e3 * t:.1f}" for t in res["step_seconds"][1:])
        + f"; median {step_ms:.1f} ms ({CROP}^3, bf16, rotation); without rotation "
        + ", ".join(f"{1e3 * t:.1f}" for t in flat["step_seconds"][1:])
        + f"; median {flat_ms:.1f} ms")
    log("  last losses: " + ", ".join(f"{k} {v:.5g}" for k, v in res["losses"][-1].items()))
    del res["model"], flat

    # the production command as it is: f32 by default, as in JAX
    kernel_ops.reset_launches()
    f32 = train_onecube.main(["--dataroot", data, "--name", "smoke_f32", "--checkpoints_dir",
                              ckpt, *PRODUCTION_ARGS, "--max_iters", str(F32_ITERS), "--seed",
                              str(seed)])
    f32_launches = kernel_ops.launches()
    expected = {k: F32_ITERS * v for k, v in F32_STEP_LAUNCHES.items()}
    log(f"  the production command as it is (f32): {F32_ITERS} steps, "
        + ", ".join(f"{1e3 * t:.1f}" for t in f32["step_seconds"])
        + f" ms; launches {f32_launches}, expected {expected}")
    if f32_launches != expected:
        raise AssertionError(f"f32 launch counts {f32_launches} != {expected}")
    if f32["model"].visuals["fake"].dtype != torch.float32 or not all(
            math.isfinite(v) for step in f32["losses"] for v in step.values()):
        raise AssertionError("the f32 production steps are not f32 or not finite")
    del f32

    rot = check_rotation(vol, dev, seed)
    pooled = check_step_three_ways(seed, vol, dev)

    small = os.path.join(tmp, "infer_data")
    os.makedirs(small)
    np.save(os.path.join(small, "volume.npy"), synthetic_volume(seed + 2, 72))
    name = os.path.basename(os.path.dirname(res["checkpoints"][0]))
    out = test_dice.main(["--dataroot", small, "--name", name, "--checkpoints_dir", ckpt,
                          "--load_iter", str(TRAIN_ITERS), "--model_suffix", "_A",
                          "--dice_size", "48", "48", "48", "--overlap", "8", "--border_cut",
                          "4", "--precision", "bfloat16", "--results_dir",
                          os.path.join(tmp, "train_out")])
    vol_out = out["fake"]
    if vol_out.shape != (72, 72, 72) or vol_out.dtype != np.uint16 or vol_out.std() == 0:
        raise AssertionError(f"trained G_A output {vol_out.shape} {vol_out.dtype} "
                             f"std {vol_out.std()}")
    return {"launches": launches, "f32_launches": f32_launches, "step_ms": step_ms,
            "flat_ms": flat_ms, "rotation": rot, "losses": res["losses"][-1], "pooled": pooled}


def _model_state_diffs(a, b) -> list:
    """Where two models' parameters, Adam state or schedule positions
    differ (bitwise)."""
    bad = []
    for name in a.model_names:
        for (pn, p), q in zip(a.nets[name].named_parameters(), b.nets[name].parameters()):
            if not torch.equal(p, q):
                bad.append(f"{name}.{pn}")
    for label, oa, ob in (("G", a.optim_g, b.optim_g), ("D", a.optim_d, b.optim_d)):
        for i, (p, q) in enumerate(zip(oa.param_groups[0]["params"], ob.param_groups[0]["params"])):
            sa, sb = oa.state.get(p), ob.state.get(q)
            if sa is None or sb is None or float(sa["step"]) != float(sb["step"]) or not (
                    torch.equal(sa["exp_avg"], sb["exp_avg"])
                    and torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])):
                bad.append(f"Adam {label} state {i}")
    if [c.state() for c in a.lr_controllers] != [c.state() for c in b.lr_controllers]:
        bad.append(f"schedule {[c.state() for c in a.lr_controllers]} vs "
                   f"{[c.state() for c in b.lr_controllers]}")
    return bad


def _params(model) -> list:
    return [p.detach().double() for n in G_NAMES + D_NAMES for p in model.nets[n].parameters()]


def run_resume(seed: int, dev, tmp: str) -> dict:
    """Three production steps with a moving schedule, then the resume from
    iter_3: the reloaded state against the first run's in memory, the next
    step from both against two runs of it from one state, and the resumed
    trainer's own two steps."""
    vol = synthetic_volume(seed + 4, TRAIN_VOLUME)
    data = os.path.join(tmp, "data")
    tiffio.imwrite(os.path.join(data, "volume.tif"), vol)
    argv = ["--dataroot", data, "--name", "resume", "--checkpoints_dir",
            os.path.join(tmp, "ckpt"), *TRAIN_ARGS, *RESUME_ARGS, "--seed", str(seed)]
    first = train_onecube.main([*argv, "--max_iters", "3"])
    a = first["model"]
    name = os.path.basename(os.path.dirname(first["checkpoints"][0]))
    resume_argv = [*argv, "--name", name, "--continue_train", "--load_iter", "3"]
    _, dataset, b = train_onecube.setup(train_options.parse(resume_argv))
    bad = _model_state_diffs(a, b)
    log(f"  reloaded iter_3 of {name}: parameters, Adam state and schedule "
        f"{[c.state() for c in b.lr_controllers]} (scale {b.lr_scale:.4g}) "
        + ("equal to the first run's in memory" if not bad else f"DIFFER: {bad[:6]}"))
    if bad:
        raise AssertionError(f"the resumed state differs from the saved one: {bad[:6]}")

    # the next step from the saved state: in memory, a copy of it, resumed
    again = copy.deepcopy(a)
    before = _params(a)
    gen = torch.Generator().manual_seed(seed + 5)
    real, draws = dataset.sample(gen), b.draw_probes((CROP,) * 3, gen)
    for model in (a, again, b):
        model.optimize_parameters(real, draws)
    after = {k: _params(m) for k, m in (("a", a), ("again", again), ("b", b))}
    size = math.sqrt(sum(float(((p - q) ** 2).sum()) for p, q in zip(after["a"], before)))

    def rel(x):
        return math.sqrt(sum(float(((p - q) ** 2).sum())
                             for p, q in zip(after[x], after["a"]))) / size

    rerun, resumed = rel("again"), rel("b")
    log(f"  next step, relative L2 of the parameter updates: resumed vs in memory "
        f"{resumed:.3g}, two runs from the in-memory state {rerun:.3g}")
    if not (resumed <= 2 * rerun if rerun > 0 else resumed == 0):
        raise AssertionError(f"the resumed step differs from the in-memory one by {resumed}, "
                             f"two runs from one state by {rerun}")
    del a, again, b, first, after, before
    torch.cuda.empty_cache()

    kernel_ops.reset_launches()
    second = train_onecube.main([*resume_argv, "--max_iters", "2"])
    launches = kernel_ops.launches()
    expected = {k: 2 * v for k, v in STEP_LAUNCHES.items()}
    log(f"  resumed trainer: launches over 2 steps {launches}, expected {expected}; wrote "
        + ", ".join(sorted({os.path.basename(p) for p in second['checkpoints']})))
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    suffixes = {os.path.basename(p).split("_net_")[0].split("_optim")[0]
                for p in second["checkpoints"]}
    if suffixes != {"iter_6"}:  # resumes at 3 + 1 and runs iterations 5 and 6
        raise AssertionError(f"the resumed run wrote {sorted(suffixes)}, expected iter_6")
    if not all(math.isfinite(v) for step in second["losses"] for v in step.values()):
        raise AssertionError(f"a resumed loss is not finite: {second['losses']}")
    return {"launches": launches, "rerun": rerun, "resumed": resumed}


def study_flats() -> dict:
    """{NAME: JAX flat dict} of the six nets the JAX study trained."""
    return {n: load_npz(os.path.join(STUDY_STATE, f"iter_{STUDY_LOAD_ITER}_net_{n}.npz"))
            for n in MODEL_NAMES}


def study_model(flats: dict, dev, plain: bool = False, **overrides) -> ApolloModel:
    """The study's Apollo model (its flags, ``overrides`` applied) holding
    the trained nets, with a fresh Adam."""
    opt = train_options.build_parser().parse_args(["--dataroot", "unused", *STUDY_ARGS])
    for k, v in overrides.items():
        setattr(opt, k, v)
    model = ApolloModel(opt, dev, plain=plain)
    model.load_flats(flats)
    return model


def study_inputs(vol: np.ndarray, dev, seed: int, n: int, model: ApolloModel):
    """(crop(i), draws): n crops' geometry drawn first, then one step's
    probe draws, as the trainer draws them; each crop cut when asked for."""
    preprocess = STUDY_ARGS[STUDY_ARGS.index("--preprocess") + 1]
    dataset = SingleVolumeDataset(vol, (STUDY_CROP,) * 3, preprocess, dev)
    gen = torch.Generator().manual_seed(seed)
    geometry = [dataset.draws(gen) for _ in range(n)]
    draws = model.draw_probes((STUDY_CROP,) * 3, gen)
    return (lambda i: dataset.crop(*geometry[i])), draws


def check_remat(flats: dict, vol: np.ndarray, dev, seed: int) -> dict:
    """One accum-8 step from the trained nets, the same crops and draws, with
    --remat and without (``check_peaks``)."""
    crop, draws = study_inputs(vol, dev, seed + 6, STUDY_ACCUM, study_model(flats, dev))
    log(f"  accum-{STUDY_ACCUM} step at {STUDY_CROP}^3 from the trained nets:")
    expected = {remat: {k: STUDY_ACCUM * v for k, v in table.items()} for remat, table in
                ((True, REMAT_STEP_LAUNCHES), (False, STEP_LAUNCHES))}
    return check_peaks(lambda remat: study_model(flats, dev, remat=remat),
                       lambda model: model.optimize_parameters_accum(crop, STUDY_ACCUM, draws),
                       dev, expected)


def check_accumulation(model: ApolloModel, crop, n: int, draws) -> float:
    """``model.accumulate`` against the mean of n per-crop ``gradients``
    calls, added and divided here: relative L2 over every gradient tensor
    at most ACCUM_REL_L2, and the losses the mean of the per-crop losses.
    Returns the relative L2."""
    losses, *_, g_acc, d_acc = model.accumulate(crop, n, draws)
    acc = _grads_by_name(model, g_acc, d_acc)
    del g_acc, d_acc
    total, per_loss = None, []
    for i in range(n):
        crop_losses, *_, gg, dg = model.gradients(crop(i), draws)
        grads = _grads_by_name(model, gg, dg)
        total = grads if total is None else {k: total[k] + grads[k] for k in total}
        per_loss.append(crop_losses)
        del gg, dg, grads
    mean = {k: v / n for k, v in total.items()}
    err = _rel_l2(acc, mean, list(mean))
    bad = [name for name in model.loss_names if not math.isclose(
        float(losses[name]), sum(float(l[name]) for l in per_loss) / n, rel_tol=1e-6)]
    log(f"  accumulated gradients of {n} crops against the mean of their own gradients: "
        f"relative L2 {err:.3g} (limit {ACCUM_REL_L2}); losses "
        + ("the mean of the crops'" if not bad else f"OFF the mean: {bad}"))
    if not err <= ACCUM_REL_L2 or bad:
        raise AssertionError(f"accumulation off the mean of the per-crop gradients: {err} {bad}")
    return err


def accum_step_three_ways(flats: dict, vol: np.ndarray, dev, seed: int) -> dict:
    """One accum-2 step at 148^3 from the trained nets, the same crops and
    draws, three ways (``model_three_ways``); the kernel way's accumulation
    checked by ``check_accumulation``.  Returns (runs, its error)."""
    err = []
    runs = model_three_ways(
        lambda plain, precision: study_model(flats, dev, plain=plain, precision=precision),
        lambda model: study_inputs(vol, dev, seed + 7, 2, model),
        step=lambda model, crop, draws: model.accumulate(crop, 2, draws),
        on_kernels=lambda model, crop, draws: err.append(check_accumulation(model, crop, 2,
                                                                              draws)))
    return runs, err[0]


def run_study(seed: int, dev, tmp: str, random_pooled: dict) -> dict:
    """The JAX study's ga8 command through ``train_onecube.main`` from the
    trained nets: launches exact (remat's recomputations counted), the step
    median; then ``check_remat`` and the three-way accum-2 step judged by
    ``judge_step``, printed beside the train phase's random-weight errors."""
    vol = synthetic_volume(seed, STUDY_VOLUME)
    data = os.path.join(tmp, "study_data")
    tiffio.imwrite(os.path.join(data, "volume.tif"), vol)
    ckpt = os.path.join(tmp, "study_ckpt")
    os.makedirs(os.path.join(ckpt, STUDY_NAME))
    for n in MODEL_NAMES:
        f = f"iter_{STUDY_LOAD_ITER}_net_{n}.npz"
        os.symlink(os.path.join(STUDY_STATE, f), os.path.join(ckpt, STUDY_NAME, f))
    argv = ["--dataroot", data, "--checkpoints_dir", ckpt, "--name", STUDY_NAME, *STUDY_ARGS,
            "--continue_train", "--load_iter", str(STUDY_LOAD_ITER),
            "--max_iters", str(STUDY_ITERS)]
    kernel_ops.reset_launches()
    res = train_onecube.main(argv)
    launches = kernel_ops.launches()
    expected = {k: STUDY_ITERS * STUDY_ACCUM * v for k, v in REMAT_STEP_LAUNCHES.items()}
    per_step = {k: v // STUDY_ITERS for k, v in launches.items()}
    log(f"  launches over {STUDY_ITERS} steps {launches} ({per_step} per step), expected "
        f"{expected}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    if res["total_iters"] != STUDY_LOAD_ITER + 1 + STUDY_ITERS or not all(
            math.isfinite(v) for step in res["losses"] for v in step.values()):
        raise AssertionError(f"the study run ended at {res['total_iters']} with losses "
                             f"{res['losses']}")
    step_ms = _median_ms(res["step_seconds"])
    log(f"  step ms (accum {STUDY_ACCUM}, {STUDY_CROP}^3, bf16, --remat): first "
        f"{1e3 * res['step_seconds'][0]:.1f}, then "
        + ", ".join(f"{1e3 * t:.1f}" for t in res["step_seconds"][1:])
        + f"; median {step_ms:.1f} ms")
    log("  last losses: " + ", ".join(f"{k} {v:.5g}" for k, v in res["losses"][-1].items()))
    del res
    torch.cuda.empty_cache()

    flats = study_flats()
    mem = check_remat(flats, vol, dev, seed)
    runs, acc_err = accum_step_three_ways(flats, vol, dev, seed)
    pooled = report_three_ways(f"accum-2 step at {STUDY_CROP}^3 from the trained nets", runs,
                               STUDY_DIRECT, LOSS_NAMES, D_NAMES, random_pooled)
    return {"launches": launches, "per_step": per_step, "step_ms": step_ms, **mem,
            "pooled": pooled, "accum_err": acc_err}


def athena_model(flats: dict, dev, plain: bool = False, **overrides):
    """The study's Athena model (its flags, ``overrides`` applied) holding
    ``flats`` ({NAME: JAX flat dict}), with a fresh Adam."""
    argv = ["--dataroot", "unused", *ATHENA_ARGS]
    opt = train_options.build_parser(argv).parse_args(argv)
    for k, v in overrides.items():
        setattr(opt, k, v)
    model = create_model(opt, dev, plain=plain)
    model.load_flats(flats)
    return model


def athena_flats() -> dict:
    return {n: load_npz(os.path.join(ATHENA_STATE, f"iter_{ATHENA_LOAD_ITER}_net_{n}.npz"))
            for n in ATHENA_MODEL_NAMES}


def _each_slice(vol: torch.Tensor, axis: int) -> torch.Tensor:
    """Every slice along ``axis`` as the batch, slice by slice (the smoke's
    own restatement of ``all_slices``)."""
    n = vol.shape[axis + 1]
    return torch.stack([vol.select(axis + 1, i) for i in range(n)], 1).flatten(0, 1)


def check_athena_terms(model, real: torch.Tensor) -> float:
    """The model's 15 losses against make_athena_step's formulas restated
    here (the discriminators on every slice of the axes the JAX step names,
    ``_each_slice``), on the same nets and crop; returns the largest
    relative difference (limit ATHENA_TERMS_REL)."""
    src, tgt = ATHENA_ARGS[ATHENA_ARGS.index("--conversion_plane") + 1:][:2]
    plane = {"xy": 0, "xz": 1, "yz": 2}  # the slice axis of each plane, restated
    t, s_ = plane[tgt], plane[src]
    r = 3 - t - s_
    with torch.no_grad():
        real = real.to(model.device, model.cfg.compute_dtype)
        (_, g_terms, fake, rec) = model.g_loss(real)
        _, d_terms = model.d_loss(real, fake, rec)
        terms = {**g_terms, **d_terms}
        nets = model.nets

        def g(vol, axis, d):
            return gan_loss(nets[d](_each_slice(vol, axis)), True, "lsgan")

        def dp(vr, ar, vf, af, d):
            return (gan_loss(nets[d](_each_slice(vr, ar)), True, "lsgan")
                    + gan_loss(nets[d](_each_slice(vf, af)), False, "lsgan")) * 0.5

        third = 1 / 3
        want = {"G_A_xy": g(fake, t, "D_A_xy") * third, "G_A_yz": g(fake, s_, "D_A_yz") * third,
                "G_A_xz": g(fake, r, "D_A_xz") * third, "G_B_xy": g(rec, t, "D_B_xy") * third,
                "G_B_yz": g(rec, s_, "D_B_yz") * third, "G_B_xz": g(rec, r, "D_B_xz") * third,
                "cycle_A": l1_loss(rec, real) * 5.0,
                "D_A_xy": dp(real, t, fake, t, "D_A_xy"), "D_A_yz": dp(real, t, fake, s_, "D_A_yz"),
                "D_A_xz": dp(real, t, fake, r, "D_A_xz"), "D_B_xy": dp(real, t, rec, t, "D_B_xy"),
                "D_B_yz": dp(real, s_, rec, s_, "D_B_yz"),
                "D_B_xz": dp(real, r, rec, r, "D_B_xz")}
        want["G_A"] = want["G_A_xy"] + want["G_A_yz"] + want["G_A_xz"]
        want["G_B"] = want["G_B_xy"] + want["G_B_yz"] + want["G_B_xz"]
    errs = {k: abs(float(terms[k]) - float(v)) / max(abs(float(v)), 1e-12)
            for k, v in want.items()}
    worst = max(errs.values())
    log(f"  Athena's {len(errs)} losses against make_athena_step's formulas restated (every "
        f"slice of the named axes): largest relative difference {worst:.3g} (limit "
        f"{ATHENA_TERMS_REL})")
    bad = {k: e for k, e in errs.items() if not e <= ATHENA_TERMS_REL}
    if bad or set(want) != set(model.loss_names):
        raise AssertionError(f"Athena's losses off the restated step: {bad}")
    return worst


def athena_inputs(vol: np.ndarray, dev, seed: int):
    """A function model -> (real, None): one 128^3 crop of ``vol`` drawn as
    the trainer draws it (Athena draws no probe)."""
    preprocess = ATHENA_ARGS[ATHENA_ARGS.index("--preprocess") + 1]
    dataset = SingleVolumeDataset(vol, (ATHENA_CROP,) * 3, preprocess, dev)
    real = dataset.sample(torch.Generator().manual_seed(seed))
    return lambda model: (real, None)


def check_peaks(make, step, dev, expected: dict) -> dict:
    """One step (``step(model)``) of two models from the same weights
    (``make(remat)``), with --remat and without, on the same crops and
    draws: the launches of each exactly ``expected[remat]``, parameters,
    Adam state and losses required bitwise equal, and each step's peak
    device memory (both models resident), the remat one required lower."""
    models = {remat: make(remat) for remat in (True, False)}
    losses, peaks, bad = {}, {}, []
    for remat, model in models.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        kernel_ops.reset_launches()
        out, *_ = step(model)
        torch.cuda.synchronize()
        peaks[remat] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30, base / 2 ** 30)
        losses[remat] = {k: v.clone() for k, v in out.items()}
        if kernel_ops.launches() != expected[remat]:
            bad.append(f"launches {'with' if remat else 'without'} remat "
                       f"{kernel_ops.launches()} != {expected[remat]}")
    bad += _model_state_diffs(models[True], models[False])
    bad += [f"loss {k}" for k in losses[True] if not torch.equal(losses[True][k],
                                                                 losses[False][k])]
    log(f"  peak device memory {peaks[True][0]:.3f} GiB with --remat, {peaks[False][0]:.3f} GiB "
        f"without (both models resident: {peaks[True][1]:.3f} GiB before the step); remat "
        "against no remat: "
        + ("launches as expected with and without, parameters, Adam state and losses "
           "bitwise equal" if not bad else f"DIFFER: {bad[:6]}"))
    if bad:
        raise AssertionError(f"the remat step differs from the step without: {bad[:6]}")
    if not peaks[True][0] < peaks[False][0]:
        raise AssertionError(f"remat peak {peaks[True][0]:.3f} GiB not below {peaks[False][0]:.3f}")
    del models
    torch.cuda.empty_cache()
    return {"peak_gib": peaks[True][0], "peak_gib_no_remat": peaks[False][0],
            "base_gib": peaks[True][1]}


def run_athena(seed: int, dev, tmp: str) -> dict:
    """The JAX study's Athena command through ``train_onecube.main`` from the
    eight trained nets: launches exact (remat's recomputations counted), the
    step median; the peaks with and without remat (bitwise equal steps); the
    three-way step at the trained weights judged by ``judge_step``; the
    losses against the restated formulas."""
    vol = synthetic_volume(seed + 10, ATHENA_VOLUME)
    data = os.path.join(tmp, "athena_data")
    tiffio.imwrite(os.path.join(data, "volume.tif"), vol)
    ckpt = os.path.join(tmp, "athena_ckpt")
    os.makedirs(os.path.join(ckpt, ATHENA_NAME))
    for n in ATHENA_MODEL_NAMES:
        f = f"iter_{ATHENA_LOAD_ITER}_net_{n}.npz"
        os.symlink(os.path.join(ATHENA_STATE, f), os.path.join(ckpt, ATHENA_NAME, f))
    argv = ["--dataroot", data, "--checkpoints_dir", ckpt, "--name", ATHENA_NAME, *ATHENA_ARGS,
            "--continue_train", "--load_iter", str(ATHENA_LOAD_ITER),
            "--max_iters", str(ATHENA_ITERS)]
    kernel_ops.reset_launches()
    res = train_onecube.main(argv)
    launches = kernel_ops.launches()
    expected = {k: ATHENA_ITERS * v for k, v in ATHENA_REMAT_STEP_LAUNCHES.items()}
    per_step = {k: v // ATHENA_ITERS for k, v in launches.items()}
    log(f"  launches over {ATHENA_ITERS} steps {launches} ({per_step} per step), expected "
        f"{expected}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    if res["total_iters"] != ATHENA_LOAD_ITER + 1 + ATHENA_ITERS or not all(
            math.isfinite(v) for step in res["losses"] for v in step.values()):
        raise AssertionError(f"the Athena run ended at {res['total_iters']} with losses "
                             f"{res['losses']}")
    if list(res["losses"][0]) != ATHENA_LOSS_NAMES:
        raise AssertionError(f"Athena's losses {list(res['losses'][0])}")
    step_ms = _median_ms(res["step_seconds"])
    log(f"  step ms ({ATHENA_CROP}^3, bf16, --remat, trained nets): first "
        f"{1e3 * res['step_seconds'][0]:.1f}, then "
        + ", ".join(f"{1e3 * t:.1f}" for t in res["step_seconds"][1:])
        + f"; median {step_ms:.1f} ms")
    log("  last losses: " + ", ".join(f"{k} {v:.5g}" for k, v in res["losses"][-1].items()))
    del res
    torch.cuda.empty_cache()

    flats = athena_flats()
    inputs = athena_inputs(vol, dev, seed + 11)
    real, _ = inputs(None)
    log(f"  one Athena step at {ATHENA_CROP}^3 from the trained nets:")
    mem = check_peaks(lambda remat: athena_model(flats, dev, remat=remat),
                      lambda model: model.optimize_parameters(real, None), dev,
                      {True: ATHENA_REMAT_STEP_LAUNCHES, False: ATHENA_STEP_LAUNCHES})
    terms = check_athena_terms(athena_model(flats, dev), real)
    runs = model_three_ways(lambda plain, precision: athena_model(flats, dev, plain=plain,
                                                                  precision=precision), inputs)
    pooled = report_three_ways(f"Athena step at {ATHENA_CROP}^3 from the trained nets", runs,
                               ATHENA_DIRECT, ATHENA_LOSS_NAMES, ATHENA_D_NAMES)
    return {"launches": launches, "per_step": per_step, "step_ms": step_ms, **mem,
            "pooled": pooled, "terms": terms}


def dryops_inputs(vol: np.ndarray, dev, seed: int):
    """(make(plain, precision) -> Dryops model with the seed's Kaiming
    weights, the dataset of ``vol`` on the card, two crops' draws, the
    generator of the step's draws)."""
    argv = ["--dataroot", "unused", *DRYOPS_ARGS]
    opt = train_options.build_parser(argv).parse_args(argv)

    def make(plain, precision):
        opt.precision = precision
        model = create_model(opt, dev, plain=plain)
        model.init_weights(seed)
        return model

    dataset = SingleVolumeDataset(vol, (CROP,) * 3, opt.preprocess, dev)
    gen = torch.Generator().manual_seed(seed + 13)
    return make, dataset, [dataset.draws(gen) for _ in range(2)], gen


def check_dryops_accumulation(vol: np.ndarray, dev, seed: int) -> float:
    """Dryops' accumulation of two crops under one step's draws against the
    mean of their gradients under those draws (``check_accumulation``)."""
    make, dataset, geometry, gen = dryops_inputs(vol, dev, seed)
    model = make(False, "bfloat16")
    err = check_accumulation(model, lambda i: dataset.crop(*geometry[i]), 2,
                             model.draw_probes((CROP,) * 3, gen))
    del model
    torch.cuda.empty_cache()
    return err


def run_dryops(seed: int, dev, tmp: str) -> dict:
    """Dryops through ``train_onecube.main`` at 108^3 from random Kaiming
    weights: launches exact, the step median; the three-way step judged by
    ``judge_step`` at the random-weight limits; the accumulation of two
    crops under one set of draws against the mean of their gradients."""
    vol = synthetic_volume(seed + 12, TRAIN_VOLUME)
    data = os.path.join(tmp, "dryops_data")
    tiffio.imwrite(os.path.join(data, "volume.tif"), vol)
    argv = ["--dataroot", data, "--checkpoints_dir", os.path.join(tmp, "dryops_ckpt"),
            "--name", "dryops", *DRYOPS_ARGS, "--max_iters", str(DRYOPS_ITERS), "--seed",
            str(seed)]
    kernel_ops.reset_launches()
    res = train_onecube.main(argv)
    launches = kernel_ops.launches()
    expected = {k: DRYOPS_ITERS * v for k, v in DRYOPS_STEP_LAUNCHES.items()}
    log(f"  launches over {DRYOPS_ITERS} steps {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    if not all(math.isfinite(v) for step in res["losses"] for v in step.values()):
        raise AssertionError(f"a Dryops loss is not finite: {res['losses']}")
    step_ms = _median_ms(res["step_seconds"])
    log(f"  step ms ({CROP}^3, bf16): first {1e3 * res['step_seconds'][0]:.1f}, then "
        + ", ".join(f"{1e3 * t:.1f}" for t in res["step_seconds"][1:])
        + f"; median {step_ms:.1f} ms")
    del res

    make, dataset, geometry, gen = dryops_inputs(vol, dev, seed)

    def inputs(model):
        return dataset.crop(*geometry[0]), model.draw_probes((CROP,) * 3, gen)

    runs = model_three_ways(make, inputs)
    pooled = report_three_ways(f"Dryops step at {CROP}^3, random weights", runs, STEP_DIRECT,
                               DRYOPS_LOSS_NAMES, DRYOPS_D_NAMES)
    acc = check_dryops_accumulation(vol, dev, seed)
    return {"launches": launches, "step_ms": step_ms, "pooled": pooled, "accum_err": acc}


def host_rotation_reference(sl: np.ndarray, angle: float) -> np.ndarray:
    """``rotate_clean`` of one uint16 slice in float64, independently of the
    twin: the inverse of the host geometry's forward map, then
    ``scipy.ndimage.map_coordinates`` (order 1) over the inscribed crop."""
    from scipy.ndimage import map_coordinates

    h, w = sl.shape
    _, _, x1, y1, cw, ch, fwd = warp.rotation_geometry_f64(float(w), float(h), float(angle))
    m = np.array([[fwd[0], fwd[1], fwd[2]], [fwd[3], fwd[4], fwd[5]], [0, 0, 1]])
    inv = np.linalg.inv(m)
    yy, xx = np.mgrid[y1:y1 + ch, x1:x1 + cw].astype(np.float64)
    sx = inv[0, 0] * xx + inv[0, 1] * yy + inv[0, 2]
    sy = inv[1, 0] * xx + inv[1, 1] * yy + inv[1, 2]
    return map_coordinates(sl.astype(np.float64), [sy, sx], order=1, mode="grid-constant",
                           cval=0.0)


def check_host_rotation(vol: np.ndarray) -> dict:
    """The host chain's slice rotation (``data/warp.py``) on eight uint16
    slices of ``vol`` at HOST_ROT_ANGLES against ``host_rotation_reference``
    within HOST_ROT_*_LSB."""
    worst, means = 0.0, []
    for angle in HOST_ROT_ANGLES:
        got = warp.rotate_clean(vol[:8], angle).astype(np.float64)
        want = np.stack([host_rotation_reference(sl, angle) for sl in vol[:8]])
        d = np.abs(got - want)
        worst, means = max(worst, float(d.max())), means + [float(d.mean())]
    log(f"  host chain rotation at {HOST_ROT_ANGLES} deg against scipy float64: max "
        f"{worst:.3f} LSB, mean {max(means):.4f} LSB (limits {HOST_ROT_MAX_LSB}, "
        f"{HOST_ROT_MEAN_LSB})")
    if not (worst <= HOST_ROT_MAX_LSB and max(means) <= HOST_ROT_MEAN_LSB):
        raise AssertionError(f"host rotation off float64: max {worst}, mean {max(means)}")
    return {"max_lsb": worst, "mean_lsb": max(means)}


def run_epoch(seed: int, dev, tmp: str) -> dict:
    """The epoch trainer over three 160^3 TIFFs: launches exact, the
    host chain's seconds per item beside the step time, the checkpoints of
    the epoch; the same epoch under torch.profiler for the device's idle
    share; the host rotation against float64."""
    data = os.path.join(tmp, "epoch_data")
    vols = [synthetic_volume(seed + 20 + i, TRAIN_VOLUME) for i in range(EPOCH_VOLUMES)]
    for i, vol in enumerate(vols):
        tiffio.imwrite(os.path.join(data, f"volume{i + 1}.tif"), vol)
    rot = check_host_rotation(vols[0])
    ckpt = os.path.join(tmp, "epoch_ckpt")
    argv = ["--dataroot", data, "--checkpoints_dir", ckpt, "--name", "epoch", *EPOCH_ARGS,
            "--seed", str(seed)]
    kernel_ops.reset_launches()
    t0 = time.perf_counter()
    res = train.main(argv)
    wall = time.perf_counter() - t0
    launches = kernel_ops.launches()
    expected = {k: EPOCH_VOLUMES * v for k, v in STEP_LAUNCHES.items()}
    log(f"  launches over {EPOCH_VOLUMES} items {launches}, expected {expected}")
    if launches != expected or res["total_iters"] != EPOCH_VOLUMES:
        raise AssertionError(f"launch counts {launches} != {expected} ({res['total_iters']} "
                             "items)")
    if not all(math.isfinite(v) for step in res["losses"] for v in step.values()):
        raise AssertionError(f"an epoch loss is not finite: {res['losses']}")
    written = os.listdir(os.path.join(ckpt, "epoch"))
    missing = [f"{s}_net_{n}.{e}" for s in ("1", "latest") for n in MODEL_NAMES for e in ("npz",)
               if f"{s}_net_{n}.npz" not in written]
    if missing or "1_optim.npz" not in written or "latest_optim.npz" not in written:
        raise AssertionError(f"epoch checkpoints missing: {missing}")
    item_s, step_ms = res["item_seconds"], _median_ms(res["step_seconds"])
    log(f"  epoch of {EPOCH_VOLUMES} items in {wall:.3f} s; host chain seconds per item "
        + ", ".join(f"{t:.3f}" for t in item_s) + "; step ms "
        + ", ".join(f"{1e3 * t:.1f}" for t in res["step_seconds"])
        + "; the loop waited " + ", ".join(f"{t:.3f}" for t in res["wait_seconds"])
        + " s for its items")
    del res
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        train.main([*argv, "--name", "epoch_profiled"])
    loop_ms, busy, ops = _range_device_ms(prof, "epoch_loop")
    idle = max(0.0, 1 - busy / loop_ms)
    log(f"  the epoch under torch.profiler: the loop's range {loop_ms:.1f} ms (start-up "
        f"excluded), device time in it {busy:.1f} ms, idle share {idle:.3f}, {ops} device "
        "operations")
    torch.cuda.empty_cache()
    return {"launches": launches, "item_s": item_s, "step_ms": step_ms, "idle": idle,
            "rotation": rot, "wall_s": wall}


def run_trained_dice(seed: int, dev, tmp: str) -> dict:
    """The slice's tile pipeline (``test_dice.main``, its flags and volume)
    on the JAX study's trained Apollo G_A: launches as the slice's, the
    output against the plain versions in f32 and in bf16 within TRAINED_*."""
    vol = synthetic_volume(seed)
    os.makedirs(os.path.join(tmp, "data"))
    np.save(os.path.join(tmp, "data", "volume.npy"), vol)
    os.makedirs(os.path.join(tmp, "ckpt", "trained"))
    os.symlink(TRAINED_G_A, os.path.join(tmp, "ckpt", "trained", "iter_1_net_G_A.npz"))
    flat = load_npz(TRAINED_G_A)
    grid = DiceGrid(pad_for_dicing(vol, 120, 15).shape, 120, 15, 10)
    batches = grid.z_steps * -(-(grid.y_steps * grid.x_steps) // 2)
    expected = {name: 0 for name in kernel_ops.KERNELS}
    expected.update({"wconv3x3x3": 2 * batches, "pair_sums": 10 * batches,
                     "affine_map_act": 10 * batches})
    kernel_ops.reset_launches()
    res = test_dice.main(["--dataroot", os.path.join(tmp, "data"), "--name", "trained",
                          "--checkpoints_dir", os.path.join(tmp, "ckpt"), "--load_iter", "1",
                          "--model_suffix", "_A", "--results_dir", os.path.join(tmp, "results"),
                          *SLICE_ARGS])
    launches = kernel_ops.launches()
    log(f"  launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    out = res["fake"]
    outs, _ = plain_outputs(flat, vol, dev, ("bfloat16", "float32"))
    ref = outs["float32"]
    p_err, k_err = lsb_stats(outs["bfloat16"], ref), lsb_stats(out, ref)
    kp = np.abs(out.astype(np.int64) - outs["bfloat16"])
    log(f"  trained G_A against the f32 plain output: kernels (bf16) {k_err}; plain versions "
        f"(bf16) {p_err}; kernels vs plain (bf16): max {int(kp.max())} LSB, mean "
        f"{float(kp.mean()):.3f} LSB, {float((kp > 0).mean()):.4f} of voxels differ (limits "
        f"{TRAINED_KP_MAX_LSB}, {TRAINED_KP_MEAN_LSB}); output mean {out.mean():.1f} std "
        f"{out.std():.1f}")
    if (k_err["mean_lsb"] > SLICE_MEAN_RATIO * p_err["mean_lsb"]
            or k_err["max_lsb"] > p_err["max_lsb"] + SLICE_MAX_EXTRA_LSB):
        raise AssertionError(f"trained G_A: kernels less accurate than the plain path: {k_err} "
                             f"vs {p_err}")
    if kp.max() > TRAINED_KP_MAX_LSB or kp.mean() > TRAINED_KP_MEAN_LSB:
        raise AssertionError(f"trained G_A: kernels off the plain path: max {kp.max()}, mean "
                             f"{kp.mean()}")
    return {"launches": launches, "k_err": k_err, "p_err": p_err,
            "kp_max": int(kp.max()), "kp_mean": float(kp.mean())}


def profile_athena_step(dev, seed: int) -> None:
    """Where the time of the study's Athena step goes: a warm step from the
    trained nets timed on the host clock, then one under torch.profiler,
    device time by kernel, the device's idle share and operations."""
    model = athena_model(athena_flats(), dev)
    real, _ = athena_inputs(synthetic_volume(seed + 10, ATHENA_VOLUME), dev, seed + 14)(model)

    def step():
        model.optimize_parameters(real, None)
        torch.cuda.synchronize()

    step()
    t0 = time.perf_counter()
    step()
    wall = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
    rows = _device_rows(prof)
    busy = sum(r[1] for r in rows)
    log(f"  warm Athena step ({ATHENA_CROP}^3, bf16, --remat, trained nets) wall {wall:.1f} ms; "
        f"device time {busy:.1f} ms (idle share {max(0.0, 1 - busy / wall):.3f}); "
        f"{sum(r[2] for r in rows)} device operations")
    for key, ms, count in rows[:16]:
        log(f"    {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{count:<5d} {key[:90]}")
    del model


def profile_pipeline(dev, seed: int) -> None:
    """Where the time of the slice goes: a warm run of the tile pipeline
    timed on the host clock, then the same run under torch.profiler, device
    time by kernel name (the profiler's own overhead stays out of the wall
    time)."""
    log(f"  tile pipeline, NEUROCLEAR_PALLAS_CONV={int(conv3x3.enabled())}:")
    vol = synthetic_volume(seed)
    vp = pad_for_dicing(vol, 120, 15)
    net = UNetDeconv(1, 1)
    net.load_state_dict(params_from_numpy(init_flat(net, seed=seed), net))
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


def profile_legacy(dev, seed: int, cubes: int = 3) -> None:
    """Where the time of the per-cube loop goes: ``cubes`` warm cubes of
    140^3 through the CLI's model (upload in f32, the generator in f32, both
    visuals back to the host, a sync per cube, as ``run_legacy`` does) on
    the host clock, then under torch.profiler: device time by kernel with
    the copies, and the device's idle share."""
    model = test_dice.TestModel(argparse.Namespace(checkpoints_dir=".", name="smoke",
                                                   model_suffix="_A"), dev)
    model.netG.load_state_dict(params_from_numpy(init_flat(model.netG, seed=seed), model.netG))
    model.netG.to(dev)
    rng = np.random.default_rng(seed)
    cube = {"A": rng.random((1, TILE, TILE, TILE, 1), np.float32), "A_paths": "0"}

    def loop():
        for _ in range(cubes):
            model.set_input(cube)
            model.test()
            _ = {k: v.cpu().numpy() for k, v in model.get_current_visuals().items()}

    loop()
    t0 = time.perf_counter()
    loop()
    wall = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        loop()
    rows = _device_rows(prof)
    busy = sum(r[1] for r in rows)
    copies = sum(r[1] for r in rows if r[0].startswith("Memcpy"))
    log(f"  per-cube loop, {cubes} warm cubes of {TILE}^3 (f32): wall {wall:.1f} ms "
        f"({wall / cubes:.1f} ms per cube); device time {busy:.1f} ms (idle share "
        f"{max(0.0, 1 - busy / wall):.3f}), of it copies {copies:.1f} ms "
        f"({TILE ** 3 * 4 / 1e6:.1f} MB up and {2 * TILE ** 3 * 4 / 1e6:.1f} MB back per cube)")
    for key, ms, count in rows[:12]:
        log(f"    {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{count:<4d} {key[:90]}")


def _range_device_ms(prof, name: str) -> tuple:
    """(wall ms of the host range ``name``, device ms inside it, device
    operations inside it) from a torch.profiler run: each kernel and copy
    clipped to the range."""
    ranges = [e.time_range for e in prof.events() if e.name == name
              and e.device_type == torch.autograd.DeviceType.CPU]
    if len(ranges) != 1:
        raise AssertionError(f"expected one profiler range {name!r}, found {len(ranges)}")
    lo, hi = ranges[0].start, ranges[0].end
    busy, ops = 0.0, 0
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False) or e.name == name):
            continue
        overlap = min(e.time_range.end, hi) - max(e.time_range.start, lo)
        if overlap > 0:
            busy, ops = busy + overlap, ops + 1
    return (hi - lo) / 1e3, busy / 1e3, ops


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
    the host clock, then one under torch.profiler, device time by kernel;
    and the device time and operations of the same step on a crop without
    rotation."""
    opt = train_options.build_parser().parse_args(["--dataroot", "unused", *TRAIN_ARGS])
    vol = synthetic_volume(seed, TRAIN_VOLUME)
    dataset = SingleVolumeDataset(vol, (CROP,) * 3, opt.preprocess, dev)
    model = ApolloModel(opt, dev)
    model.init_weights(seed)
    gen = torch.Generator().manual_seed(seed)

    def step(sync=True, data=dataset):
        model.optimize_parameters(data.sample(gen), model.draw_probes((CROP,) * 3, gen))
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
    flat = SingleVolumeDataset(vol, (CROP,) * 3, NO_ROTATION[1], dev)
    rows = device_operations(lambda: step(data=flat))
    log(f"  the same step on a crop without rotation: device time "
        f"{sum(r[1] for r in rows):.1f} ms; {sum(r[2] for r in rows)} device operations")


def profile_study_step(dev, seed: int) -> None:
    """Where the time of the study's accum-8 remat step goes: a warm step
    from the trained nets timed on the host clock, then one under
    torch.profiler, device time by kernel and the device's idle share."""
    model = study_model(study_flats(), dev)
    vol = synthetic_volume(seed, STUDY_VOLUME)
    crop, draws = study_inputs(vol, dev, seed + 8, STUDY_ACCUM, model)

    def step():
        model.optimize_parameters_accum(crop, STUDY_ACCUM, draws)
        torch.cuda.synchronize()

    step()
    t0 = time.perf_counter()
    step()
    wall = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
    rows = _device_rows(prof)
    busy = sum(r[1] for r in rows)
    log(f"  warm study step (accum {STUDY_ACCUM}, {STUDY_CROP}^3, bf16, --remat) wall "
        f"{wall:.1f} ms; device time {busy:.1f} ms (idle share {max(0.0, 1 - busy / wall):.3f}); "
        f"{sum(r[2] for r in rows)} device operations")
    for key, ms, count in rows[:16]:
        log(f"    {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{count:<5d} {key[:90]}")
    del model


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
        # the per-cube loop's norms: batch 1, f32
        lsums, lamap = check_norm(gen, dev, shapes=LEGACY_NORM_SHAPES, dtype=torch.float32,
                                  label="cube of the per-cube loop (f32)")
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

    with Phase("legacy") as ph, tempfile.TemporaryDirectory() as tmp:
        lg = run_legacy(args.seed, dev, tmp)
        ph.result = (f"{lg['cubes']} cubes of 140^3 in {lg['seconds']:.3f} s "
                     f"({lg['cubes'] / lg['seconds']:.3f} cubes/s, f32): against the plain "
                     f"versions {lg['kp']}, against the fused path (f32) {lg['fused']}; "
                     f"flip-TTA + histogram match {lg['tta']}; run against run_streaming "
                     f"{lg['run']}")

    with Phase("train") as ph, tempfile.TemporaryDirectory() as tmp:
        tr = run_train(args.seed, dev, tmp)
        ph.result = (f"{CROP}^3 Apollo step {tr['step_ms']:.1f} ms with rotation, "
                     f"{tr['flat_ms']:.1f} ms without (medians of {TRAIN_ITERS - 1}), rotated "
                     f"crops within {tr['rotation']['max_abs_err']:.3g} of float64, gradient "
                     f"error against f32 (kernels / plain bf16) {tr['pooled']}")

    with Phase("resume") as ph, tempfile.TemporaryDirectory() as tmp:
        rs = run_resume(args.seed, dev, tmp)
        ph.result = (f"state restored exactly; next step {rs['resumed']:.3g} from the "
                     f"in-memory one (two runs from one state: {rs['rerun']:.3g})")

    with Phase("study") as ph, tempfile.TemporaryDirectory() as tmp:
        st = run_study(args.seed, dev, tmp, tr["pooled"])
        ph.result = (f"{STUDY_CROP}^3 accum-{STUDY_ACCUM} --remat step {st['step_ms']:.1f} ms "
                     f"(median of {STUDY_ITERS - 1}); peak {st['peak_gib']:.3f} GiB with remat, "
                     f"{st['peak_gib_no_remat']:.3f} without, bitwise equal; trained-weight "
                     f"gradient error against f32 (kernels / plain bf16) {st['pooled']}")

    with Phase("athena") as ph, tempfile.TemporaryDirectory() as tmp:
        at = run_athena(args.seed, dev, tmp)
        ph.result = (f"{ATHENA_CROP}^3 Athena --remat step {at['step_ms']:.1f} ms (median of "
                     f"{ATHENA_ITERS - 1}); peak {at['peak_gib']:.3f} GiB with remat, "
                     f"{at['peak_gib_no_remat']:.3f} without, bitwise equal; trained-weight "
                     f"gradient error against f32 (kernels / plain bf16) {at['pooled']}")

    with Phase("dryops") as ph, tempfile.TemporaryDirectory() as tmp:
        dr = run_dryops(args.seed, dev, tmp)
        ph.result = (f"{CROP}^3 Dryops step {dr['step_ms']:.1f} ms (median of "
                     f"{DRYOPS_ITERS - 1}); gradient error against f32 (kernels / plain bf16) "
                     f"{dr['pooled']}; accumulation {dr['accum_err']:.3g}")

    with Phase("epoch") as ph, tempfile.TemporaryDirectory() as tmp:
        ep = run_epoch(args.seed, dev, tmp)
        ph.result = (f"{EPOCH_VOLUMES} items of {TRAIN_VOLUME}^3, host chain "
                     f"{np.median(ep['item_s']):.3f} s per item, step {ep['step_ms']:.1f} ms, "
                     f"idle share {ep['idle']:.3f}; host rotation {ep['rotation']}")

    with Phase("trained G_A") as ph, tempfile.TemporaryDirectory() as tmp:
        tg = run_trained_dice(args.seed, dev, tmp)
        ph.result = (f"trained G_A, {VOLUME}^3 bf16: against f32 {tg['k_err']} (plain bf16 "
                     f"{tg['p_err']}); against plain bf16 max {tg['kp_max']}, mean "
                     f"{tg['kp_mean']:.3f} LSB")

    if args.profile:
        with Phase("profile"):
            profile_pipeline(dev, args.seed)
            with dense_k_route():
                profile_pipeline(dev, args.seed)
            profile_legacy(dev, args.seed)
            profile_train_step(dev, args.seed)
            profile_study_step(dev, args.seed)
            profile_athena_step(dev, args.seed)

    # Times: the inference kernels' rows sum one 2 x 140^3 tile batch's
    # launches, the training kernels' rows one 108^3 step's; the forward
    # norm's rows (pair_sums, affine_map_act) carry the step's sums beside
    # the batch's as step_*, and one f32 cube's of the per-cube loop as
    # legacy_*; launches are the counts of the slice's run, the dice CLI's,
    # the per-cube loop's, its flip-TTA run's, the non-streaming run's, the
    # trainer's and the resumed trainer's.
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
                   "legacy": lg["launches"][name], "legacy_tta": lg["tta_launches"][name],
                   "run": lg["run_launches"][name], "train": tr["launches"][name],
                   "train_f32": tr["f32_launches"][name], "resume": rs["launches"][name],
                   "study": st["launches"][name], "athena": at["launches"][name],
                   "dryops": dr["launches"][name], "epoch": ep["launches"][name],
                   "trained_dice": tg["launches"][name]}
        rows.append({"name": name, "route": "cuda", "source": csrc + src,
                     "replaces": "neuroclear_tpu/ops/" + replaces,
                     "launches": sum(by_path.values()), "launches_by_path": by_path,
                     "max_abs_err": tot["err"],
                     "ms": tot["ms"], "plain_ms": tot["plain_ms"],
                     "bound_ms": max(tot["tb"], tot["to"]),
                     "bound_by": "operations" if tot["to"] > tot["tb"] else "bytes",
                     "library_ms": tot["library_ms"]})
        for prefix, per in (("step", {"pair_sums": step_norm["sums"],
                                      "affine_map_act": step_norm["amap"]}),
                            ("legacy", {"pair_sums": lsums, "affine_map_act": lamap})):
            if name in per:
                t = per[name]
                rows[-1].update({f"{prefix}_ms": t["ms"], f"{prefix}_plain_ms": t["plain_ms"],
                                 f"{prefix}_bound_ms": max(t["tb"], t["to"]),
                                 f"{prefix}_library_ms": t["library_ms"]})
    faulthandler.cancel_dump_traceback_later()
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
