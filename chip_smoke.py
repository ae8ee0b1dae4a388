#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (neuroclear_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile] [--quality700]

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
  11. quality study: the JAX study's s4 run (``scripts/run_quality_study.sh``)
     through the port's driver (``run_quality_study --inprocess``): the
     300^3 ``--preset s4 --seed 0`` volumes generated on the host with the
     port's CLI, their sha256 required equal to the CPU's
     (``SYNTH_S4_300``); NAME apollo148s4 seeded from a bank of the study's
     iteration 11000, two segments of two iterations (148^3, bf16,
     ``--remat``) and evals at 11002, 11006 and the final one with the
     study's eval flags (the fused ``test_dice`` path), each with its
     diagnosis; every eval's two protocol blocks, the diagnosis rows, the
     selection (the argmax, also on the logs with their iterations
     permuted) and the launches of the whole study exact (four steps'
     ``REMAT_STEP_LAUNCHES`` and each eval's 32 tile batches); the step
     times and eval seconds; then one accum-2 step of the study command three
     ways (host windows, ``NEUROCLEAR_ACCUM_DEVICE_VOL=1``,
     ``--fused_accum``): the fused form bitwise the device volume's, the
     host-window crops within JAX's border bound of the device volume's,
     each run's peak memory and a host-window crop's seconds;
  12. athena: the JAX study's Athena command (``--model
     axial_to_lateral_gan_athena --conversion_plane yz xy``, 128^3 crops,
     ``--remat``, bf16) through ``train_onecube.main`` on a synthetic 256^3
     TIFF from the eight nets the study trained (``study_state/athena148``)
     with a fresh Adam: four steps, launches exact per step (every
     discriminator norm over 128 slices), the step median; one step with
     and without remat, bitwise equal, with each peak; the 15 losses against
     the JAX step's formulas restated here; one step three ways judged with
     ``ATHENA_DIRECT``;
  13. dryops: ``--model axial_to_lateral_gan_dryops`` at 108^3 from random
     Kaiming weights: four steps, launches exact, the step median, the
     three-way step, and two crops' accumulation under one set of draws;
  14. epoch: the epoch trainer (``neuroclear_tpu_torch.train.main``) with the
     cube dataset over three synthetic 160^3 TIFFs, the production flags in
     bf16, one epoch with the host chain on a prefetching thread: launches
     exact, the host chain's seconds per item beside the step times, the
     epoch's checkpoints, the device's idle share over the epoch loop (the
     epoch again under torch.profiler, its ``epoch_loop`` range), and the
     host chain's rotation against scipy float64;
  15. trained G_A: the slice's tile pipeline on the JAX study's trained
     Apollo G_A, its launches, its bf16 output against the plain versions
     in f32 and in bf16 within ``TRAINED_KP_*``;
  16. vanilla: Apollo's production command in bf16 with ``--netG
     unet_vanilla`` at 112^3 (it pools three times) through
     ``train_onecube.main`` on a synthetic 176^3 TIFF, random Kaiming
     weights: four steps, launches exact (``VANILLA_STEP_LAUNCHES``), the
     step median, a warm step's device time, idle share and peak memory; the
     three-way step judged with ``VANILLA_DIRECT``; test_dice from its
     checkpoint on the slice's volume with 144^3 tiles against the plain
     versions in bf16 and f32 (``VANILLA_KP_*``);
  17. batchnorm: the production flags with ``--norm batch`` at 108^3, bf16,
     four steps, only the W-pair conv launched (``BATCHNORM_STEP_LAUNCHES``);
     the kernel and plain models in lockstep, after each step the refresh
     against its restated formula and the running statistics against the
     plain model's; test_dice ``--norm batch`` from the checkpoint with and
     without ``--eval``, each against its plain path;
  18. zoo nets: every other ``define_G`` / ``define_D`` name at its factory
     width (3D generators at 64^3, the ResNets at 256^2, VGG16 at 2 x 224^2,
     the discriminators at 128 slices of 128^2), forward and backward in
     bf16 and f32, kernels against plain, with the hand kernels each
     launched; the spectral norm and ResNet's transposed conv against
     restatements;
  19. dp: data parallelism on the one card.  The train phase's command for
     four steps through ``python -m torch.distributed.run --standalone
     --nproc_per_node 1 -m neuroclear_tpu_torch.train_onecube`` (NCCL at a
     world of one): the process group up and the model wrapped, its
     launches per step the train phase's, its checkpoint and logged losses
     those of two plain runs of the command within their own distance
     (bitwise where they are), its step median beside the train phase's.
     Then two ranks of this script (``--dp-rank``) over gloo on cuda:0
     under torchrun: the production Apollo step at 108^3 in bf16, four
     steps, and the study's Athena command from its trained nets, two
     steps, each first step's averaged gradients and losses against the
     single-process ``--grad_accum 2`` step from the same seed, crops and
     draws (bitwise, else within a rerun's distance); ``--norm batch`` at
     108^3 in f32, two steps, against the single-process batched step on
     both crops, with the refreshed running statistics; after every step
     each parameter, buffer and Adam tensor bitwise equal on both ranks
     (checksums all-reduced as (c, -c) maxima); each rank's launches exact;
     the slice's tile pipeline sharded over the ranks (``n_devices=2``,
     rank 0 one card's tile batches 0, 2 and 4 of each slab, five tiles,
     rank 1 batches 1 and 3, four) against one card within 1
     LSB, both ranks' volumes equal; the gloo step medians (two processes
     sharing one card, not a multi-card speed) and the bytes all-reduced
     per step;
  20. profile (only with --profile): a warm run of the slice's tile pipeline
     (without and with the dense-K conv), three warm cubes of the per-cube
     loop (with its copies), a warm training step, a warm study step and a
     warm Athena step under torch.profiler, device time by kernel and the
     device's idle share, and warm steps with and without a sync after each.
``python3 chip_smoke.py --quality700`` runs instead, after the build, the
JAX study's eval of its iteration 11000 in the port (the 700^3 s4 volumes
regenerated, ``test_dice`` in bf16 and f32; the input row held to
docs/QUALITY.md's 21.49 / 0.459, the output rows printed beside its).
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
import re
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
from neuroclear_tpu_torch.models.base_model import atomic_savez
from neuroclear_tpu_torch.models.axial_to_lateral_gan_apollo_model import (
    D_NAMES, G_NAMES, LOSS_NAMES, MODEL_NAMES, ApolloModel)
from neuroclear_tpu_torch.models.axial_to_lateral_gan_athena_model import (
    D_NAMES as ATHENA_D_NAMES, LOSS_NAMES as ATHENA_LOSS_NAMES,
    MODEL_NAMES as ATHENA_MODEL_NAMES)
from neuroclear_tpu_torch.models.axial_to_lateral_gan_dryops_model import (
    D_NAMES as DRYOPS_D_NAMES, LOSS_NAMES as DRYOPS_LOSS_NAMES)
from neuroclear_tpu_torch.nn import norms
from neuroclear_tpu_torch.nn.factory import define_D, define_G
from neuroclear_tpu_torch.nn.losses import gan_loss, l1_loss
from neuroclear_tpu_torch.nn.generators import UNetDeconv
from neuroclear_tpu_torch.nn.schedulers import LRController
from neuroclear_tpu_torch.ops import build, conv3x3, inorm, rotation, wconv
from neuroclear_tpu_torch.ops.augment import crop_draws, window_plan
from neuroclear_tpu_torch.options import test_options, train_options
from neuroclear_tpu_torch.parallel import metrics as device_metrics
from neuroclear_tpu_torch.parallel.dice_infer import DiceInferencePipeline
from neuroclear_tpu_torch.scripts import (generate_synthetic, run_quality_study,
                                          select_checkpoint)
from neuroclear_tpu_torch.utils import png, synthetic, tiffio
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
# Apollo with --netG unet_vanilla: its three W-pair convs (double_conv1.conv1,
# ex_conv1_1.conv0 and .conv1) and G_B's feat1, forward and backward; its 14
# instance norms and the discriminators' 54, each differentiated.  With
# --remat the net has no per-block remat and is recomputed whole (JAX's
# jax.checkpoint fallback), as G_B is: every forward kernel of the two
# generators runs twice (tests/test_torch_zoo_models.py counts both)
VANILLA_STEP_LAUNCHES = {"wconv3x3x3": 4, "wconv_dx": 4, "wconv_dw": 4, "pair_sums": 68,
                         "affine_map_act": 68, "pair_sums_gy": 68, "bwd_map": 68, "conv3x3": 0}
VANILLA_REMAT_STEP_LAUNCHES = {**VANILLA_STEP_LAUNCHES, "wconv3x3x3": 8, "pair_sums": 82,
                               "affine_map_act": 82}
# The production nets under --norm batch: no instance norm anywhere, so only
# the W-pair conv's three rows launch (the batch norm is plain PyTorch, as it
# is plain jnp in the JAX package); the refresh pass after the step runs in
# f32, outside the bf16-only gate
BATCHNORM_STEP_LAUNCHES = {**STEP_LAUNCHES, "pair_sums": 0, "affine_map_act": 0,
                           "pair_sums_gy": 0, "bwd_map": 0}
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
PRE_NORM = ("double_conv", "bottom_layer", "ex_double_conv", "ex_conv1_1", "conv1",
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

# The quality study (scripts/run_quality_study.sh, the JAX study's s4 run)
# through the port's driver: the 300^3 --preset s4 --seed 0 volumes, whose
# sha256 (``synthetic.digest`` of the trio, computed on the CPU and equal to
# the JAX generator's, tests/test_torch_study.py) the card's host must give
# too; NAME apollo148s4 seeded from a bank of study_state/apollo148s4's
# iteration 11000: its six nets and its optimizer state where the checkout
# holds it (.chiprunignore keeps the 150 MB file out of the chip's copy,
# which holds 256 MiB and the Athena nets; there the port writes a fresh
# Adam's state, step 0 and zero moments, in its place), two segments of two
# iterations with
# SAVE_FREQ 2 (the JAX trainer resumes from N at N + 1, so they end at 11003
# and 11006, and the evals that exist are 11002 and 11006), and the final
# eval.  Cut: the volume (300^3, not 700^3), the segments and the ladder.
SYNTH_S4_300 = "63d5480a437de845031374769dbb10d20f215c5f537d8ecff244fc3a3b15936d"
QUALITY_NAME, QUALITY_SIZE, QUALITY_EVALS = "apollo148s4", 300, (11002, 11006)
QUALITY_CROP_DRAWS = 64  # host-window crops held against the device volume's
QUALITY_KNOBS = {"NAME": QUALITY_NAME, "MAX_ITERS": "11006",
                 "EVALS": " ".join(map(str, QUALITY_EVALS)), "SEG_ITERS": "2",
                 "SAVE_FREQ": "2", "PRINT_FREQ": "1", "WATCHDOG": "900", "SEG_TIMEOUT": "900",
                 "GEN_FLAGS": f"--preset s4 --size {QUALITY_SIZE}"}

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

# Vanilla: Apollo's production command in bf16 (TRAIN_ARGS) with --netG
# unet_vanilla, the 3-level U-Net (64 -> 128 -> 256 -> bottom 512), at 112^3:
# it pools three times, and 108 -> 54 -> 27 -> 13 cannot be concatenated back
# with 27 (in JAX as in the port).  Random Kaiming weights, four steps, on a
# synthetic 176^3 TIFF (it holds the 45-degree rotated 112^3 crop).  Then
# test_dice from its checkpoint on the slice's 260^3 volume, 144^3 tiles
# (dice 120, overlap 15, border_cut 12: a multiple of 8), bf16.  Cut: depth
# (four steps).
VANILLA_CROP, VANILLA_VOLUME, VANILLA_ITERS = 112, 176, 4
VANILLA_ARGS = [{"unet_deconv": "unet_vanilla", str(CROP): str(VANILLA_CROP)}.get(a, a)
                for a in TRAIN_ARGS]
VANILLA_DICE_ARGS = ["--dice_size", "120", "120", "120", "--overlap", "15", "--border_cut",
                     "12", "--tile_batch", "2", "--precision", "bfloat16", "--data_type",
                     "uint16", "--netG", "unet_vanilla"]
# The vanilla step judged by judge_step's rule; per-tensor limits against the
# plain bf16 step set from this phase's first reading on an H100 at seed 0
# (random weights: largest G_A 0.376, G_B 0.0032, D 0.152), at about 1.6, 3
# and 2 times those
VANILLA_DIRECT = {"G_A": 0.6, "G_B": 0.01, "D": 0.3}
# test_dice --netG unet_vanilla from the four-step checkpoint, kernels against
# the plain bf16 path: first reading on an H100 at seed 0 max 1792, mean 148.6
# LSB (both paths ~474.5 LSB mean from f32: fourteen norms on barely trained
# weights); limits at twice those
VANILLA_KP_MAX_LSB, VANILLA_KP_MEAN_LSB = 14 * 256, 300.0
# Batchnorm: Apollo's production flags in bf16 with --norm batch at 108^3 on
# the train phase's 160^3 volume, random Kaiming weights, four steps; no
# instance norm anywhere, so only the W-pair conv's rows launch
# (BATCHNORM_STEP_LAUNCHES).  After each step, every running statistic of the
# kernel model against the plain model's, run in lockstep from the same
# weights on the same crops and draws (relative L2 over all of them; bf16
# rounding and the kernel's sum order move the weights apart, Adam's sign-like
# first steps amplify it), and the refresh against its formula restated here
# (check_refresh).  Then test_dice --norm batch from the checkpoint, with and
# without --eval, each against the plain path.  Limits to be set from the
# first reading.
BATCHNORM_ITERS = 4
BATCHNORM_ARGS = [{"instance": "batch"}.get(a, a) for a in TRAIN_ARGS]
# First reading on an H100 at seed 0: the running statistics 8.5e-4, 2.4e-3,
# 4.5e-3 and 7.1e-3 off the plain model's after steps 1-4 (Adam's sign-like
# steps move the two models' weights apart by ~lr a step wherever a gradient
# entry is near zero); test_dice against the plain bf16 path max 768 / mean
# 46.2 LSB on the tile batch's statistics (each batch of two 140^3 tiles
# normalised by itself), 256 / 8.03 on the running ones (--eval).  Limits at
# about four times the statistics' last reading, and two times the LSB ones
BATCHNORM_STATS_REL = 0.03
BATCHNORM_KP = {False: (1536, 96.0), True: (512, 16.0)}
# The refresh restated: each batch norm's buffers after the step against
# 0.9 x before + 0.1 x the biased statistics (float64) of the input it saw in
# the refresh pass; f32 against float64 sums
REFRESH_REL = 1e-5
# Zoo nets: every define_G / define_D name no other phase runs, at its
# factory width, forward and backward (a fixed random cotangent), the kernel
# build and the plain build on the same weights and input, each in bf16 and
# f32: relative L2 of the output and of all gradients (the input's and the
# parameters') pooled.  3D generators on 64^3 (linearkernel_LK31 at 48^3:
# its k31 conv), the ResNets at 256^2, VGG16 at 2 x 224^2, the
# discriminators at Athena's probe shape (128 slices of 128^2).  f32, kernels
# against plain: the output within ZOO_F32_OUT (the norm kernels sum in
# another order, ~1e-7 relative per norm), the gradients within ZOO_F32_GRAD
# (a ReLU mask flips where the outputs differ by that much, and moves the
# gradients below it: ResNet-6's 1.4e-3 in the first reading on an H100).
# bf16: the kernels' output and gradients against the plain f32 ones no
# worse than the plain bf16 build's, by the step check's rule
# (STEP_GRAD_RATIO, STEP_GRAD_ABS): ResNet-6's bf16 gradients are 0.135 off
# the plain bf16 ones, as two bf16 runs that round in other places are.
ZOO_G = [("unet_twoouts", (1, 64, 64, 64, 1)), ("linearkernel", (1, 64, 64, 64, 1)),
         ("linearkernel_double", (1, 64, 64, 64, 1)), ("linearkernel_LK31", (1, 48, 48, 48, 1)),
         ("linearkernel_NC", (1, 64, 64, 64, 1)), ("fixed_kernel", (1, 64, 64, 64, 1)),
         ("resnet_6blocks", (1, 256, 256, 1)), ("resnet_9blocks", (1, 256, 256, 1)),
         ("VGG", (2, 224, 224, 1))]
ZOO_D = ["basic_SN", "n_layers", "n_layers_SN", "pixel", "kernelGAN"]
ZOO_D_SHAPE = (ATHENA_CROP, ATHENA_CROP, ATHENA_CROP, 1)
ZOO_F32_OUT, ZOO_F32_GRAD = 1e-4, 1e-2
# The spectral norm restated (three power iterations from the stored u, in
# float64) against Conv.spectral_weight; u must not move
SPECTRAL_REL = 1e-5
# ResnetGenerator's k3 stride-2 transposed convs restated as the scatter of
# nn.ConvTranspose2d(padding=1, output_padding=1), f32 sums
TRANSPOSE_REL = 1e-5

# dp: data parallelism on the one card.  NCCL at a world of one through the
# real launcher (python -m torch.distributed.run --nproc_per_node 1 -m
# neuroclear_tpu_torch.train_onecube) with the train phase's command for
# DP_ITERS steps, against two plain runs of it; then two ranks of this
# script over gloo on cuda:0 (NCCL refuses two ranks on one card; gloo
# all-reduces CUDA tensors through the host): the train phase's Apollo step,
# the batchnorm phase's flags in f32 (TF32 off), the athena phase's Athena
# command from its trained nets, and the slice's tile pipeline sharded over
# the ranks.  The data-parallel step against the single-process
# --grad_accum 2 step from the same seed, crops and draws: bitwise (two
# addends commute; the division is the accumulator's), else no farther than
# a rerun of it.  Batch norm over the ranks against the single-process
# batched step on torch.cat of the two crops: 1e-5 relative L2 per net
# (the prediction; only the order of f32 sums differs, the CPU test measured
# at most 1.5e-6), G_A within the step's usual 1e-2 (its ReLU masks flip on
# the sums' last bits: 8.5e-4 on the CPU), the refreshed running statistics
# within 1e-5; the limits below.  The sharded pipeline against one card: DP_LSB (only the
# f32 order in which the ranks' deltas join changes; JAX's own bound,
# tests/test_dicing_assemble.py:140).  The batch-norm limits are set from the
# first reading on an H100 at seed 0, where the prediction (1e-5 per net)
# held for the losses (1.8e-6) and the refresh (3.8e-8) but not for the
# gradients: G_B and the discriminators 8.2e-5 to 1.05e-3 (D_B_lateral), G_A
# 5.5e-3, against 1.5e-6 and 8.5e-4 on the CPU (the ranks' convs run at
# batch one, the reference's at batch two; not isolated further).  Limits at
# about five and four times those; per-rank statistics move G_B alone by 3e-2
# and the rest by 0.5-1.2 (CPU).
DP_ITERS, DP_WORLD, DP_TIMEOUT_S = 4, 2, 400
DP_TASKS = ("apollo", "batchnorm", "athena", "dice")
DP_BN_ARGS = [*BATCHNORM_ARGS, "--precision", "float32"]
DP_BN_ITERS, DP_ATHENA_ITERS = 2, 2
DP_BN_LOSS_REL, DP_BN_REFRESH_REL = 1e-5, 1e-5
DP_BN_GRAD_REL, DP_BN_G_A_REL = 5e-3, 2e-2
DP_LSB = 1
# --norm batch in f32: no instance norm, and the W-pair conv's gate is
# bf16-only, so no hand kernel launches
F32_BATCHNORM_STEP_LAUNCHES = {k: 0 for k in STEP_LAUNCHES}

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


def device_operations(fn, tries: int = 3) -> list:
    """The device rows (name, ms, count) of one call of a warm ``fn`` under
    torch.profiler.  A trace with no device row at all is the profiler's
    failure, not the call's (an H100 machine's CUPTI tracing once came up
    empty on the first profile of a run): it is taken again, up to
    ``tries`` times, and an empty last trace is returned as it is."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        rows = _device_rows(prof)
        if rows:
            break
        log(f"  the profiler traced no device operation (try {attempt + 1} of {tries})")
    return rows


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


def plain_outputs(flat: dict, vol: np.ndarray, dev, precisions, netG: str = "unet_deconv",
                  norm: str = "instance", border: int = 10, eval_stats: bool = False,
                  roi: int = 120, overlap: int = 15) -> tuple[dict, dict]:
    """The slice's tile pipeline (dice ``roi``, ``overlap``, ``border``) with
    ``netG``/``norm`` on the plain versions, on the card, batch norms on
    their running statistics when ``eval_stats``: {precision: int64 output}
    and {precision: seconds}; no kernel may launch."""
    vp = pad_for_dicing(vol, roi, overlap)
    grid = DiceGrid(vp.shape, roi, overlap, border)
    plain = define_G(1, 1, 64, netG, norm, plain=True)
    plain.load_state_dict(params_from_numpy(flat, plain))
    plain.to(dev)
    norms.set_eval(plain, eval_stats)
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


def dice_batches(shape, roi: int = 120, overlap: int = 15, border: int = 10,
                 tile_batch: int = 2) -> int:
    """Tile batches of the fused pipeline over a volume of ``shape``: each
    z slab's tiles in batches of ``tile_batch``."""
    grid = DiceGrid(pad_for_dicing(np.zeros(shape, np.uint8), roi, overlap).shape, roi,
                    overlap, border)
    return grid.z_steps * -(-(grid.y_steps * grid.x_steps) // tile_batch)


def eval_launches(shape, **dice) -> dict:
    """One study eval's launches (the fused tile pipeline in bf16)."""
    return pipeline_launches(dice_batches(shape, **dice))


def generate_quality_volumes(data: str, size: int) -> tuple:
    """The study's volumes through the port's CLI, as the driver generates
    them (``--size 700 --seed 0`` then ``GEN_FLAGS``); (seconds, the trio's
    digest, the input volume)."""
    t0 = time.perf_counter()
    generate_synthetic.main(["--out", data, "--size", "700", "--seed", "0", "--preset", "s4",
                             "--size", str(size)])
    secs = time.perf_counter() - t0
    trio = [tiffio.imread(os.path.join(data, sub, name))
            for sub, name in generate_synthetic.FILES]
    return secs, synthetic.digest(trio), trio[0]


def quality_logs(logd: str) -> dict:
    """The driver's logs: the segments, the evals in order, each eval's
    metrics, inference seconds and both protocol blocks, each diagnosis'
    rows, the selection, and the trainer's step seconds."""
    text = open(os.path.join(logd, "driver.log")).read()
    out = {"segments": re.findall(r"=== segment (\d+) from iter (\d+)", text),
           "evals": [int(m) for m in re.findall(r"--- (?:final )?eval at (\d+)", text)],
           "metrics": {}, "eval_s": {}, "diag": {}, "blocks": {}}
    for it in sorted(set(out["evals"])):
        path = os.path.join(logd, f"eval_{it}.log")
        ev = open(path).read()
        out["metrics"][it] = select_checkpoint.parse_eval_log(path)
        out["blocks"][it] = (ev.count("Network Input vs. Groundtruth"),
                             ev.count("Network Output vs. Groundtruth"), ev.count("(ssim: "))
        out["eval_s"][it] = float(re.search(r"Inference\+assembly: ([0-9.]+)s", ev).group(1))
        diag = open(os.path.join(logd, f"diag_{it}.log")).read().splitlines()
        out["diag"][it] = [ln for ln in diag if ln.split(":")[0].strip() in
                           ("gt", "input", "output")]
    out["selected"] = open(os.path.join(logd, "selected.txt")).read()
    train = open(os.path.join(logd, "train.log")).read()
    out["step_s"] = [s for ln in re.findall(r"step seconds \(device clock\): (\[.*\])", train)
                     for s in json.loads(ln)]
    return out


def check_quality_logs(q: dict, launches: dict, vol_shape) -> dict:
    """The study's run: two segments from the bank, every eval with both
    protocol blocks and its diagnosis, the selection the argmax, and the
    launches exactly four steps' and three evals'."""
    bad = []
    if q["segments"] != [("1", str(STUDY_LOAD_ITER)), ("2", str(STUDY_LOAD_ITER + 3))]:
        bad.append(f"segments {q['segments']}")
    if q["evals"] != [*QUALITY_EVALS, QUALITY_EVALS[-1]]:
        bad.append(f"evals {q['evals']}")
    for it, blocks in q["blocks"].items():
        m = q["metrics"][it]
        if blocks != (1, 1, 2) or m is None or not all(
                math.isfinite(m[k]) for k in ("input_psnr", "output_psnr", "output_ssim")):
            bad.append(f"eval {it}: blocks {blocks}, metrics {m}")
        if len(q["diag"][it]) != 3:
            bad.append(f"diagnosis {it}: rows {q['diag'][it]}")
    n_steps, n_evals = 4, len(q["evals"])
    per_eval = eval_launches(vol_shape)
    expected = {k: n_steps * REMAT_STEP_LAUNCHES[k] + n_evals * per_eval[k]
                for k in kernel_ops.KERNELS}
    if launches != expected:
        bad.append(f"launches {launches} != {expected}")
    if len(q["step_s"]) != n_steps:
        bad.append(f"step seconds {q['step_s']}")
    if bad:
        raise AssertionError(f"the quality study: {bad}")
    return {"per_eval": per_eval, "expected": expected}


def argmax_iteration(rows) -> int:
    """The iteration of the best output PSNR, the earlier on a tie (the
    selection rule, restated)."""
    best = max(m["output_psnr"] for _, m in rows)
    return min(it for it, m in rows if m["output_psnr"] == best)


def check_selection(logd: str, tmp: str) -> int:
    """The study's ``selected.txt`` names the argmax of its eval logs; and
    ``select_checkpoint --write`` on a copy of those logs with their
    iterations reassigned so that the best PSNR is the earliest (the newest
    is then not the argmax) names that one.  Returns the study's argmax."""
    rows = select_checkpoint.scan(logd)
    best = argmax_iteration(rows)
    selected = open(os.path.join(logd, "selected.txt")).read()
    bad = [] if selected.startswith(f"selected: iter {best} ") else [
        f"selected {selected!r}, argmax {best}"]
    texts = {it: open(os.path.join(logd, f"eval_{it}.log")).read() for it, _ in rows}
    ranked = sorted(rows, key=lambda r: -r[1]["output_psnr"])
    perm = os.path.join(tmp, "permuted_logs")
    os.makedirs(perm)
    for it, (src, _) in zip(sorted(texts), ranked):
        with open(os.path.join(perm, f"eval_{it}.log"), "w") as f:
            f.write(texts[src])
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        select_checkpoint.main([perm, "--write"])
    want = argmax_iteration(select_checkpoint.scan(perm))
    got = open(os.path.join(perm, "selected.txt")).read()
    if not got.startswith(f"selected: iter {want} "):
        bad.append(f"on the permuted logs selected {got!r}, argmax {want}")
    if bad:
        raise AssertionError(f"the selection: {bad}")
    return best


def check_quality_volumes(data: str) -> tuple:
    """The study's volumes generated on the card's host, their digest
    required the CPU's (``SYNTH_S4_300``); (seconds, digest, input volume)."""
    gen_s, digest, vol = generate_quality_volumes(data, QUALITY_SIZE)
    log(f"  generated {QUALITY_SIZE}^3 --preset s4 --seed 0 in {gen_s:.1f} s on the host: "
        f"sha256 {digest} ({'equal to' if digest == SYNTH_S4_300 else 'DIFFERENT from'} the "
        "CPU's)")
    if digest != SYNTH_S4_300:
        raise AssertionError(f"the generated trio's digest {digest} != {SYNTH_S4_300}")
    return gen_s, digest, vol


def quality_bank(tmp: str) -> str:
    """A bank of the study's iteration 11000 (``QUALITY_KNOBS``' comment):
    links to its files, and a fresh Adam's optimizer file where the
    checkout lacks the study's."""
    bank = os.path.join(tmp, "bank")
    os.makedirs(bank)
    for f in os.listdir(STUDY_STATE):
        os.symlink(os.path.join(STUDY_STATE, f), os.path.join(bank, f))
    optim = os.path.join(bank, f"iter_{STUDY_LOAD_ITER}_optim.npz")
    if not os.path.exists(optim):
        opt = train_options.build_parser().parse_args(["--dataroot", "unused", *STUDY_ARGS])
        model = ApolloModel(opt, "cpu")
        model.lr_controllers = [LRController(opt.lr_policy, opt) for _ in range(2)]
        atomic_savez(optim, model.optim_arrays())
        log(f"  {optim} written: a fresh Adam (the study's is not in this checkout)")
    return bank


def quality_accum_three_ways(data: str, bank: str, tmp: str, dev, seed: int) -> dict:
    """One accum-2 step of the study command from the bank three ways:
    crops from host windows (JAX's default), from the device volume
    (``NEUROCLEAR_ACCUM_DEVICE_VOL=1``), and cut first and resident together
    (``--fused_accum``), each run's peak device memory; the fused run
    bitwise the device-volume run, the host windows' crops within JAX's
    border bound of the device volume's (bit for bit expected); and the
    host-window crop's seconds."""
    ckpt = os.path.join(tmp, "accum_ckpt")
    os.makedirs(os.path.join(ckpt, QUALITY_NAME))
    for f in os.listdir(bank):
        os.symlink(os.path.realpath(os.path.join(bank, f)), os.path.join(ckpt, QUALITY_NAME, f))
    k = run_quality_study.knobs({**QUALITY_KNOBS, "BANK": bank})
    argv = [*run_quality_study.train_flags(k, data, ckpt), "--continue_train", "--load_iter",
            str(STUDY_LOAD_ITER), "--max_iters", "1", "--grad_accum", "2", "--no_html",
            "--save_latest_freq", "1000000"]
    runs = {}
    for label, extra, env in (("host windows", [], None),
                              ("device volume", [], "1"),
                              ("fused", ["--fused_accum"], None)):
        with _env("NEUROCLEAR_ACCUM_DEVICE_VOL", env):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            kernel_ops.reset_launches()
            res = train_onecube.main([*argv, *extra])
            torch.cuda.synchronize()
            runs[label] = {"res": res, "launches": kernel_ops.launches(),
                           "peak_gib": (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30,
                           "step_ms": 1e3 * res["step_seconds"][0]}
    expected = {kk: 2 * v for kk, v in REMAT_STEP_LAUNCHES.items()}
    bad = [f"{label} launches {r['launches']}" for label, r in runs.items()
           if r["launches"] != expected]
    forms = {label: r["res"]["form"] for label, r in runs.items()}
    if forms != {"host windows": "host windows, per crop",
                 "device volume": "device volume, per crop",
                 "fused": "device volume, resident batch"}:
        bad.append(f"forms {forms}")
    if runs["host windows"]["res"]["dataset"].uploaded:
        bad.append("the host-window run uploaded the volume")
    fused, per_crop = runs["fused"]["res"], runs["device volume"]["res"]
    diffs = _model_state_diffs(fused["model"], per_crop["model"])
    if diffs or fused["losses"] != per_crop["losses"]:
        bad.append(f"fused against the device volume: {diffs[:4]} losses {fused['losses']} "
                   f"{per_crop['losses']}")
    hw_same = (not _model_state_diffs(runs["host windows"]["res"]["model"], per_crop["model"])
               and runs["host windows"]["res"]["losses"] == per_crop["losses"])

    # the crops themselves, the step's and more, host window against device volume
    ds = per_crop["dataset"]
    gen = torch.Generator().manual_seed(seed + 11)
    draws = [ds.draws(gen) for _ in range(QUALITY_CROP_DRAWS)]
    worst_share, worst_median, unequal = 0.0, 0.0, 0
    for d in draws:
        a, b = ds.window_crop(*d), ds.crop(*d)
        diff = (a - b).abs()
        worst_share = max(worst_share, float((diff > 1e-4).float().mean()))
        worst_median = max(worst_median, float(diff.median()))
        unequal += not torch.equal(a, b)
    if not (worst_share < 0.005 and worst_median < 2e-5):
        bad.append(f"host-window crops off the device volume's: share {worst_share}, "
                   f"median {worst_median}")
    # host seconds per crop: the window's plan, slice and upload, then the
    # gather, each crop to the end of its gather
    times = []
    for d in draws[:8]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ds.window_crop(*d)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    host_s = []
    for d in draws[:8]:
        t0 = time.perf_counter()
        host_window(ds, d)
        host_s.append(time.perf_counter() - t0)
    log("  accum-2 study step three ways: " + "; ".join(
        f"{label} ({r['res']['form']}) {r['step_ms']:.1f} ms, peak {r['peak_gib']:.3f} GiB "
        "above the memory held before it"
        for label, r in runs.items()))
    log(f"  fused against the device volume: "
        f"{'bitwise equal' if not diffs else 'DIFFERENT'}; host windows against the device "
        f"volume: step {'bitwise equal' if hw_same else 'different'}; {len(draws)} crops, "
        f"{unequal} not bitwise, worst share off by > 1e-4 {worst_share:.3g}, worst median "
        f"{worst_median:.3g}; a host-window crop {1e3 * float(np.median(times)):.2f} ms to "
        f"the end of its gather, of which the window's plan and host slice "
        f"{1e3 * float(np.median(host_s)):.2f} ms (medians of 8, 148^3 crops, window "
        f"{window_plan(ds.shape, draws[0][0], draws[0][1], ds.crop_size)})")
    if bad:
        raise AssertionError(f"the accum-2 study step three ways: {bad}")
    out = {label: {kk: r[kk] for kk in ("peak_gib", "step_ms")} for label, r in runs.items()}
    del runs, fused, per_crop
    torch.cuda.empty_cache()
    return {"runs": out, "crop_ms": 1e3 * float(np.median(times)),
            "host_ms": 1e3 * float(np.median(host_s)), "unequal": unequal,
            "hw_step_equal": hw_same}


def host_window(ds, draw) -> np.ndarray:
    """The host part of a host-window crop: its plan and the window sliced
    into the upload dtype."""
    plan = window_plan(ds.shape, draw[0], draw[1], ds.crop_size)
    return np.ascontiguousarray(ds.host_vol[tuple(slice(*r) for r in plan)], np.int32)


@contextlib.contextmanager
def _env(name: str, value):
    """``name`` set to ``value`` (unset for None) inside the block."""
    old = os.environ.pop(name, None)
    if value is not None:
        os.environ[name] = value
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if old is not None:
            os.environ[name] = old


def run_quality(seed: int, dev, tmp: str) -> dict:
    """The quality study on the card: the 300^3 s4 volumes (digest against
    the CPU's), the port's driver (``run_quality_study --inprocess``) from
    the bank, its logs checked (``check_quality_logs``) with the launches of
    the whole study; then ``quality_accum_three_ways``."""
    data = os.path.join(tmp, "data")
    gen_s, digest, vol = check_quality_volumes(data)
    logd = os.path.join(tmp, "log")
    bank = quality_bank(tmp)
    environ = {**QUALITY_KNOBS, "RESULTS": os.path.join(tmp, "results"), "BANK": bank}
    kernel_ops.reset_launches()
    t0 = time.perf_counter()
    rc = run_quality_study.main([data, os.path.join(tmp, "ckpt"), logd, "--inprocess"],
                                environ=environ)
    secs = time.perf_counter() - t0
    launches = kernel_ops.launches()
    if rc != 0:
        tail = open(os.path.join(logd, "driver.log")).read()[-2000:]
        raise AssertionError(f"the study driver exited {rc}: {tail}")
    q = quality_logs(logd)
    chk = check_quality_logs(q, launches, vol.shape)
    chk["best"] = check_selection(logd, tmp)
    step_ms = [1e3 * s for s in q["step_s"]]
    log(f"  driver {secs:.1f} s: segments {q['segments']}, evals {q['evals']}; launches "
        f"{launches} (per step {REMAT_STEP_LAUNCHES}, per eval {chk['per_eval']}, "
        f"{dice_batches(vol.shape)} tile batches)")
    log("  step ms (148^3, bf16, --remat, from the bank): "
        + ", ".join(f"{t:.1f}" for t in step_ms) + "; eval s (inference and assembly): "
        + ", ".join(f"{it} {s:.3f}" for it, s in q["eval_s"].items()))
    for it, m in q["metrics"].items():
        log(f"  eval {it}: input psnr {m['input_psnr']:.4f}, output psnr "
            f"{m['output_psnr']:.4f} ssim {m['output_ssim']:.4f}; diagnosis: "
            + " | ".join(q["diag"][it]))
    log(f"  {q['selected'].strip()}")
    three = quality_accum_three_ways(data, bank, tmp, dev, seed)
    return {"launches": launches, "digest": digest, "gen_s": gen_s, "driver_s": secs,
            "step_ms": step_ms, "eval_s": q["eval_s"], "metrics": q["metrics"],
            "best": chk["best"], "per_eval": chk["per_eval"], **three}


# docs/QUALITY.md's round-4 eval of iteration 11000 of the s4 study (the
# 700^3 --preset s4 --seed 0 volume, the full protocol): (PSNR, SSIM) of the
# input and of the output against the ground truth, to the table's digits
QUALITY_700 = {"input": (21.49, 0.459), "output": (19.86, 0.446)}


def run_quality700(tmp: str) -> dict:
    """``--quality700``: the JAX study's eval of its iteration 11000 redone
    in the port: the 700^3 s4 volumes regenerated, ``test_dice`` with the
    study's eval flags on ``study_state/apollo148s4`` in bf16 and in f32;
    the input row (which no net touches) must print docs/QUALITY.md's to its
    digits; the output rows are printed beside its."""
    data = os.path.join(tmp, "sim700")
    gen_s, digest, vol = generate_quality_volumes(data, size=700)
    log(f"  generated 700^3 --preset s4 --seed 0 in {gen_s:.1f} s on the host: sha256 {digest}")
    rows, bad = {}, []
    for precision in ("bfloat16", "float32"):
        k = run_quality_study.knobs({"NAME": QUALITY_NAME, "RESULTS": os.path.join(tmp, precision),
                                     "EVAL_FLAGS": f"--precision {precision}"})
        argv = run_quality_study.eval_flags(k, data, os.path.dirname(STUDY_STATE),
                                            STUDY_LOAD_ITER)
        kernel_ops.reset_launches()
        t0 = time.perf_counter()
        res = test_dice.main(argv)
        secs = time.perf_counter() - t0
        launches = kernel_ops.launches()
        m = res["metrics"]
        rows[precision] = {**m, "seconds": secs, "inference_s": res["seconds"],
                           "launches": launches}
        ref_in, ref_out = QUALITY_700["input"], QUALITY_700["output"]
        log(f"  {precision}: input psnr {m['psnr_input']:.4f} ssim {m['ssim_input']:.4f} "
            f"(docs/QUALITY.md {ref_in[0]} / {ref_in[1]}); output psnr {m['psnr_output']:.4f} "
            f"ssim {m['ssim_output']:.4f} (docs/QUALITY.md {ref_out[0]} / {ref_out[1]}: "
            f"{m['psnr_output'] - ref_out[0]:+.4f} dB, {m['ssim_output'] - ref_out[1]:+.4f}); "
            f"{secs:.1f} s in all, inference and assembly {res['seconds']:.3f} s; launches "
            f"{launches}")
        if (round(m["psnr_input"], 2), round(m["ssim_input"], 3)) != ref_in:
            bad.append(f"{precision} input row {m['psnr_input']:.4f} / {m['ssim_input']:.4f}")
        if precision == "bfloat16" and launches != eval_launches(vol.shape):
            bad.append(f"launches {launches} != {eval_launches(vol.shape)}")
        del res
    if bad:
        raise AssertionError(f"the 700^3 eval: {bad}")
    return rows


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
    res = train_phase("dryops", DRYOPS_ARGS, DRYOPS_ITERS, DRYOPS_STEP_LAUNCHES, vol, tmp, seed)
    launches, step_ms = res["launches"], res["step_ms"]
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
    return dice_against_plain("trained G_A", TRAINED_G_A, synthetic_volume(seed), tmp, dev,
                              SLICE_ARGS, {"wconv3x3x3": 2, "pair_sums": 10,
                                           "affine_map_act": 10},
                              (TRAINED_KP_MAX_LSB, TRAINED_KP_MEAN_LSB))


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
    opt = test_options.build_parser().parse_args(["--dataroot", "unused", "--name", "smoke",
                                                  "--model_suffix", "_A"])
    model = test_dice.TestModel(opt, dev)
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


def profile_model_step(model, sample, crop: int, gen, dev) -> dict:
    """One warm step of ``model`` on ``sample(gen)`` timed on the host clock
    (synchronised), its peak device memory, and the same step under
    torch.profiler: device time and the device's idle share of the wall."""
    def step():
        model.optimize_parameters(sample(gen), model.draw_probes((crop,) * 3, gen))
        torch.cuda.synchronize()

    step()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    step()
    wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
    rows = _device_rows(prof)
    busy = sum(r[1] for r in rows)
    log(f"  warm step wall {wall:.1f} ms; device time {busy:.1f} ms (idle share "
        f"{max(0.0, 1 - busy / wall):.3f}); {sum(r[2] for r in rows)} device operations; "
        f"peak device memory {peak:.3f} GiB; by kernel: "
        + "; ".join(f"{ms:.2f} ms x{n} {key[:60]}" for key, ms, n in rows[:6]))
    return {"wall_ms": wall, "device_ms": busy, "idle": max(0.0, 1 - busy / wall),
            "peak_gib": peak}


def train_phase(label: str, args: list, iters: int, table: dict, vol: np.ndarray, tmp: str,
                seed: int) -> dict:
    """``train_onecube.main`` with ``args`` for ``iters`` steps on ``vol``
    (a TIFF): the launches exactly ``iters`` x ``table``, finite losses, the
    step median.  Returns the trainer's result with "launches", "step_ms"
    and the written G_A checkpoint ("g_a")."""
    data = os.path.join(tmp, f"{label}_data")
    tiffio.imwrite(os.path.join(data, "volume.tif"), vol)
    argv = ["--dataroot", data, "--name", label, "--checkpoints_dir",
            os.path.join(tmp, f"{label}_ckpt"), *args, "--max_iters", str(iters), "--seed",
            str(seed)]
    kernel_ops.reset_launches()
    res = train_onecube.main(argv)
    launches = kernel_ops.launches()
    expected = {k: iters * v for k, v in table.items()}
    log(f"  launches over {iters} steps {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    if not all(math.isfinite(v) for step in res["losses"] for v in step.values()):
        raise AssertionError(f"a {label} loss is not finite: {res['losses']}")
    res["launches"], res["step_ms"] = launches, _median_ms(res["step_seconds"])
    res["g_a"] = next(p for p in res["checkpoints"] if p.endswith("_net_G_A.npz"))
    log(f"  step ms: first {1e3 * res['step_seconds'][0]:.1f}, then "
        + ", ".join(f"{1e3 * t:.1f}" for t in res["step_seconds"][1:])
        + f"; median {res['step_ms']:.1f} ms")
    return res


def dice_against_plain(label: str, g_a: str, vol: np.ndarray, tmp: str, dev, argv: list,
                       per_batch: dict, limits: tuple, netG="unet_deconv", norm="instance",
                       border=10, eval_stats=False, roi=120, overlap=15) -> dict:
    """``test_dice.main`` with ``argv`` from the checkpoint ``g_a`` on
    ``vol`` (bf16, tile batch 2): launches exactly ``per_batch`` per tile
    batch; the output against the same pipeline on the plain versions in
    bf16 and f32 (``netG``/``norm``/``border``, batch norms on their running
    statistics when ``eval_stats``): no less accurate against f32 than the
    plain bf16 path (the slice's rule), within ``limits`` (max, mean LSB) of
    it."""
    d = os.path.join(tmp, label)
    os.makedirs(os.path.join(d, "data"))
    np.save(os.path.join(d, "data", "volume.npy"), vol)
    os.makedirs(os.path.join(d, "ckpt", "x"))
    os.symlink(g_a, os.path.join(d, "ckpt", "x", "iter_1_net_G_A.npz"))
    grid = DiceGrid(pad_for_dicing(vol, roi, overlap).shape, roi, overlap, border)
    batches = grid.z_steps * -(-(grid.y_steps * grid.x_steps) // 2)
    expected = {name: per_batch.get(name, 0) * batches for name in kernel_ops.KERNELS}
    kernel_ops.reset_launches()
    res = test_dice.main(["--dataroot", os.path.join(d, "data"), "--name", "x",
                          "--checkpoints_dir", os.path.join(d, "ckpt"), "--load_iter", "1",
                          "--model_suffix", "_A", "--results_dir", os.path.join(d, "results"),
                          *argv])
    launches = kernel_ops.launches()
    log(f"  {label}: {len(grid)} tiles of {roi + 2 * border}^3 in {batches} batches; launches "
        f"{launches}, expected {expected}; {res['seconds']:.3f} s")
    if launches != expected:
        raise AssertionError(f"{label}: launch counts {launches} != {expected}")
    out = res["fake"]
    if out.shape != vol.shape or out.dtype != np.uint16 or out.std() == 0:
        raise AssertionError(f"{label}: output {out.shape} {out.dtype} std {out.std()}")
    outs, _ = plain_outputs(load_npz(g_a), vol, dev, ("bfloat16", "float32"), netG, norm,
                            border, eval_stats, roi, overlap)
    ref = outs["float32"]
    p_err, k_err = lsb_stats(outs["bfloat16"], ref), lsb_stats(out, ref)
    kp = np.abs(out.astype(np.int64) - outs["bfloat16"])
    log(f"  {label} against the f32 plain output: kernels (bf16) {k_err}; plain (bf16) "
        f"{p_err}; kernels vs plain (bf16): max {int(kp.max())} LSB, mean "
        f"{float(kp.mean()):.3f} LSB (limits {limits[0]}, {limits[1]}); output mean "
        f"{out.mean():.1f} std {out.std():.1f}")
    if (k_err["mean_lsb"] > SLICE_MEAN_RATIO * p_err["mean_lsb"]
            or k_err["max_lsb"] > p_err["max_lsb"] + SLICE_MAX_EXTRA_LSB):
        raise AssertionError(f"{label}: kernels less accurate than the plain path: {k_err} vs "
                             f"{p_err}")
    if kp.max() > limits[0] or kp.mean() > limits[1]:
        raise AssertionError(f"{label}: kernels off the plain path: max {kp.max()}, mean "
                             f"{kp.mean()}")
    return {"launches": launches, "k_err": k_err, "p_err": p_err, "kp_max": int(kp.max()),
            "kp_mean": float(kp.mean()), "seconds": res["seconds"]}


def run_vanilla(seed: int, dev, tmp: str) -> dict:
    """Apollo with --netG unet_vanilla at 112^3 through ``train_onecube.main``:
    launches exact, the step median, a warm step's device time, idle share
    and peak; the three-way step (VANILLA_DIRECT); test_dice from its
    checkpoint against the plain path (VANILLA_KP_*)."""
    vol = synthetic_volume(seed + 30, VANILLA_VOLUME)
    res = train_phase("vanilla", VANILLA_ARGS, VANILLA_ITERS, VANILLA_STEP_LAUNCHES, vol, tmp,
                      seed)
    opt = train_options.build_parser().parse_args(["--dataroot", "unused", *VANILLA_ARGS])
    dataset = SingleVolumeDataset(vol, (VANILLA_CROP,) * 3, opt.preprocess, dev)
    gen = torch.Generator().manual_seed(seed + 33)
    prof = profile_model_step(res["model"], dataset.sample, VANILLA_CROP, gen, dev)
    out = {"launches": res["launches"], "step_ms": res["step_ms"], **prof}
    g_a = res["g_a"]
    del res
    torch.cuda.empty_cache()

    def make(plain, precision):
        opt.precision = precision
        model = ApolloModel(opt, dev, plain=plain)
        model.init_weights(seed)
        return model

    real = dataset.sample(gen)
    runs = model_three_ways(make, lambda model: (real, model.draw_probes((VANILLA_CROP,) * 3,
                                                                         gen)))
    out["pooled"] = report_three_ways(f"vanilla step at {VANILLA_CROP}^3, random weights", runs,
                                      VANILLA_DIRECT, LOSS_NAMES, D_NAMES)
    dice = dice_against_plain("vanilla dice", g_a, synthetic_volume(seed), tmp, dev,
                              VANILLA_DICE_ARGS, {"wconv3x3x3": 3, "pair_sums": 14,
                                                  "affine_map_act": 14},
                              (VANILLA_KP_MAX_LSB, VANILLA_KP_MEAN_LSB), "unet_vanilla",
                              border=12)
    out["dice"], out["dice_launches"] = dice, dice["launches"]
    return out


def _bn_buffers(model) -> list:
    return [(f"{n}.{name}", m) for n in model.model_names
            for name, m in model.nets[n].named_modules() if isinstance(m, norms.BatchNorm)]


def check_refresh(model, step) -> float:
    """Run ``step()`` (a training step of ``model``, ending in its
    batch-norm refresh) with every batch norm's input recorded, the last
    one per module being what the refresh pass fed it; then each module's
    buffers against 0.9 x their value before + 0.1 x that input's mean and
    biased variance over every axis but the channels, in float64.  Returns
    the largest relative error."""
    seen, hooks = {}, []
    for name, m in _bn_buffers(model):
        hooks.append(m.register_forward_pre_hook(
            lambda mod, args, name=name: seen.__setitem__(name, args[0].detach())))
    before = {name: (m.running_mean.double().clone(), m.running_var.double().clone())
              for name, m in _bn_buffers(model)}
    try:
        step()
    finally:
        for h in hooks:
            h.remove()
    worst = 0.0
    for name, m in _bn_buffers(model):
        x = seen[name].double().reshape(-1, seen[name].shape[-1])
        mean, var = x.mean(0), x.var(0, unbiased=False)
        want_m = 0.9 * before[name][0] + 0.1 * mean
        want_v = 0.9 * before[name][1] + 0.1 * var
        for got, want in ((m.running_mean, want_m), (m.running_var, want_v)):
            err = float((got.double() - want).norm() / want.norm().clamp(min=1e-30))
            worst = max(worst, err)
    if not worst <= REFRESH_REL:
        raise AssertionError(f"batch-norm refresh off its formula by {worst:.3g} (limit "
                             f"{REFRESH_REL})")
    return worst


def _stats_rel(a, b) -> float:
    num = sum(float(((ma.running_mean - mb.running_mean) ** 2).sum()
                    + ((ma.running_var - mb.running_var) ** 2).sum())
              for (_, ma), (_, mb) in zip(_bn_buffers(a), _bn_buffers(b)))
    den = sum(float((mb.running_mean ** 2).sum() + (mb.running_var ** 2).sum())
              for _, mb in _bn_buffers(b))
    return math.sqrt(num / den)


def batchnorm_lockstep(vol: np.ndarray, dev, seed: int, steps: int) -> list:
    """The kernel and plain bf16 models with --norm batch from the same
    weights, ``steps`` steps on the same crops and draws: after each, the
    kernel model's refresh against its formula (``check_refresh``) and
    every running statistic against the plain model's (relative L2).
    Returns the per-step (refresh error, relative L2)."""
    opt = train_options.build_parser().parse_args(["--dataroot", "unused", *BATCHNORM_ARGS])
    dataset = SingleVolumeDataset(vol, (CROP,) * 3, opt.preprocess, dev)
    models = {}
    for plain in (False, True):
        models[plain] = ApolloModel(opt, dev, plain=plain)
        models[plain].init_weights(seed)
    gen = torch.Generator().manual_seed(seed + 34)
    out = []
    for _ in range(steps):
        real, draws = dataset.sample(gen), models[False].draw_probes((CROP,) * 3, gen)
        refresh = check_refresh(models[False],
                                lambda: models[False].optimize_parameters(real, draws))
        models[True].optimize_parameters(real, draws)
        out.append((refresh, _stats_rel(models[False], models[True])))
    log("  lockstep against the plain model, per step (refresh against its formula, running "
        "statistics relative L2): " + "; ".join(f"{r:.3g}, {d:.4g}" for r, d in out)
        + f" (limits {REFRESH_REL}, {BATCHNORM_STATS_REL})")
    bad = [d for _, d in out if not d <= BATCHNORM_STATS_REL]
    if bad:
        raise AssertionError(f"running statistics off the plain path: {bad}")
    del models
    torch.cuda.empty_cache()
    return out


def batchnorm_dice(g_a: str, vol: np.ndarray, tmp: str, dev) -> dict:
    """test_dice --norm batch from ``g_a`` without and with --eval, each
    against the plain path with the same statistics (the tile batch's, or
    the running ones)."""
    out = {}
    for eval_stats in (False, True):
        label = "batchnorm dice" + (" --eval" if eval_stats else "")
        out[eval_stats] = dice_against_plain(
            label.replace(" ", "_"), g_a, vol, tmp, dev,
            [*SLICE_ARGS, "--norm", "batch", *(["--eval"] if eval_stats else [])],
            {"wconv3x3x3": 2}, BATCHNORM_KP[eval_stats], norm="batch", eval_stats=eval_stats)
    return out


def run_batchnorm(seed: int, dev, tmp: str) -> dict:
    """--norm batch at 108^3 through ``train_onecube.main``: only the W-pair
    conv launches, exactly; the lockstep running statistics; test_dice with
    and without --eval from its checkpoint."""
    vol = synthetic_volume(seed + 31, TRAIN_VOLUME)
    res = train_phase("batchnorm", BATCHNORM_ARGS, BATCHNORM_ITERS, BATCHNORM_STEP_LAUNCHES,
                      vol, tmp, seed)
    opt = train_options.build_parser().parse_args(["--dataroot", "unused", *BATCHNORM_ARGS])
    dataset = SingleVolumeDataset(vol, (CROP,) * 3, opt.preprocess, dev)
    prof = profile_model_step(res["model"], dataset.sample, CROP,
                              torch.Generator().manual_seed(seed + 35), dev)
    out = {"launches": res["launches"], "step_ms": res["step_ms"], **prof}
    g_a = res["g_a"]
    del res
    torch.cuda.empty_cache()
    out["lockstep"] = batchnorm_lockstep(vol, dev, seed, BATCHNORM_ITERS)
    out["dice"] = batchnorm_dice(g_a, synthetic_volume(seed), tmp, dev)
    out["dice_launches"] = {k: v + out["dice"][True]["launches"][k]
                            for k, v in out["dice"][False]["launches"].items()}
    return out


def spectral_reference(w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``_spectral_normalise`` of the JAX package restated in float64: three
    power iterations from ``u`` on the (out, in * k * k) weight matrix, w /
    sigma."""
    wm = w.double().reshape(w.shape[0], -1)
    u = u.double()
    for _ in range(3):
        v = wm.t() @ u
        v = v / (v.norm() + 1e-12)
        u = wm @ v
        u = u / (u.norm() + 1e-12)
    return w.double() / (u @ (wm @ v))


def check_spectral(net) -> float:
    """Every spectral conv of ``net`` against ``spectral_reference`` (after
    a forward and backward of the net, which must leave ``u`` as it was)."""
    convs = [m for m in net.modules() if getattr(m, "spectral", False)]
    if not convs:
        raise AssertionError("no spectral conv")
    worst = 0.0
    for conv in convs:
        u0 = conv.u.clone()
        got = conv.spectral_weight().detach()
        want = spectral_reference(conv.weight.detach(), u0)
        worst = max(worst, float((got.double() - want).norm() / want.norm()))
        if not torch.equal(conv.u, u0):
            raise AssertionError("the spectral norm moved its u")
    if not worst <= SPECTRAL_REL:
        raise AssertionError(f"spectral norm off the restated one by {worst:.3g}")
    return worst


def check_resnet_transpose(dev, seed: int) -> float:
    """ResnetGenerator's first upsampling (256 -> 128 channels, k3 stride 2,
    on a 64^2 map) against the scatter of nn.ConvTranspose2d(padding=1,
    output_padding=1) restated tap by tap: out[2i + a - 1, 2j + b - 1] +=
    x[i, j] @ w[:, :, a, b]."""
    net = define_G(1, 1, 64, "resnet_9blocks", "instance")
    net.load_state_dict(params_from_numpy(init_flat(net, seed=seed), net))
    up = net.up0.to(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((1, 64, 64, 256), generator=g, device=dev)
    with torch.no_grad():
        got = up(x)
        w = up.weight  # (I, O, 3, 3)
        full = torch.zeros((1, 2 * 64 + 1, 2 * 64 + 1, w.shape[1]), device=dev)
        for a in range(3):
            for b in range(3):
                full[:, a:a + 128:2, b:b + 128:2] += x @ w[:, :, a, b]
        want = full[:, 1:, 1:] + up.bias
    err = float((got - want).norm() / want.norm())
    if not err <= TRANSPOSE_REL:
        raise AssertionError(f"ResnetGenerator's transposed conv off the restated scatter by "
                             f"{err:.3g}")
    return err


def _zoo_pair(kind: str, name: str, seed: int, dev):
    """The kernel and plain builds of one zoo net with the same weights."""
    nets = []
    for plain in (False, True):
        net = (define_G(1, 1, 64, name, "instance", plain=plain) if kind == "G"
               else define_D(1, 64, name, 3, "instance", plain=plain))
        if name == "fixed_kernel":
            r = np.random.default_rng(seed).random((9, 9, 9)).astype(np.float32)
            net.init_from_psf(r / r.sum())
        net.load_state_dict(params_from_numpy(init_flat(net, seed=seed), net))
        nets.append(net.to(dev))
    return nets


def _forward_backward(net, x, cot_seed: int):
    """The outputs and the gradients (input's, then the parameters') of the
    sum of the outputs times fixed random cotangents."""
    x = x.detach().requires_grad_(True)
    outs = net(x)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator(device=x.device).manual_seed(cot_seed)
    loss = sum((o.float() * torch.randn(o.shape, generator=g, device=x.device)).sum()
               for o in outs)
    params = [p for p in net.parameters()]
    grads = torch.autograd.grad(loss, [x, *params])
    return [o.detach().float() for o in outs], [q.float() for q in grads]


def _pooled_rel(a: list, b: list) -> float:
    num = sum(float(((p - q) ** 2).sum()) for p, q in zip(a, b))
    return math.sqrt(num / max(sum(float((q ** 2).sum()) for q in b), 1e-30))


def run_zoo(seed: int, dev) -> dict:
    """Every zoo net no other phase runs: the kernel build against the
    plain build in f32 (ZOO_F32_*) and against the plain f32 build in bf16
    no worse than the plain bf16 build; which kernels each launched; the
    spectral norm and ResNet's transposed convs against their
    restatements; the fixed kernel's noise in [0, 1].  Every net runs
    before a failure is raised."""
    report, bad = {}, []
    cases = [("G", n, shape) for n, shape in ZOO_G] + [("D", n, ZOO_D_SHAPE) for n in ZOO_D]
    for i, (kind, name, shape) in enumerate(cases):
        nets = dict(zip(("kernels", "plain"), _zoo_pair(kind, name, seed + i, dev)))
        g = torch.Generator(device=dev).manual_seed(seed + i)
        x = torch.rand(shape, generator=g, device=dev)
        runs, counts = {}, {}
        for precision, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            for build_, net in nets.items():
                before = kernel_ops.launches()
                runs[build_, precision] = _forward_backward(net, x.to(dtype), seed)
                torch.cuda.synchronize()
                launched = {k: v - before[k] for k, v in kernel_ops.launches().items()
                            if v != before[k]}
                if build_ == "plain" and launched:
                    bad.append(f"{name}: the plain build launched {launched}")
                if build_ == "kernels":
                    counts[precision] = launched
                if not all(torch.isfinite(t).all() for part in runs[build_, precision]
                           for t in part):
                    bad.append(f"{name} ({build_}, {precision}): not finite")

        def rel(a, b, part):
            return _pooled_rel(runs[a][part], runs[b][part])

        f32 = [rel(("kernels", "float32"), ("plain", "float32"), p) for p in (0, 1)]
        k16 = [rel(("kernels", "bfloat16"), ("plain", "float32"), p) for p in (0, 1)]
        p16 = [rel(("plain", "bfloat16"), ("plain", "float32"), p) for p in (0, 1)]
        report[name] = {"f32": f32, "k16": k16, "p16": p16, "launches": counts}
        log(f"  {name} {tuple(shape)}: f32 kernels against plain (output, gradients) "
            f"{f32[0]:.3g}, {f32[1]:.3g}; bf16 against plain f32, kernels {k16[0]:.3g}, "
            f"{k16[1]:.3g} / plain {p16[0]:.3g}, {p16[1]:.3g}; hand kernels launched (forward "
            f"and backward, bf16 / f32) {counts.get('bfloat16')} / {counts.get('float32')}")
        if not (f32[0] <= ZOO_F32_OUT and f32[1] <= ZOO_F32_GRAD):
            bad.append(f"{name} (f32): kernels off plain by {f32[0]:.3g}, {f32[1]:.3g}")
        for part, label in ((0, "output"), (1, "gradients")):
            if not k16[part] <= STEP_GRAD_RATIO * p16[part] + STEP_GRAD_ABS:
                bad.append(f"{name} (bf16 {label}): kernels {k16[part]:.3g} off f32, plain "
                           f"{p16[part]:.3g}")
        if name.endswith("_SN"):
            report[name]["spectral"] = check_spectral(nets["kernels"])
        if name == "fixed_kernel":
            with torch.no_grad():
                y = nets["kernels"](x, generator=torch.Generator(device=dev).manual_seed(seed))
            if float(y.min()) != 0.0 or float(y.max()) != 1.0:
                bad.append(f"fixed_kernel noise out of [0, 1]: {y.min()}, {y.max()}")
        del nets, runs
        torch.cuda.empty_cache()
    report["transpose"] = check_resnet_transpose(dev, seed)
    log(f"  spectral norms against the restated one: "
        + ", ".join(f"{n} {report[n]['spectral']:.3g}" for n in ZOO_D if n.endswith("_SN"))
        + f"; ResNet's transposed conv against the restated scatter {report['transpose']:.3g}")
    if bad:
        raise AssertionError("zoo nets: " + "; ".join(bad))
    return {"nets": report}


# ------------------------------------------------------------------------ dp


def _torchrun(nproc: int, target: list, timeout: float, label: str) -> str:
    """``python -m torch.distributed.run --standalone --nproc_per_node
    nproc`` on ``target`` from the repo's root; its standard output (the
    output's tail raises on a nonzero exit).  ``--standalone`` takes a free
    port; a hang is killed at ``timeout`` seconds."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", str(nproc), *target], cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{label} exited {proc.returncode}:\n{proc.stdout[-6000:]}\n"
                             f"{proc.stderr[-8000:]}")
    return proc.stdout


def _ckpt_arrays(ckpt_dir: str, suffix: str) -> dict:
    """Every array of the ``suffix`` checkpoint (nets and optimizer)."""
    out = {}
    for f in sorted(os.listdir(ckpt_dir)):
        if f.startswith(suffix + "_") and f.endswith(".npz"):
            with np.load(os.path.join(ckpt_dir, f)) as data:
                out.update({f"{f}:{k}": data[k] for k in data.files})
    return out


def _max_abs(a: dict, b: dict) -> float:
    if set(a) != set(b):
        raise AssertionError(f"checkpoints with different arrays: {sorted(set(a) ^ set(b))}")
    worst = 0.0
    for k in a:
        if np.array_equal(a[k], b[k], equal_nan=True):  # the schedules hold an inf
            continue
        d = np.abs(a[k].astype(np.float64) - b[k].astype(np.float64))
        worst = max(worst, float(np.where(np.isfinite(d), d, np.inf).max()))
    return worst


def _logged_losses(ckpt_dir: str) -> list:
    """The loss lines of ``loss_log.txt`` without their timings."""
    with open(os.path.join(ckpt_dir, "loss_log.txt")) as f:
        return [ln.split(") ", 1)[1].strip() for ln in f if ln.startswith("(epoch")]


def dp_nccl(seed: int, tmp: str) -> dict:
    """The train phase's command for DP_ITERS steps twice in this process,
    then once under ``torchrun --nproc_per_node 1`` (NCCL at a world of one):
    its launches per step the train phase's, its checkpoint and losses
    those of the plain runs within their own distance (bitwise where they
    are)."""
    data = os.path.join(tmp, "nccl_data")
    tiffio.imwrite(os.path.join(data, "volume.tif"), synthetic_volume(seed, TRAIN_VOLUME))
    ckpt = os.path.join(tmp, "nccl_ckpt")
    argv = ["--dataroot", data, "--checkpoints_dir", ckpt, *TRAIN_ARGS, "--max_iters",
            str(DP_ITERS), "--seed", str(seed), "--print_freq", "1"]
    before = kernel_ops.launches()
    plain = [train_onecube.main([*argv, "--name", f"plain{i}"]) for i in range(2)]
    plain_launches = {k: v - before[k] for k, v in kernel_ops.launches().items()}
    out = _torchrun(1, ["-m", "neuroclear_tpu_torch.train_onecube", *argv, "--name", "nccl"],
                    DP_TIMEOUT_S, "train_onecube under torchrun (NCCL, world 1)")
    if "data parallel over 1 ranks (nccl)" not in out:
        raise AssertionError("the torchrun run did not go data-parallel over NCCL")
    launches = json.loads(out.split("kernel launches: ", 1)[1].splitlines()[0])
    secs = json.loads(out.split("step seconds (device clock): ", 1)[1].splitlines()[0])
    expected = {k: DP_ITERS * v for k, v in STEP_LAUNCHES.items()}
    log(f"  NCCL world 1: launches over {DP_ITERS} steps {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"NCCL world-1 launch counts {launches} != {expected}")
    dirs = {n: os.path.join(ckpt, next(d for d in os.listdir(ckpt) if d.endswith("_" + n)))
            for n in ("plain0", "plain1", "nccl")}
    arrays = {n: _ckpt_arrays(d, f"iter_{DP_ITERS}") for n, d in dirs.items()}
    rerun = _max_abs(arrays["plain0"], arrays["plain1"])
    dist_ = _max_abs(arrays["plain0"], arrays["nccl"])
    same_losses = _logged_losses(dirs["plain0"]) == _logged_losses(dirs["nccl"])
    step_ms = _median_ms(secs)
    plain_ms = _median_ms(plain[0]["step_seconds"])
    log(f"  NCCL world 1 against the plain run: checkpoint max |diff| {dist_:.3g} (two plain "
        f"runs: {rerun:.3g}); logged losses {'equal' if same_losses else 'DIFFER'}; step "
        f"median {step_ms:.1f} ms (the plain run's {plain_ms:.1f} ms)")
    if dist_ > rerun or (rerun == 0 and not same_losses):
        raise AssertionError(f"NCCL world 1 off the plain run: {dist_} > {rerun} or losses")
    total = {k: launches[k] + plain_launches[k] for k in launches}
    return {"launches": total, "step_ms": step_ms, "plain_ms": plain_ms, "dist": dist_,
            "rerun": rerun}


def dp_generator(seed: int, rank: int) -> torch.Generator:
    """The run generator of a rank: the one seed on every rank, as the
    trainer's (crops and probe draws)."""
    return torch.Generator().manual_seed(seed)


def _state_tensors(model) -> list:
    tensors = []
    for n in model.model_names:
        tensors += list(model.nets[n].parameters()) + list(model.nets[n].buffers())
    for optim in (model.optim_g, model.optim_d):
        for group in optim.param_groups:
            for p in group["params"]:
                tensors += [v for v in optim.state.get(p, {}).values()
                            if isinstance(v, torch.Tensor)]
    return tensors


def dp_unequal(model) -> int:
    """How many of the model's parameters, buffers and Adam tensors differ
    between the ranks: two int64 checksums of each tensor's bits, their
    maxima and minima over the ranks by one all-reduce of (c, -c)."""
    sums = []
    for t in _state_tensors(model):
        bits = t.detach().float().contiguous().view(torch.int32).reshape(-1).to(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device, dtype=torch.int64) % 65521 + 1
        sums.append(torch.stack([bits.sum(), (bits * w).sum()]).cpu())
    c = torch.stack(sums)
    both = torch.cat([c, -c])
    torch.distributed.all_reduce(both, op=torch.distributed.ReduceOp.MAX)
    hi, lo = both[:len(c)], -both[len(c):]
    return int((hi != lo).any(dim=1).sum())


def _dp_steps(model, sample, gen, crop: int, iters: int, after_first=None) -> dict:
    """``iters`` data-parallel steps (``sample(gen)``, then the probe draws
    from ``gen``) with each kernel's launches, the step times (CUDA events)
    and, after every step, the tensors that differ between the ranks; the
    first step's averaged (losses, g_grads, d_grads) kept
    (``after_first(model, first)`` runs after it)."""
    reduce, first = model.reduce_gradients, []

    def keep(losses, g, d):
        out = reduce(losses, g, d)
        if not first:
            first.append(out)
        return out

    model.reduce_gradients = keep
    kernel_ops.reset_launches()
    launches, unequal, events = None, [], []
    for i in range(iters):
        real = sample(gen)
        draws = model.draw_probes((crop,) * 3, gen)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        model.optimize_parameters(real, draws)
        end.record()
        events.append((start, end))
        if i == iters - 1:
            launches = kernel_ops.launches()
        if i == 0 and after_first is not None:
            after_first(model, first[0])
        unequal.append(dp_unequal(model))
    torch.cuda.synchronize()
    model.reduce_gradients = reduce
    return {"launches": launches, "step_ms": [a.elapsed_time(b) for a, b in events],
            "unequal": unequal, "first": first[0]}


def _grad_dict(model, g_grads, d_grads) -> dict:
    return {k: v.double() for k, v in _grads_by_name(model, g_grads, d_grads).items()}


def _compare_grads(model, got, ref_losses, ref_g, ref_d) -> dict:
    """The averaged step against a single-process reference: tensors not
    bitwise equal, relative L2 pooled per net, losses' largest relative
    difference."""
    losses, g, d = got
    a, b = _grad_dict(model, g, d), _grad_dict(model, ref_g, ref_d)
    per_net = {n: _rel_l2(a, b, [k for k in b if k.startswith(n + ".")])
               for n in model.model_names}
    loss_rel = max(abs(float(losses[k]) - float(ref_losses[k])) / max(abs(float(ref_losses[k])),
                                                                   1e-30)
                   for k in ref_losses)
    return {"unequal": sum(not torch.equal(a[k], b[k]) for k in b), "tensors": len(b),
            "per_net": per_net, "loss_rel": loss_rel,
            "losses_equal": all(torch.equal(losses[k].float(), ref_losses[k].float())
                                for k in ref_losses)}


def _dp_accum_task(make, dataset, crop: int, iters: int, seed: int, table: dict) -> dict:
    """A model (``make()``) under DataParallel for ``iters`` steps; on rank
    0 the first step against the single-process ``--grad_accum 2`` step of
    a second model from the same weights on the same two crops and draws
    (and that step's rerun distance where they differ)."""
    from neuroclear_tpu_torch.parallel.train_parallel import DataParallel, rank

    model = make()
    dp = DataParallel(model)
    gen = dp_generator(seed, rank())
    ref = None
    if rank() == 0:
        refm = make()
        g2 = torch.Generator()
        g2.set_state(gen.get_state())
        geometry = [dataset.draws(g2) for _ in range(2)]
        draws = refm.draw_probes((crop,) * 3, g2)

        def accum():
            losses, *_, g, d = refm.accumulate(lambda i: dataset.crop(*geometry[i]), 2, draws)
            return losses, g, d
        ref = accum()
    run = _dp_steps(model, dp.batch_sampler(dataset), gen, crop, iters)
    res = {"launches": run["launches"], "step_ms": run["step_ms"], "unequal": run["unequal"],
           "expected": {k: iters * v for k, v in table.items()},
           "allreduce_bytes": 4 * (sum(p.numel() for p in model.g_params + model.d_params)
                                   + len(model.loss_names))}
    if ref is not None:
        res["accum"] = _compare_grads(model, run["first"], *ref)
        if res["accum"]["unequal"] or not res["accum"]["losses_equal"]:
            again = accum()
            res["accum"]["rerun"] = _compare_grads(model, again, *ref)["per_net"]
    return res


def dp_apollo(seed: int, dev, rank: int) -> dict:
    """The production bf16 Apollo step at 108^3 (the train phase's flags)."""
    opt = train_options.build_parser().parse_args(["--dataroot", "unused", *TRAIN_ARGS])

    def make():
        model = ApolloModel(opt, dev)
        model.init_weights(seed, "kaiming")
        return model
    dataset = SingleVolumeDataset(synthetic_volume(seed, TRAIN_VOLUME), (CROP,) * 3,
                                  opt.preprocess, dev)
    return _dp_accum_task(make, dataset, CROP, DP_ITERS, seed, STEP_LAUNCHES)


def dp_athena(seed: int, dev, rank: int) -> dict:
    """The JAX study's Athena command (128^3, --remat, bf16) from its
    trained nets."""
    flats = athena_flats()
    preprocess = ATHENA_ARGS[ATHENA_ARGS.index("--preprocess") + 1]
    dataset = SingleVolumeDataset(synthetic_volume(seed + 4, ATHENA_VOLUME),
                                  (ATHENA_CROP,) * 3, preprocess, dev)
    return _dp_accum_task(lambda: athena_model(flats, dev), dataset, ATHENA_CROP,
                          DP_ATHENA_ITERS, seed, ATHENA_REMAT_STEP_LAUNCHES)


def dp_batchnorm(seed: int, dev, rank: int) -> dict:
    """``--norm batch`` at 108^3 in f32: on rank 0 the first averaged step
    against the single-process batched step on both crops (``torch.cat``),
    and the running statistics after its refresh against a refresh of that
    batch from the data-parallel model's updated weights."""
    from neuroclear_tpu_torch.parallel.train_parallel import DataParallel

    opt = train_options.build_parser().parse_args(["--dataroot", "unused", *DP_BN_ARGS])

    def make():
        model = ApolloModel(opt, dev)
        model.init_weights(seed, "kaiming")
        return model
    dataset = SingleVolumeDataset(synthetic_volume(seed, TRAIN_VOLUME), (CROP,) * 3,
                                  opt.preprocess, dev)
    model = make()
    dp = DataParallel(model)
    gen = dp_generator(seed, rank)
    ref, checks = None, {}
    if rank == 0:
        refm = make()
        g2 = torch.Generator()
        g2.set_state(gen.get_state())
        batch = torch.cat([dataset.crop(*dataset.draws(g2)) for _ in range(2)])
        draws = refm.draw_probes((CROP,) * 3, g2)
        with norms.local_stats():
            losses, *_, g, d = refm.gradients(batch, draws)
        ref = (losses, g, d)

        def after_first(model, first):
            checks["batched"] = _compare_grads(model, first, *ref)
            with torch.no_grad():
                for p, q in zip(refm.g_params + refm.d_params, model.g_params + model.d_params):
                    p.copy_(q)
            with norms.local_stats():
                refm.refresh_norm_stats(batch)
            checks["refresh_rel"] = _stats_rel(model, refm)
    else:
        after_first = None
    run = _dp_steps(model, dp.batch_sampler(dataset), gen, CROP, DP_BN_ITERS, after_first)
    return {"launches": run["launches"], "step_ms": run["step_ms"], "unequal": run["unequal"],
            "expected": {k: DP_BN_ITERS * v for k, v in F32_BATCHNORM_STEP_LAUNCHES.items()},
            **checks}


def dp_dice(seed: int, dev, rank: int) -> dict:
    """The slice's tile pipeline sharded over the ranks (bf16, the
    kernels): launches per rank, every rank's output equal, and on rank 0
    the single-card pipeline's output against it."""
    import hashlib

    from neuroclear_tpu_torch.parallel.train_parallel import world

    vol = synthetic_volume(seed)
    roi, overlap, batch = 120, 15, 2
    vp = pad_for_dicing(vol, roi, overlap)
    grid = DiceGrid(vp.shape, roi, overlap, 10)
    net = UNetDeconv(1, 1)
    net.load_state_dict(params_from_numpy(init_flat(UNetDeconv(1, 1), seed=seed), net))
    net.to(dev)
    kw = dict(tile_batch=batch, precision="bfloat16", out_dtype=np.uint16,
              orig_shape=vol.shape, device=dev)
    pipe = DiceInferencePipeline(net, grid, dtype_inv_scale(vp.dtype), n_devices=world(), **kw)
    per_slab = grid.y_steps * grid.x_steps
    # the rank deals one card's batches: batches rank, rank + W, ... of a slab
    sizes = [min(batch, per_slab - j) for j in range(0, per_slab, batch)][rank::world()]
    mine, batches = sum(sizes), grid.z_steps * len(sizes)
    kernel_ops.reset_launches()
    out = pipe.run_streaming(vp)
    launches = kernel_ops.launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.run_streaming(vp)
    seconds = time.perf_counter() - t0
    res = {"launches": launches, "expected": pipeline_launches(batches), "tiles": mine,
           "tiles_per_slab": per_slab, "batches": batches, "seconds": seconds,
           "sha": hashlib.sha256(out.tobytes()).hexdigest()}
    if rank == 0:
        one = DiceInferencePipeline(net, grid, dtype_inv_scale(vp.dtype), **kw)
        res["one_card"] = lsb_stats(out, one.run_streaming(vp).astype(np.int64))
        res["dealing"] = tile_dealing(one, vp, world())
    return res


@torch.inference_mode()
def tile_dealing(pipe, vp: np.ndarray, world: int) -> dict:
    """The first slab's tiles through ``pipe``'s generator in one card's
    batches, then dealt to ``world`` ranks tile by tile (JAX's
    ``_make_sharded_slab_step``: rank d tiles d, d + W, ...) and batch by
    batch (the port's): per dealing, how many tiles' outputs differ from
    their one-card output and by how many LSB at most."""
    g, n = pipe.grid, pipe.tile_batch
    b, ext = g.border_cut, g.roi_size + 2 * g.border_cut
    slab = np.pad(vp[:ext - b], ((b, 0), (b, b), (b, b)), mode="reflect")
    offs = [(y * g.step, x * g.step) for y in range(g.y_steps) for x in range(g.x_steps)]
    x = torch.from_numpy(slab.astype(np.float32)).to(pipe.device)

    def outputs(batches):
        out = {}
        for batch in batches:
            tiles = torch.stack([x[:, y:y + ext, z:z + ext] for y, z in (offs[t] for t in batch)])
            y = pipe._generate((tiles * pipe.inv_scale).to(pipe.compute_dtype)[..., None])
            out.update(zip(batch, y))
        return out

    def deal(order):
        return [order[j:j + n] for j in range(0, len(order), n)]
    ref = outputs(deal(list(range(len(offs)))))
    by_tile = [b_ for r in range(world) for b_ in deal(list(range(r, len(offs), world)))]
    by_batch = deal(list(range(len(offs))))
    res = {}
    for name, batches in (("by_tile", by_tile), ("by_batch", [bt for r in range(world)
                                                              for bt in by_batch[r::world]])):
        got = outputs(batches)
        diffs = [float((got[t] - ref[t]).abs().max()) * 65535 for t in ref]
        res[name] = {"tiles_differing": sum(d > 0 for d in diffs), "tiles": len(diffs),
                     "max_lsb": max(diffs)}
    return res


DP_RANK_TASKS = {"apollo": dp_apollo, "batchnorm": dp_batchnorm, "athena": dp_athena,
                 "dice": dp_dice}


def dp_rank_main(args) -> int:
    """One rank of ``dp_gloo``: gloo on cuda:0 (``backend="gloo"``), the
    fault ``module:function`` installed first where given, the tasks run,
    the results written to ``<dir>/rank<r>.json``."""
    import importlib

    from neuroclear_tpu_torch.parallel import train_parallel

    faulthandler.dump_traceback_later(DP_TIMEOUT_S, exit=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if not train_parallel.maybe_initialize_distributed(dev, backend="gloo"):
        raise SystemExit("--dp-rank runs under torch.distributed.run")
    rank = train_parallel.rank()
    if args.dp_fault:
        module, fn = args.dp_fault.split(":")
        getattr(importlib.import_module(module), fn)(rank)
    out = {}
    for task in args.dp_tasks.split(","):
        t0 = time.perf_counter()
        out[task] = DP_RANK_TASKS[task](args.seed, dev, rank)
        out[task]["seconds_task"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    with open(os.path.join(args.dp_rank, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()
    faulthandler.cancel_dump_traceback_later()
    return 0


def dp_gloo(seed: int, tmp: str, tasks=DP_TASKS, fault=None) -> list:
    """Two ranks of this script (``--dp-rank``) over gloo on the one card,
    under torchrun: [rank 0's results, rank 1's] by task."""
    d = tempfile.mkdtemp(dir=tmp, prefix="gloo")
    _torchrun(DP_WORLD, [os.path.abspath(__file__), "--dp-rank", d, "--seed", str(seed),
                         "--dp-tasks", ",".join(tasks)] + (["--dp-fault", fault] if fault else []),
              DP_TIMEOUT_S, f"the gloo ranks ({','.join(tasks)}, fault {fault})")
    out = []
    for r in range(DP_WORLD):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _judge_launches(task: str, ranks: list) -> None:
    for r, res in enumerate(ranks):
        if res["launches"] != res["expected"]:
            raise AssertionError(f"{task} rank {r}: launches {res['launches']} != "
                                 f"{res['expected']}")


def _judge_together(task: str, ranks: list) -> None:
    for r, res in enumerate(ranks):
        if any(res["unequal"]):
            raise AssertionError(f"{task}: the ranks' state differs after the steps "
                                 f"{res['unequal']} (tensors per step)")


def judge_dp_accum(task: str, ranks: list) -> None:
    """Launches exact on each rank, the ranks' state equal after every step,
    and rank 0's first averaged step the ``--grad_accum 2`` step: bitwise,
    or no farther from it than a rerun of that step."""
    _judge_launches(task, ranks)
    _judge_together(task, ranks)
    acc = ranks[0]["accum"]
    if acc["unequal"] or not acc["losses_equal"]:
        rerun = acc["rerun"]
        if not any(rerun.values()) or any(v > rerun[n] for n, v in acc["per_net"].items()):
            raise AssertionError(f"{task}: the averaged step is not the --grad_accum 2 step: "
                                 f"{acc['unequal']} of {acc['tensors']} tensors differ, per "
                                 f"net {acc['per_net']} (a rerun of that step: {rerun}), "
                                 f"losses {acc['loss_rel']:.3g}")


def judge_dp_batchnorm(ranks: list) -> None:
    """No kernel (f32), the ranks together, the averaged step the batched
    step (losses within DP_BN_LOSS_REL, gradients per net within
    DP_BN_GRAD_REL, G_A's within DP_BN_G_A_REL) and the refreshed
    statistics within DP_BN_REFRESH_REL."""
    _judge_launches("batchnorm", ranks)
    _judge_together("batchnorm", ranks)
    b = ranks[0]["batched"]
    off = {n: v for n, v in b["per_net"].items()
           if v > (DP_BN_G_A_REL if n == "G_A" else DP_BN_GRAD_REL)}
    if (off or b["loss_rel"] > DP_BN_LOSS_REL
            or ranks[0]["refresh_rel"] > DP_BN_REFRESH_REL):
        raise AssertionError(f"batch norm over the ranks is not the batched step: per net "
                             f"{b['per_net']}, losses {b['loss_rel']:.3g}, refresh "
                             f"{ranks[0]['refresh_rel']:.3g}")


def judge_dp_dice(ranks: list) -> None:
    _judge_launches("dice", ranks)
    if len({res["sha"] for res in ranks}) != 1:
        raise AssertionError("the ranks' assembled volumes differ")
    one = ranks[0]["one_card"]
    if one["max_lsb"] > DP_LSB or ranks[0]["dealing"]["by_batch"]["tiles_differing"]:
        raise AssertionError(f"the sharded pipeline off the single card: {one}, tiles "
                             f"{ranks[0]['dealing']}")


def judge_dp(task: str, ranks: list) -> None:
    """The checks of ``task`` on the ranks' results ({task: result} each)."""
    per = [r[task] for r in ranks]
    if task in ("apollo", "athena"):
        judge_dp_accum(task, per)
    elif task == "batchnorm":
        judge_dp_batchnorm(per)
    else:
        judge_dp_dice(per)


def run_dp(seed: int, dev, tmp: str, train_ms: float) -> dict:
    """NCCL at a world of one through torchrun (``dp_nccl``), then two gloo
    ranks on the card for every task (``dp_gloo``), each judged."""
    torch.cuda.empty_cache()  # the ranks are processes of their own on this card
    nc = dp_nccl(seed, tmp)
    log(f"  the train phase's step median {train_ms:.1f} ms beside NCCL world 1's "
        f"{nc['step_ms']:.1f} ms")
    ranks = dp_gloo(seed, tmp)
    for task in DP_TASKS:
        per = [r[task] for r in ranks]
        log(f"  gloo, 2 ranks on cuda:0, {task}: " + json.dumps(
            [{k: v for k, v in res.items() if k not in ("expected", "sha")} for res in per]))
        judge_dp(task, ranks)
    a = ranks[0]["apollo"]
    ms = [float(np.median(r["apollo"]["step_ms"][1:])) for r in ranks]
    log(f"  gloo step medians per rank {[round(m, 1) for m in ms]} ms at {CROP}^3 bf16: two "
        f"processes sharing one card, not a multi-card speed; all-reduced per step "
        f"{a['allreduce_bytes']} bytes ({a['allreduce_bytes'] / 2 ** 20:.1f} MiB, the G and D "
        f"gradients in f32 and the losses)")
    d = [r["dice"] for r in ranks]
    log(f"  sharded pipeline: {d[0]['tiles_per_slab']} tiles a slab, rank 0 takes "
        f"{d[0]['tiles']} in {d[0]['batches']} batches, rank 1 {d[1]['tiles']} in "
        f"{d[1]['batches']}; against one card {d[0]['one_card']}; second run "
        f"{d[0]['seconds']:.3f} s; the first slab's tiles against their one-card outputs, "
        f"dealt tile by tile as JAX deals them {d[0]['dealing']['by_tile']}, batch by batch "
        f"{d[0]['dealing']['by_batch']}")
    launches = dict(nc["launches"])
    for r in ranks:
        for task in DP_TASKS:
            for k, v in r[task]["launches"].items():
                launches[k] += v
    return {"launches": launches, "nccl": nc, "gloo_ms": ms, "bytes": a["allreduce_bytes"],
            "dice": d[0]["one_card"]}


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
    ap.add_argument("--dp-rank", default=None,
                    help="run as one gloo rank of the dp phase (under torchrun), writing to "
                         "this directory")
    ap.add_argument("--dp-tasks", default=",".join(DP_TASKS), help="the dp rank's tasks")
    ap.add_argument("--dp-fault", default=None,
                    help="module:function installing a fault in the dp rank")
    ap.add_argument("--quality700", action="store_true",
                    help="instead of the smoke: the JAX study's 700^3 eval of its iteration "
                         "11000 redone in the port (bf16 and f32)")
    args = ap.parse_args(argv)
    if args.dp_rank:
        return dp_rank_main(args)
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

    if args.quality700:
        with Phase("quality 700") as ph, tempfile.TemporaryDirectory() as tmp:
            rows = run_quality700(tmp)
            ph.result = json.dumps(rows, default=str)
        log(smi)
        return 0

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

    with Phase("quality study") as ph, tempfile.TemporaryDirectory() as tmp:
        qs = run_quality(args.seed, dev, tmp)
        ph.result = (f"{QUALITY_SIZE}^3 s4 volumes bitwise the CPU's; the driver "
                     f"{qs['driver_s']:.1f} s, 4 steps of the s4 study command "
                     f"({', '.join(f'{t:.1f}' for t in qs['step_ms'])} ms), "
                     f"{len(qs['eval_s'])} evals, launches exact, iteration {qs['best']} "
                     f"selected; accum-2 step: fused bitwise the device volume's, host-window "
                     f"crops {QUALITY_CROP_DRAWS - qs['unequal']} of {QUALITY_CROP_DRAWS} "
                     f"bitwise, peaks " + ", ".join(f"{k} {v['peak_gib']:.3f} GiB"
                                                   for k, v in qs["runs"].items()))

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

    with Phase("vanilla") as ph, tempfile.TemporaryDirectory() as tmp:
        vn = run_vanilla(args.seed, dev, tmp)
        ph.result = (f"{VANILLA_CROP}^3 Apollo --netG unet_vanilla step {vn['step_ms']:.1f} ms "
                     f"(median of {VANILLA_ITERS - 1}), warm {vn['wall_ms']:.1f} ms wall, device "
                     f"{vn['device_ms']:.1f} ms, idle share {vn['idle']:.3f}, peak "
                     f"{vn['peak_gib']:.3f} GiB; gradient error against f32 (kernels / plain "
                     f"bf16) {vn['pooled']}; test_dice against plain bf16 max "
                     f"{vn['dice']['kp_max']}, mean {vn['dice']['kp_mean']:.3f} LSB")

    with Phase("batchnorm") as ph, tempfile.TemporaryDirectory() as tmp:
        bn = run_batchnorm(args.seed, dev, tmp)
        ph.result = (f"{CROP}^3 --norm batch step {bn['step_ms']:.1f} ms (median of "
                     f"{BATCHNORM_ITERS - 1}), warm {bn['wall_ms']:.1f} ms wall, device "
                     f"{bn['device_ms']:.1f} ms, idle share {bn['idle']:.3f}; running statistics "
                     "against plain "
                     f"{[round(d, 6) for _, d in bn['lockstep']]}; test_dice against plain "
                     "bf16 (max, mean LSB) " + ", ".join(
                         f"{'--eval' if e else 'batch statistics'} {r['kp_max']}, "
                         f"{r['kp_mean']:.3f}" for e, r in bn["dice"].items()))

    with Phase("zoo nets") as ph:
        kernel_ops.reset_launches()
        zo = run_zoo(args.seed, dev)
        zo["launches"] = kernel_ops.launches()
        ph.result = (f"{len(zo['nets']) - 1} nets, kernels against plain within "
                     f"{ZOO_F32_OUT} / {ZOO_F32_GRAD} (f32) and no worse than plain (bf16); "
                     "spectral and transposed-conv restatements hold")

    with Phase("dp") as ph, tempfile.TemporaryDirectory() as tmp:
        dp = run_dp(args.seed, dev, tmp, tr["step_ms"])
        ph.result = (f"NCCL world 1 through torchrun: launches exact, checkpoint "
                     f"{dp['nccl']['dist']:.3g} from the plain run (rerun "
                     f"{dp['nccl']['rerun']:.3g}), step {dp['nccl']['step_ms']:.1f} ms; gloo, 2 "
                     f"ranks on one card: Apollo, --norm batch and Athena steps and the sharded "
                     f"pipeline checked, launches exact per rank, ranks bitwise together; "
                     f"{dp['bytes']} bytes all-reduced per Apollo step; sharded pipeline "
                     f"against one card {dp['dice']}")

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
    # legacy_*; launches are the sums of every path's count
    # (launches_by_path), each read just after that path ran.
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
                   "study": st["launches"][name], "quality": qs["launches"][name],
                   "athena": at["launches"][name],
                   "dryops": dr["launches"][name], "epoch": ep["launches"][name],
                   "trained_dice": tg["launches"][name], "vanilla": vn["launches"][name],
                   "vanilla_dice": vn["dice_launches"][name],
                   "batchnorm": bn["launches"][name],
                   "batchnorm_dice": bn["dice_launches"][name], "zoo": zo["launches"][name],
                   "dp": dp["launches"][name]}
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
    log(f"whole run {time.monotonic() - T_START:.1f} s (budget {BUDGET_S} s)")
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
