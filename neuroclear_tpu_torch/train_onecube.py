"""Single-volume GAN trainer on the card: the port of ``train_onecube.py``.

The production command (the JAX package's ``train_onecube.py`` example) runs
unchanged:

    python -m neuroclear_tpu_torch.train_onecube --dataroot <dir> \
        --dataset_mode singlevolume \
        --preprocess random3Drotate_randomcrop_randomflip_addColorChannel_addBatchChannel \
        --model axial_to_lateral_gan_apollo --netG unet_deconv --netG_B deep_linear_gen \
        --netD basic --gan_mode lsgan --init_type kaiming --norm instance \
        --batch_size 1 --lambda_A 5 --crop_size 108 108 108 --lambda_plane 1 1 1 \
        --save_by_iter --save_latest_freq 500 --lr_policy constant \
        --randomize_projection_depth --projection_depth 10 --display_histogram --add_date

and resumes with ``--continue_train --load_iter N`` (the same command and
``--name``, without ``--add_date``'s new stamp).  Without ``--precision`` it
computes in float32 and without ``--seed`` it draws a fresh seed, as the
JAX CLI does; the JAX study's commands (``scripts/run_quality_study.sh``)
add ``--precision bfloat16 --remat --seed 0`` and, for its ga8 run,
``--grad_accum 8``.  It reads the volume (the first TIFF or ``.npy`` in
``--dataroot``) into host memory, and for each iteration draws an augmented
crop (rotation, offsets and flips), takes one step of the model at the
schedule's learning rate, and steps the schedule.  Where the crops come
from follows the JAX trainer (it prints the same ``augmentation:`` line):

* the device chain (``SingleVolumeDataset``), which cuts each crop on the
  device, from the volume uploaded there or, with
  ``NEUROCLEAR_HOST_WINDOW=1``, from a window of the volume in host memory
  uploaded alone;
* with ``--grad_accum N``, an iteration draws the N crops' geometry, then
  the step's probe draws; Apollo cuts each crop just before its micro-step,
  from its host window (JAX's ``per_crop_host_window_sampler``: the volume
  never goes to the card) or, with ``NEUROCLEAR_ACCUM_DEVICE_VOL=1``, from
  the device volume; with ``--fused_accum`` (and for Athena and Dryops,
  whose JAX steps take only this form) it cuts the N crops first from the
  device volume and runs the same micro-steps on them resident together;
* the host chain (``HostVolumeDataset``, one item per iteration) with
  ``--host_augment`` or a chain the device path does not take (both
  rotations, no ``randomcrop``, a 0 in ``--crop_size``): JAX's defaults,
  ``--preprocess none --crop_size 0 0 0``, train on the whole volume there;
  ``--grad_accum`` is refused with it, as in JAX.

The model comes from the registry (``models.create_model``):
Apollo, Athena (``--model axial_to_lateral_gan_athena``, the JAX study's
``--conversion_plane yz xy`` command) or Dryops, each drawing its own probes
from the run's generator (Athena draws none).  Every ``--print_freq``
iterations it reads the model's losses back (the one device sync of the
loop), prints them and appends them to ``loss_log.txt``; every
``--save_latest_freq`` iterations and at ``--max_iters`` it writes
``{suffix}_net_{NAME}.npz`` for each of the model's nets and ``{suffix}_optim.npz`` in
the JAX package's formats under ``<checkpoints_dir>/<name>/``, with TIFF
snapshots of the visuals (not with ``--no_html``), and every
``--update_html_freq`` iterations refreshes ``web/index.html`` with PNG
thumbnails of them.  The iteration count on resume follows the JAX trainer
(``--load_iter N`` resumes at N + 1, so the names it writes are the JAX
trainer's).  ``--profile_dir`` writes a ``torch.profiler`` trace of the
loop.  It runs on the card unless ``--device cpu`` (or ``--gpu_ids -1``) is
given.

On several cards, one process per card:

    python -m torch.distributed.run --nproc_per_node N \
        -m neuroclear_tpu_torch.train_onecube <the same command>

runs JAX's data-parallel recipe (``parallel/train_parallel.py``): NCCL
between the cards, every rank drawing the geometry of all N crops and the
step's probe draws from the one seed (rank 0's, broadcast when ``--seed``
is not given) and cutting its own crop, the gradients and losses averaged
over the ranks before the one Adam update, batch norm's statistics taken
over all N crops.  It is the ``--grad_accum N`` step computed on N cards
(which ``--grad_accum`` > 1 is then refused beside, as in JAX).  Rank 0
alone prints and writes; every rank keeps its ``--watchdog_secs``.
``--batch_size`` counts iterations, as in JAX.  The ranks cut their crops
from the device volume; the host chain is not run under torchrun.
"""

from __future__ import annotations

import json
import math
import os
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from . import ops as kernel_ops
from . import resolve_device
from .data.base_dataset import to_ndhwc
from .data.singlevolume_dataset import (HostVolumeDataset, SingleVolumeDataset,
                                        device_chain_takes, volume_path)
from .models import create_model
from .options import device_of, train_options
from .parallel.train_parallel import DataParallel, is_main, rank_zero_stdout
from .utils import tiffio
from .utils.visualizer import Visualizer


class Watchdog:
    """Calls ``expire`` (by default: exit 42) when ``beat`` has not been
    called for ``secs`` seconds; armed by the first beat, so start-up (the
    volume upload, a checkpoint load, the kernels' build) is not timed."""

    def __init__(self, secs: float, expire=None):
        self.secs, self.last = secs, 0.0
        self.expire = expire or self._exit
        self._stop = threading.Event()
        threading.Thread(target=self._watch, daemon=True).start()

    def _exit(self):
        print(f"watchdog: no progress for {self.secs}s; exiting 42 (resume with "
              "--continue_train)", flush=True)
        os._exit(42)

    def _watch(self):
        while not self._stop.wait(min(30.0, self.secs)):
            if self.last and time.time() - self.last > self.secs:
                self.expire()
                return

    def beat(self):
        self.last = time.time()

    def stop(self):
        self._stop.set()


def _mark(device: torch.device):
    """A point on the device's timeline, taken without a sync: a CUDA event
    on the card, the host clock on the CPU (where every op is synchronous)."""
    if device.type != "cuda":
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def _seconds(a, b) -> float:
    """Seconds from mark a to mark b (both complete)."""
    return a.elapsed_time(b) / 1e3 if isinstance(a, torch.cuda.Event) else b - a


def setup(opt):
    """The trainer's pieces for parsed options: (device, dataset, model);
    the dataset is the device chain's ``SingleVolumeDataset`` or the host
    chain's ``HostVolumeDataset`` (``--host_augment``, or a chain the
    device path does not take).  With ``--continue_train`` the model holds
    the checkpoint and its optimizer state."""
    device = resolve_device(device_of(opt))
    # f32 convs in full f32, as the JAX package's HIGHEST precision
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    train_options.print_options(opt)
    path = volume_path(opt.dataroot)
    vol = tiffio.imread(path)
    if opt.host_augment or not device_chain_takes(opt.preprocess, opt.crop_size):
        if opt.grad_accum > 1:
            raise SystemExit("--grad_accum needs the fused on-device sampler (singlevolume "
                             "dataset, no --host_augment)")
        if dist.is_initialized():
            raise NotImplementedError("the host chain under torchrun is not ported "
                                      f"{train_options.ROADMAP}; the ranks cut their crops "
                                      "with the device chain")
        dataset = HostVolumeDataset(vol, opt, np.random.default_rng(opt.seed), path)
        chain = "host (cv2) chain"
    else:
        dataset = SingleVolumeDataset(vol, opt.crop_size, opt.preprocess, device)
        chain = "fused on-device chain"
    print(f"volume {path} {vol.shape} {vol.dtype} on the host; crops "
          f"{tuple(opt.crop_size)} {opt.precision} on {device}; seed {opt.seed}", flush=True)
    print(f"augmentation: {chain}", flush=True)
    if opt.grad_accum > 1:
        print(f"gradient accumulation: {opt.grad_accum} crops per optimizer step", flush=True)
    model = create_model(opt, device)
    model.init_weights(opt.seed, opt.init_type, opt.init_gain)
    model.setup(opt)
    return device, dataset, model


def input_form(opt, dataset, model, dp=None):
    """The step's input as the JAX trainer chooses it: (name, take), where
    ``take(generator)`` draws an iteration's crops (before the step's probe
    draws) and returns ("crop", (1, cz, cy, cx, 1) tensor), ("crops", i ->
    crop i) or ("batch", (N, cz, cy, cx, 1) tensor).  The environment
    switches are read only where the JAX trainer reads them."""
    n = opt.grad_accum
    if isinstance(dataset, HostVolumeDataset):
        def host_item(_generator):
            real = torch.from_numpy(to_ndhwc(dataset[0]["A"]))
            return "crop", real.to(model.device)
        return "host chain", host_item
    if dp is not None:
        sample = dp.batch_sampler(dataset)
        return "device volume, one crop per rank", lambda g: ("crop", sample(g))
    if n > 1 and model.supports_input_sampler:
        if os.environ.get("NEUROCLEAR_ACCUM_DEVICE_VOL") == "1":
            return "device volume, per crop", lambda g: (
                "crops", dataset.per_crop_sampler(g, n))
        return "host windows, per crop", lambda g: (
            "crops", dataset.per_crop_host_window_sampler(g, n))
    if n > 1:
        return "device volume, resident batch", lambda g: ("batch", dataset.sample_batch(g, n))
    if os.environ.get("NEUROCLEAR_HOST_WINDOW") == "1":
        return "host window", lambda g: ("crop", dataset.sample_host_window(g))
    return "device volume", lambda g: ("crop", dataset.sample(g))


def step(model, opt, kind: str, real, draws):
    """One iteration's step on the input ``input_form`` took: (losses, *outs)."""
    if kind == "crops":
        return model.optimize_parameters_accum(real, opt.grad_accum, draws)
    if kind == "batch":
        return model.optimize_parameters_batch(real, draws)
    return model.optimize_parameters(real, draws)


def _profiler(opt, device):
    """A started ``torch.profiler`` for ``--profile_dir`` (None without it)."""
    if not opt.profile_dir:
        return None
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profiler(prof, opt) -> None:
    if prof is None:
        return
    prof.stop()
    os.makedirs(opt.profile_dir, exist_ok=True)
    path = os.path.join(opt.profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}", flush=True)


def main(argv=None) -> dict:
    """Train.  The losses are read back (a device sync) only every
    ``--print_freq`` iterations and at the end, so the host queues a step
    while the card runs the one before.  With ``--max_iters`` N, returns
    {"losses": one {name: float} per step, "step_seconds": seconds of each
    step on the device's clock (from the end of one to the end of the
    next), "checkpoints": paths written, "visuals": the snapshot paths,
    "device", "model": the model after the last step, "total_iters",
    "depths": each step's MIP depth (None for Athena, which draws none)}, and
    prints each kernel's launches in the run and the step seconds; without
    it the run keeps no history and does not return.  Under a process group (torchrun) the
    model runs data-parallel: one crop per rank a step, the gradients and
    losses averaged over the ranks; rank 0 alone prints and writes."""
    opt = train_options.parse(argv)
    with rank_zero_stdout():
        return _train(opt)


def _train(opt) -> dict:
    device, dataset, model = setup(opt)
    dp = None
    if dist.is_initialized():
        dp = DataParallel(model)
        print(f"data parallel over {dp.n} ranks ({dist.get_backend()}), one crop per rank "
              "a step", flush=True)
    form, take = input_form(opt, dataset, model, dp)
    print(f"crops from: {form}", flush=True)
    visualizer = Visualizer(opt)
    gen = torch.Generator().manual_seed(opt.seed)
    loaded_iter = opt.load_iter + 1 if opt.load_iter > 0 else 0
    total_iters = loaded_iter
    visualizer.display_model_hyperparameters()
    watchdog = Watchdog(opt.watchdog_secs) if opt.watchdog_secs > 0 else None

    # with --max_iters, each step's losses and end mark, kept without a sync
    names = model.loss_names
    steps, marks, depths = [], [_mark(device)], []
    paths, snapshots, t_data = [], [], 0.0
    prof = _profiler(opt, device) if is_main() else None
    launched = kernel_ops.launches()
    iter_data_time = time.time()
    while True:
        # the crops' draws first, then the step's probe draws, as the JAX
        # trainer takes the sampler's key before the step's
        kind, real = take(gen)
        draws = model.draw_probes(opt.crop_size if kind == "crops" else real.shape[1:4], gen)
        iter_start_time = time.time()
        if (total_iters - loaded_iter) % opt.print_freq == 0:
            t_data = iter_start_time - iter_data_time
        total_iters += opt.batch_size
        step_losses, *_ = step(model, opt, kind, real, draws)
        values = torch.stack([step_losses[n] for n in names])
        if opt.max_iters:
            steps.append(values)
            marks.append(_mark(device))
            depths.append(getattr(draws, "depth", None))

        if total_iters % opt.display_freq == 0:
            visualizer.display_current_results(model.visuals, total_iters)

        if total_iters % opt.print_freq == 0:
            print("----------------------------------")
            print(f"exp name: {opt.name}, device: {device}")
            print("----------------------------------")
            losses = dict(zip(names, values.tolist()))  # the device sync
            if opt.nan_check and not all(math.isfinite(v) for v in losses.values()):
                print(f"NaN/Inf loss detected at iter {total_iters}: {losses}", flush=True)
                model.save_networks("nan_debug")
                raise SystemExit(3)
            t_comp = (time.time() - iter_start_time) / opt.batch_size
            visualizer.print_current_losses(1, total_iters, losses, t_comp, t_data)
            if opt.display_id > 0:
                visualizer.plot_current_losses(total_iters, losses)

        if total_iters % opt.update_html_freq == 0:
            visualizer.update_html(model.visuals, total_iters)

        if total_iters % opt.save_latest_freq == 0:
            print("----------------------------------")
            print(f"saving the latest model (iteration {total_iters})")
            paths += model.save_networks(f"iter_{total_iters}" if opt.save_by_iter
                                         else "latest")
            print(f"saving the current histogram (iteration {total_iters})")
            visualizer.display_current_histogram(model.visuals, total_iters)
            print(f"saving the current visuals (iteration {total_iters})")
            snapshots += visualizer.save_current_visuals(model.visuals, total_iters)
            print("----------------------------------", flush=True)

        model.update_learning_rate()
        iter_data_time = time.time()
        if watchdog:
            watchdog.beat()

        if opt.max_iters and total_iters - loaded_iter >= opt.max_iters:
            print(f"reached --max_iters {opt.max_iters}; saving and exiting", flush=True)
            paths += model.save_networks(f"iter_{total_iters}" if opt.save_by_iter
                                         else "latest")
            break
    _stop_profiler(prof, opt)
    if watchdog:
        watchdog.stop()
    visualizer.close()
    losses = [dict(zip(names, row.tolist())) for row in steps]
    secs = [_seconds(a, b) for a, b in zip(marks, marks[1:])]
    launches = {k: v - launched[k] for k, v in kernel_ops.launches().items()}
    print(f"kernel launches: {json.dumps(launches)}", flush=True)
    print(f"step seconds (device clock): {json.dumps(secs)}", flush=True)
    return {"losses": losses, "step_seconds": secs, "checkpoints": paths,
            "visuals": snapshots, "device": device, "model": model, "dataset": dataset,
            "form": form, "total_iters": total_iters, "depths": depths}


if __name__ == "__main__":
    main(sys.argv[1:])
