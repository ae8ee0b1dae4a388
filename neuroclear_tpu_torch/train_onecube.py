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
``--dataroot``), keeps it on the device, and for each iteration draws an
augmented crop (rotation, offsets and flips), takes one step of the model
at the schedule's learning
rate, and steps the schedule.  With ``--grad_accum N`` an iteration draws
the N crops' geometry, then the step's probe draws, and cuts each crop just
before its micro-step (the JAX package's ``per_crop_sampler``; its
host-window sampler and the environment switches ``NEUROCLEAR_HOST_WINDOW``
and ``NEUROCLEAR_ACCUM_DEVICE_VOL`` are not ported: the volume stays on the
card).  The model comes from the registry (``models.create_model``):
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
given.  ``--fused_accum`` and the models of the zoo beyond these three are
not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import math
import os
import sys
import threading
import time

import torch

from . import resolve_device
from .data.singlevolume_dataset import SingleVolumeDataset, volume_path
from .models import create_model
from .options import device_of, train_options
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
    with ``--continue_train`` the model holds the checkpoint and its
    optimizer state."""
    device = resolve_device(device_of(opt))
    # f32 convs in full f32, as the JAX package's HIGHEST precision
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    train_options.print_options(opt)
    path = volume_path(opt.dataroot)
    vol = tiffio.imread(path)
    dataset = SingleVolumeDataset(vol, opt.crop_size, opt.preprocess, device)
    print(f"volume {path} {vol.shape} {vol.dtype} on {device}; crops "
          f"{tuple(opt.crop_size)} {opt.precision}; augmentation: on-device chain "
          f"(rotation {dataset.rotate}); seed {opt.seed}", flush=True)
    if opt.grad_accum > 1:
        print(f"gradient accumulation: {opt.grad_accum} crops per optimizer step", flush=True)
    model = create_model(opt, device)
    model.init_weights(opt.seed, opt.init_type, opt.init_gain)
    model.setup(opt)
    return device, dataset, model


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
    {"losses": one {name: float} per iteration, "step_seconds": seconds of
    each iteration on the device's clock (from the end of one to the end of
    the next), "checkpoints": paths written, "visuals": the snapshot paths,
    "device", "model": the model after the last iteration, "total_iters"};
    without it the run keeps no history and does not return."""
    opt = train_options.parse(argv)
    device, dataset, model = setup(opt)
    visualizer = Visualizer(opt)
    gen = torch.Generator().manual_seed(opt.seed)
    loaded_iter = opt.load_iter + 1 if opt.load_iter > 0 else 0
    total_iters = loaded_iter
    visualizer.display_model_hyperparameters()
    watchdog = Watchdog(opt.watchdog_secs) if opt.watchdog_secs > 0 else None

    # with --max_iters, each step's losses and end mark, kept without a sync
    names = model.loss_names
    log = torch.empty((opt.max_iters, len(names)), device=device)
    marks = [_mark(device)]
    paths, snapshots, t_data = [], [], 0.0
    prof = _profiler(opt, device)
    iter_data_time = time.time()
    while True:
        # the crops' draws first, then the step's probe draws, as the JAX
        # trainer takes the sampler's key before the step's
        if opt.grad_accum > 1:
            geometry = [dataset.draws(gen) for _ in range(opt.grad_accum)]
        else:
            real = dataset.sample(gen)
        draws = model.draw_probes(opt.crop_size, gen)
        iter_start_time = time.time()
        if (total_iters - loaded_iter) % opt.print_freq == 0:
            t_data = iter_start_time - iter_data_time
        total_iters += opt.batch_size
        if opt.grad_accum > 1:
            step_losses, *_ = model.optimize_parameters_accum(
                lambda i: dataset.crop(*geometry[i]), opt.grad_accum, draws)
        else:
            step_losses, *_ = model.optimize_parameters(real, draws)
        values = torch.stack([step_losses[n] for n in names])
        if opt.max_iters:
            log[total_iters - loaded_iter - 1] = values
            marks.append(_mark(device))

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
    losses = [dict(zip(names, row)) for row in log.tolist()]
    secs = [_seconds(a, b) for a, b in zip(marks, marks[1:])]
    return {"losses": losses, "step_seconds": secs, "checkpoints": paths,
            "visuals": snapshots, "device": device, "model": model,
            "total_iters": total_iters}


if __name__ == "__main__":
    main(sys.argv[1:])
