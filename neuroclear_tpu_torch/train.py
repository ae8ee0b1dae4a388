"""The epoch trainer on the card: the port of ``train.py``.

    python -m neuroclear_tpu_torch.train --dataroot <dir of volumes> \
        --dataset_mode cube --model axial_to_lateral_gan_apollo \
        --preprocess random3Drotate_randomcrop_randomflip_addColorChannel_addBatchChannel \
        --crop_size 108 108 108 --n_epochs 1 --n_epochs_decay 0 ...

The classic epoch loop over the batched loader: the ``cube`` dataset (every
volume under ``--dataroot`` in numerical order, each item one volume through
the random host chain, ``data/base_dataset.py``) or ``singlevolume`` (ten
host-chain items of one volume an epoch).  The loader shuffles unless
``--serial_batches`` and prefetches on a thread with ``--num_threads`` > 0;
its order, the host chain's draws and the model's probe draws come from
``--seed`` (numpy and torch generators).  Epochs run from ``--epoch_count``
to ``n_epochs + n_epochs_decay``; within one, every item is one step of the
model from the registry (Apollo, Athena or Dryops) at the schedule's
rate, with ``--display_freq``, ``--print_freq`` (the loss read-back, the
loop's one device sync) and ``--save_latest_freq`` counted in items; at the
end of every ``--save_epoch_freq``-th epoch it writes ``latest`` and
``{epoch}`` checkpoints, and each epoch ends with the schedule's step.
``--grad_accum`` > 1 is refused, as in JAX (it is ``train_onecube``'s).
It runs on the card unless ``--device cpu`` (or ``--gpu_ids -1``).  A step
takes the loader's whole batch (``--batch_size N``: the losses are means
over it).  Under torchrun (``python -m torch.distributed.run
--nproc_per_node W -m neuroclear_tpu_torch.train ...``) the batch is
split over the W ranks, as JAX's ``train.py`` shards it over its mesh:
every rank runs the loader with the one seed, so it cuts the whole batch
with the single process's order and draws, and keeps its rows; the
gradients and losses are averaged over the ranks.  A batch that W does not
divide is refused (JAX would run every process unsharded).  Rank 0 alone
prints and writes.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from . import resolve_device
from .data import create_dataset
from .data.base_dataset import to_ndhwc
from .models import create_model
from .options import device_of, train_options
from .parallel import train_parallel
from .parallel.train_parallel import DataParallel, rank_zero_stdout
from .train_onecube import _mark, _seconds
from .utils.visualizer import Visualizer

DATASET_MODES = ("cube", "singlevolume")


def parse(argv=None):
    """The epoch trainer's options: its datasets."""
    return train_options.parse(argv, dataset_modes=DATASET_MODES)


def main(argv=None) -> dict:
    """Train (data-parallel under a process group).  Returns {"losses": one
    {name: float} per step, "step_seconds":
    seconds of each step on the device's clock, from its batch's arrival to
    the step's last operation, "item_seconds": the host chain's seconds per
    batch, "wait_seconds": how long each step waited for its batch,
    "checkpoints": paths written, "device", "model", "total_iters"}.  The
    epochs run inside a ``torch.profiler`` range named ``epoch_loop``."""
    opt = parse(argv)
    if opt.grad_accum > 1:
        raise SystemExit("--grad_accum is a train_onecube feature; the epoch trainer "
                         "batches through its loader")
    if opt.batch_size % train_parallel.world():
        raise SystemExit(f"--batch_size {opt.batch_size} does not split over "
                         f"{train_parallel.world()} ranks; give a multiple of the world")
    with rank_zero_stdout():
        return _train(opt)


def _train(opt) -> dict:
    device = resolve_device(device_of(opt))
    # f32 convs in full f32, as the JAX package's HIGHEST precision
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    train_options.print_options(opt)
    rng = np.random.default_rng(opt.seed)
    gen = torch.Generator().manual_seed(opt.seed)
    dataset = create_dataset(opt, rng)
    dataset_size = len(dataset)
    print(f"The number of training images = {dataset_size}", flush=True)
    model = create_model(opt, device)
    model.init_weights(opt.seed, opt.init_type, opt.init_gain)
    model.setup(opt)
    dp = DataParallel(model) if dist.is_initialized() else None
    if dp is not None:
        print(f"data parallel over {dp.n} ranks ({dist.get_backend()}): "
              f"{opt.batch_size // dp.n} of each batch's {opt.batch_size} items per rank",
              flush=True)
    visualizer = Visualizer(opt)
    visualizer.display_model_hyperparameters()
    names = model.loss_names
    total_iters, t_data = 0, 0.0
    steps, spans, waits, paths = [], [], [], []
    with torch.profiler.record_function("epoch_loop"):
        for epoch in range(opt.epoch_count, opt.n_epochs + opt.n_epochs_decay + 1):
            epoch_start_time = time.time()
            iter_data_time = time.time()
            epoch_iter = 0
            visualizer.reset()
            for data in dataset:
                iter_start_time = time.time()
                waits.append(iter_start_time - iter_data_time)
                if total_iters % opt.print_freq == 0:
                    t_data = iter_start_time - iter_data_time
                total_iters += opt.batch_size
                epoch_iter += opt.batch_size
                real = torch.from_numpy(to_ndhwc(data["A"]))
                real = (dp.shard(real) if dp is not None else real).to(device)
                draws = model.draw_probes(tuple(real.shape[1:4]), gen)
                start = _mark(device)
                step_losses, *_ = model.optimize_parameters(real, draws)
                steps.append(torch.stack([step_losses[n] for n in names]))
                spans.append((start, _mark(device)))

                if total_iters % opt.display_freq == 0:
                    visualizer.display_current_results(model.visuals, total_iters)

                if total_iters % opt.print_freq == 0:
                    losses = dict(zip(names, steps[-1].tolist()))  # the device sync
                    t_comp = (time.time() - iter_start_time) / opt.batch_size
                    visualizer.print_current_losses(
                        epoch, int(100.0 * epoch_iter / max(dataset_size, 1)), losses, t_comp,
                        t_data)
                    if opt.display_id > 0:
                        visualizer.plot_current_losses(total_iters, losses)

                if total_iters % opt.save_latest_freq == 0:
                    print(f"saving the latest model (epoch {epoch}, total_iters {total_iters})",
                          flush=True)
                    paths += model.save_networks(f"iter_{total_iters}" if opt.save_by_iter
                                                 else "latest")
                iter_data_time = time.time()

            if epoch % opt.save_epoch_freq == 0:
                print(f"saving the model at the end of epoch {epoch}, iters {total_iters}",
                      flush=True)
                visualizer.display_current_histogram(model.visuals, epoch)
                if steps:
                    visualizer.plot_current_losses(epoch, dict(zip(names, steps[-1].tolist())),
                                                   is_epoch=True)
                paths += model.save_networks("latest")
                paths += model.save_networks(str(epoch))
            print(f"End of epoch {epoch} / {opt.n_epochs + opt.n_epochs_decay} \t Time Taken: "
                  f"{int(time.time() - epoch_start_time)} sec", flush=True)
            model.update_learning_rate()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    visualizer.close()
    losses = [dict(zip(names, s.tolist())) for s in steps]
    return {"losses": losses, "step_seconds": [_seconds(a, b) for a, b in spans],
            "item_seconds": list(dataset.seconds), "wait_seconds": waits, "checkpoints": paths,
            "device": device, "model": model, "total_iters": total_iters}


if __name__ == "__main__":
    main(sys.argv[1:])
