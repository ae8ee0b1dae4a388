"""Dataset registry and loader, the port of ``neuroclear_tpu/data/__init__.py``:
``--dataset_mode foo`` -> module ``neuroclear_tpu_torch.data.foo_dataset``,
class ``FooDataset`` (case-insensitive).  The ported datasets are
``PORTED``; any other name is refused.

The loader batches ``opt.batch_size`` items, at most ``max_dataset_size``
of them.  For the epoch trainer's datasets (``cube``, ``singlevolume``) it
shuffles the order unless ``--serial_batches``, from the run's explicit
numpy generator (the JAX loader shuffles with numpy's global state), and
with ``--num_threads`` > 0 prefetches the items on a thread, as the JAX
loader does; their host chains draw from the same generator.  The inference
datasets (``diceImage``, ``simulationcrop``) serve ``test_dice``'s per-cube
loop: their items come in file order on the caller's thread.  The loader
keeps the host seconds each batch took to cut (``seconds``).
"""

from __future__ import annotations

import importlib
import queue
import threading
import time

import numpy as np

from .base_dataset import INFERENCE_DATASETS

PORTED = ("diceImage", "singlevolume", "cube", "simulationcrop")


def find_dataset_using_name(dataset_name: str):
    if dataset_name not in PORTED:
        raise NotImplementedError(f"dataset [{dataset_name}] is not ported yet (ROADMAP.md, "
                                  f"queue 1); the port has {PORTED}")
    module_name = f"{__name__}.{dataset_name}_dataset"
    datasetlib = importlib.import_module(module_name)
    target = dataset_name.replace("_", "") + "dataset"
    for name, cls in datasetlib.__dict__.items():
        if name.lower() == target.lower() and isinstance(cls, type):
            return cls
    raise NotImplementedError(f"In {module_name}.py, there should be a class whose name "
                              f"matches {target} in lowercase.")


def create_dataset(opt, rng: np.random.Generator = None):
    """The dataset of ``opt.dataset_mode`` behind a batching loader; ``rng``
    draws the training datasets' order and augmentations."""
    return CustomDatasetDataLoader(opt, rng)


class CustomDatasetDataLoader:
    def __init__(self, opt, rng: np.random.Generator = None):
        dataset_class = find_dataset_using_name(opt.dataset_mode)
        self.inference = opt.dataset_mode in INFERENCE_DATASETS
        if self.inference:
            self.dataset = dataset_class(opt)
        else:
            self.rng = rng if rng is not None else np.random.default_rng()
            self.dataset = dataset_class.from_options(opt, self.rng)
        print(f"dataset [{type(self.dataset).__name__}] was created", flush=True)
        self.batch_size = opt.batch_size
        self.serial = self.inference or getattr(opt, "serial_batches", False)
        self.num_threads = 0 if self.inference else getattr(opt, "num_threads", 0)
        self.max_size = getattr(opt, "max_dataset_size", float("inf"))
        self.seconds = []

    def load_data(self):
        return self

    def __len__(self):
        return min(len(self.dataset), self.max_size)

    def _collate(self, items):
        out = {}
        for k in items[0]:
            vals = [it[k] for it in items]
            if isinstance(vals[0], np.ndarray):
                out[k] = np.stack(vals, axis=0)
            else:
                out[k] = vals if len(vals) > 1 else vals[0]
        return out

    def _batches(self) -> list:
        order = np.arange(len(self.dataset))
        if not self.serial:
            self.rng.shuffle(order)
        n_batches = -(-len(order) // self.batch_size)
        if self.max_size != float("inf"):
            n_batches = min(n_batches, -(-int(self.max_size) // self.batch_size))
        return [order[i * self.batch_size:(i + 1) * self.batch_size] for i in range(n_batches)]

    def _produce(self, idx):
        t0 = time.perf_counter()
        batch = self._collate([self.dataset[int(j)] for j in idx])
        self.seconds.append(time.perf_counter() - t0)
        return batch

    def __iter__(self):
        batches = self._batches()
        if self.num_threads <= 0:
            for idx in batches:
                yield self._produce(idx)
            return
        # one producer thread, a bounded queue: the next items are cut while
        # the caller trains on the last ones; the draws keep the batch order
        q = queue.Queue(maxsize=max(2, self.num_threads))
        stop, failed = object(), []

        def worker():
            try:
                for idx in batches:
                    q.put(self._produce(idx))
            except BaseException as e:  # re-raised on the caller's thread
                failed.append(e)
            q.put(stop)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is stop:
                if failed:
                    raise failed[0]
                return
            yield item
