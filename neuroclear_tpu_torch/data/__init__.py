"""Dataset registry and loader, the port of ``neuroclear_tpu/data/__init__.py``:
``--dataset_mode foo`` -> module ``neuroclear_tpu_torch.data.foo_dataset``,
class ``FooDataset`` (case-insensitive).  The ported datasets are
``diceImage`` and ``singlevolume``; any other name is refused.

The loader serves ``test_dice``, which sets ``serial_batches`` and
``num_threads`` 0 as the JAX CLI does: it yields the batches in file order
on the caller's thread and reads neither option.
"""

from __future__ import annotations

import importlib

import numpy as np

PORTED = ("diceImage", "singlevolume")


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


def create_dataset(opt):
    """The dataset of ``opt.dataset_mode`` behind a batching loader."""
    return CustomDatasetDataLoader(opt)


class CustomDatasetDataLoader:
    """Batches of ``opt.batch_size`` items in file order, at most
    ``max_dataset_size`` items."""

    def __init__(self, opt):
        self.opt = opt
        dataset_class = find_dataset_using_name(opt.dataset_mode)
        self.dataset = dataset_class(opt)
        print(f"dataset [{type(self.dataset).__name__}] was created")
        self.batch_size = opt.batch_size
        self.max_size = getattr(opt, "max_dataset_size", float("inf"))

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

    def __iter__(self):
        order = np.arange(len(self.dataset))
        # the batches within max_dataset_size, as the JAX loader yields them
        n_batches = -(-len(order) // self.batch_size)
        if self.max_size != float("inf"):
            n_batches = min(n_batches, -(-int(self.max_size) // self.batch_size))
        for i in range(n_batches):
            idx = order[i * self.batch_size:(i + 1) * self.batch_size]
            yield self._collate([self.dataset[int(j)] for j in idx])
