"""The epoch trainer's multi-volume dataset: the volumes under ``--dataroot``
in numerical order, item i the i-th volume through the random host chain
(the port of ``neuroclear_tpu/data/cube_dataset.py``)."""

from __future__ import annotations

import re

import numpy as np

from ..utils import tiffio
from .base_dataset import BaseDataset, get_transform
from .image_folder import make_dataset


def numericalSort(value):
    parts = re.compile(r"(\d+)").split(value)
    parts[1::2] = map(int, parts[1::2])
    return parts


class CubeDataset(BaseDataset):
    """``rng``: the numpy generator of the host chain's draws."""

    def __init__(self, opt, rng: np.random.Generator = None):
        BaseDataset.__init__(self, opt)
        self.A_paths = make_dataset(opt.dataroot)
        self.A_paths.sort(key=numericalSort)
        self.A_size = len(self.A_paths)
        self.transform_A = get_transform(opt, rng=rng)

    @classmethod
    def from_options(cls, opt, rng: np.random.Generator):
        return cls(opt, rng)

    def __getitem__(self, index):
        A_path = self.A_paths[index % self.A_size]
        return {"A": self.transform_A(tiffio.imread(A_path)), "A_paths": A_path}

    def __len__(self):
        return self.A_size
