"""TestModel: the single-generator inference model, the port of
``neuroclear_tpu/models/test_model.py`` with the load side of
``models/base_model.py`` (``--load_iter``, ``--epoch``, ``--model_suffix``).
"""

from __future__ import annotations

import os

from .. import resolve_device
from ..nn import factory
from ..utils.weights import count_params, load_npz, params_from_numpy


class TestModel:
    """The production generator (unet_deconv, instance norm), the only one
    ported so far, loaded from a JAX-format checkpoint."""

    def __init__(self, opt, device=None):
        self.device = resolve_device(device)
        self.save_dir = os.path.join(opt.checkpoints_dir, opt.name)
        self.model_names = ["G" + opt.model_suffix]
        self.netG = factory.define_G(1, 1, 64, "unet_deconv", "instance")
        self.netG.eval()

    def setup(self, opt) -> None:
        suffix = f"iter_{opt.load_iter}" if opt.load_iter > 0 else opt.epoch
        self.load_networks(suffix)
        print(f"[Network {self.model_names[0]}] Total number of parameters : "
              f"{count_params(self.netG) / 1e6:.3f} M", flush=True)

    def load_networks(self, epoch) -> None:
        name = self.model_names[0]
        path = os.path.join(self.save_dir, f"{epoch}_net_{name}.npz")
        print(f"loading the model from {path}", flush=True)
        self.netG.load_state_dict(params_from_numpy(load_npz(path), self.netG))
        self.netG.to(self.device)
