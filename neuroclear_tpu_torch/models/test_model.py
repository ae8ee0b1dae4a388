"""TestModel: the single-generator inference model, the port of
``neuroclear_tpu/models/test_model.py`` with the load side and the inference
accessors of ``models/base_model.py`` (``--load_iter``, ``--epoch``,
``--model_suffix``; ``set_input``, ``test``, ``get_current_visuals``,
``eval``).  The fused tile pipeline runs ``netG`` itself; the per-cube loop
(``--legacy_pipeline``) goes through ``set_input`` and ``test``.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

from .. import resolve_device
from ..nn import factory
from ..utils.weights import count_params, load_npz, params_from_numpy


def _to_ndhwc(x) -> np.ndarray:
    """A loader batch as one (N, z, y, x, C) float32 array."""
    x = np.asarray(x, np.float32)
    if x.ndim == 6:  # (B, 1, z, y, x, 1) from a batched host chain
        x = x.reshape((-1,) + x.shape[2:])
    if x.ndim == 4:  # (z, y, x, 1) or (B, z, y, x)
        x = x[None] if x.shape[-1] == 1 else x[..., None]
    if x.ndim == 3:
        x = x[None, ..., None]
    return x


class TestModel:
    """The production generator (unet_deconv, instance norm), the only one
    ported so far, loaded from a JAX-format checkpoint."""

    def __init__(self, opt, device=None):
        self.device = resolve_device(device)
        self.save_dir = os.path.join(opt.checkpoints_dir, opt.name)
        self.visual_names = ["real", "fake"]
        self.model_names = ["G" + opt.model_suffix]
        self.netG = factory.define_G(1, 1, 64, "unet_deconv", "instance")
        self.netG.eval()
        self.image_paths = ""
        self._visuals = OrderedDict()

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

    def eval(self) -> None:
        """Eval semantics (the instance norm has no state it changes)."""
        self.netG.eval()

    def set_input(self, input) -> None:
        """``input["A"]``: a host array of one or more cubes, uploaded to the
        model's device in float32, channels-last."""
        self.real = torch.from_numpy(np.ascontiguousarray(_to_ndhwc(input["A"]))).to(self.device)
        self.image_paths = input.get("A_paths", "")
        self._visuals["real"] = self.real

    @torch.no_grad()
    def forward(self) -> None:
        """The generator on ``real`` in its dtype (float32, whatever
        --precision says, as the JAX package's per-cube path runs)."""
        self.fake = self.netG(self.real)
        self._visuals["fake"] = self.fake

    def test(self) -> None:
        self.forward()

    def get_current_visuals(self) -> OrderedDict:
        """{name: device tensor} of ``visual_names`` set so far."""
        return OrderedDict((n, self._visuals[n]) for n in self.visual_names if n in self._visuals)
