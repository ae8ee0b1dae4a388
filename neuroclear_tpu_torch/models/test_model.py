"""TestModel: the inference model, the port of
``neuroclear_tpu/models/test_model.py`` with the load side and the inference
accessors of ``models/base_model.py`` (``--load_iter``, ``--epoch``,
``--model_suffix``; ``set_input``, ``test``, ``get_current_visuals``,
``eval``).  The fused tile pipeline runs ``netG`` itself; the per-cube loop
(``--legacy_pipeline``) goes through ``set_input`` and ``test``.  ``netG`` is
``--netG`` with ``--norm``; a batch-norm generator uses its running
statistics only after ``eval()`` (``--eval``), as the JAX package traces
under ``eval_mode``: without it each batch is normalised by its own.

With ``--model`` a GAN model's name it holds that model's generators, as
the JAX model built for a test run does: ``netG`` is its G_A, and its G_B
(``--netG_B``), where it has one, is loaded too and maps the output back
(``rec``) in the per-cube loop, a visual no output reads.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

from .. import resolve_device
from ..nn import factory, norms
from . import find_model_using_name
from .axial_to_lateral_gan_athena_model import print_planes
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
    """``--netG`` with ``--norm`` (production: unet_deconv, instance norm),
    loaded from a JAX-format checkpoint; for a GAN model's name, its
    generators."""

    def __init__(self, opt, device=None):
        self.device = resolve_device(device)
        self.save_dir = os.path.join(opt.checkpoints_dir, opt.name)
        if opt.model == "test":
            self.model_names = ["G" + opt.model_suffix]
        else:
            self.model_names = list(find_model_using_name(opt.model).G_NAMES)
            if opt.model == "axial_to_lateral_gan_athena":
                print_planes(opt.conversion_plane)
        self.nets = {name: factory.define_G(1, 1, opt.ngf, opt.netG_B if name == "G_B"
                                            else opt.netG, opt.norm)
                     for name in self.model_names}
        self.netG = self.nets[self.model_names[0]]
        self.visual_names = ["real", "fake", "rec"][:1 + len(self.model_names)]
        self.image_paths = ""
        self.loaded = []
        self._visuals = OrderedDict()

    def setup(self, opt) -> None:
        """Load the checkpoint and print the generator's size (and, with
        ``--verbose``, the generator), as ``BaseModel.setup`` does."""
        suffix = f"iter_{opt.load_iter}" if opt.load_iter > 0 else opt.epoch
        self.load_networks(suffix)
        print("---------- Networks initialized -------------")
        for name, net in self.nets.items():
            if opt.verbose:
                print(net)
            print(f"[Network {name}] Total number of parameters : "
                  f"{count_params(net) / 1e6:.3f} M")
        print("-----------------------------------------------", flush=True)

    def load_networks(self, epoch) -> None:
        """``{epoch}_net_{name}.npz`` of each net; their paths are kept in
        ``loaded``."""
        for name, net in self.nets.items():
            path = os.path.join(self.save_dir, f"{epoch}_net_{name}.npz")
            print(f"loading the model from {path}", flush=True)
            net.load_state_dict(params_from_numpy(load_npz(path), net))
            net.to(self.device)
            self.loaded.append(path)

    def eval(self) -> None:
        """Eval semantics: batch norms normalise with their running
        statistics (the instance norm has no state it changes)."""
        for net in self.nets.values():
            norms.set_eval(net)

    def set_input(self, input) -> None:
        """``input["A"]``: a host array of one or more cubes, uploaded to the
        model's device in float32, channels-last."""
        self.real = torch.from_numpy(np.ascontiguousarray(_to_ndhwc(input["A"]))).to(self.device)
        self.image_paths = input.get("A_paths", "")
        self._visuals["real"] = self.real

    @torch.no_grad()
    def forward(self) -> None:
        """The generator on ``real`` in its dtype (float32, whatever
        --precision says, as the JAX package's per-cube path runs), and G_B
        on its output where the model has one."""
        self.fake = self.netG(self.real)
        self._visuals["fake"] = self.fake
        if "G_B" in self.nets:
            self._visuals["rec"] = self.nets["G_B"](self.fake)

    def test(self) -> None:
        self.forward()

    def get_current_visuals(self) -> OrderedDict:
        """{name: device tensor} of ``visual_names`` set so far."""
        return OrderedDict((n, self._visuals[n]) for n in self.visual_names if n in self._visuals)
