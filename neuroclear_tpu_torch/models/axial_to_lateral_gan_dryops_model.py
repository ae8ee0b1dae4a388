"""Dryops, the Apollo ablation without the backward path (no G_B, cycle or
D_B): the port of ``neuroclear_tpu/models/axial_to_lateral_gan_dryops_model.py``,
one crop per step or, with ``--grad_accum N``, N crops per step
(``BaseModel.accumulate``, under one set of draws for all N, as JAX closes
its keys over ``grad_accum_scan``).

G_A (``--netG``, production ``unet_deconv``) against two 2D discriminators.
One step mirrors ``make_dryops_step``: one MIP depth; three G probes (window MIPs of the fake
on each axis through the frozen discriminators); six D probes, where D
compares a real lateral *slice* with a fake *projection* on each axis; the
G loss ``g_a_lat + 0.5 * g_a_ax``, the logged ``D_A_axial`` the mean of its
two terms.  The draws are an input of the step (``draw_probes``), as for
Apollo.
"""

from __future__ import annotations

import torch

from ..nn import factory
from . import gan_common as gc
from .axial_to_lateral_gan_apollo_model import AX1, AX2, LAT, check_nets
from .base_model import BaseModel, ProbeDraws

LOSS_NAMES = ["D_A_lateral", "D_A_axial", "G_A", "G_A_lateral", "G_A_axial"]
G_NAMES = ["G_A"]
D_NAMES = ["D_A_lateral", "D_A_axial"]
MODEL_NAMES = G_NAMES + D_NAMES
# (kind, volume, axis, discriminator), in the order of kg = split(k_g, 3)
# and kd = split(k_d, 6) (make_dryops_step); the D loss pairs them two by two
G_PROBES = [("proj", "fake", LAT, "D_A_lateral"), ("proj", "fake", AX1, "D_A_axial"),
            ("proj", "fake", AX2, "D_A_axial")]
D_PROBES = [("slice", "real", LAT, "D_A_lateral"), ("proj", "fake", LAT, "D_A_lateral"),
            ("slice", "real", LAT, "D_A_axial"), ("proj", "fake", AX1, "D_A_axial"),
            ("slice", "real", LAT, "D_A_axial"), ("proj", "fake", AX2, "D_A_axial")]


def modify_commandline_options(parser):
    """Dryops' options (``AxialToLateralGANDryopsModel.modify_commandline_options``)."""
    parser.add_argument("--lambda_A", type=float, default=10.0,
                        help="no effect in this ablation (it has no cycle term); kept for "
                             "flag parity")
    parser.add_argument("--gan_mode", default="vanilla", help="vanilla | lsgan | wgangp")
    parser.add_argument("--lambda_plane", type=int, nargs="+", default=[1, 1, 1],
                        help="relative weights of the lateral / axial terms")
    parser.add_argument("--randomize_projection_depth", action="store_true",
                        help="sample a fresh MIP window depth every iteration")
    parser.add_argument("--projection_depth", type=int, default=10,
                        help="MIP window depth; the upper bound when randomized")
    return parser


class DryopsModel(BaseModel):
    """G_A and the two lateral/axial discriminators, on ``device``."""

    G_NAMES, D_NAMES, LOSS_NAMES = G_NAMES, D_NAMES, LOSS_NAMES
    VISUAL_NAMES = ["real", "fake"]
    G_PROBES, D_PROBES = G_PROBES, D_PROBES
    TAKES_BATCH = True
    modify_commandline_options = staticmethod(modify_commandline_options)

    def __init__(self, opt, device=None, plain: bool = False):
        check_nets(opt, netG_B=False)
        super().__init__(opt, device)
        self.nets = {"G_A": factory.define_G(1, 1, 64, opt.netG, opt.norm, plain=plain)}
        for name in D_NAMES:
            self.nets[name] = factory.define_D(1, 64, opt.netD, opt.n_layers_D, opt.norm,
                                               plain=plain)
        self._finish(opt)

    def g_loss(self, real, draws: ProbeDraws):
        """``g_loss_fn``: (total, terms, fake)."""
        lam_t, lam_s, _ = self.cfg.lambda_norm
        fake = gc.maybe_remat(self.nets["G_A"], self.cfg)(real)
        t = [gc.g_gan(pred, self.cfg)
             for pred in self._probes(G_PROBES, draws.g, draws.depth, {"fake": fake})]
        g_a_lat = t[0] * lam_t
        g_a_ax = t[1] * lam_s + t[2] * lam_s
        g_a = g_a_lat + g_a_ax * 0.5
        return g_a, {"G_A": g_a, "G_A_lateral": g_a_lat, "G_A_axial": g_a_ax}, fake

    def d_loss(self, real, fake, draws: ProbeDraws):
        """``d_loss_fn`` on the detached fake: (total, terms)."""
        preds = self._probes(D_PROBES, draws.d, draws.depth, {"real": real, "fake": fake})
        pairs = [gc.d_pair(preds[2 * i], preds[2 * i + 1], self.cfg) for i in range(3)]
        return pairs[0] + pairs[1] + pairs[2], {"D_A_lateral": pairs[0],
                                                "D_A_axial": (pairs[1] + pairs[2]) * 0.5}

    def gradients(self, real, draws: ProbeDraws):
        """One crop's losses, fake and gradients at the current parameters,
        without an update: (losses, fake, g_grads, d_grads)."""
        real = real.to(self.device, self.cfg.compute_dtype)
        g_total, g_terms, fake = self.g_loss(real, draws)
        g_grads = torch.autograd.grad(g_total, self.g_params)
        fake = fake.detach()
        d_total, d_terms = self.d_loss(real, fake, draws)
        d_grads = torch.autograd.grad(d_total, self.d_params)
        terms = {**g_terms, **d_terms}
        losses = {name: terms[name].detach() for name in LOSS_NAMES}
        return losses, fake, g_grads, d_grads


AxialToLateralGANDryopsModel = DryopsModel  # the name the registry looks for
