"""Athena, the artifact-correction CycleGAN for OT-LSM stacks: the port of
``neuroclear_tpu/models/axial_to_lateral_gan_athena_model.py``, one crop per
step or, with ``--grad_accum N``, N crops per step (``BaseModel.accumulate``,
the math of the JAX package's ``grad_accum_scan``).

Two 3D generators (G_A ``--netG``, G_B ``--netG_B``; the study's
``unet_deconv`` and ``deep_linear_gen``) and six 2D discriminators
(``--netD``), D_{A,B}_{xy,xz,yz}.  Every comparison is slice against
slice, and each probe applies its discriminator to every slice of the crop
along one axis as one batch (``gan_common.probe_all_slices``), so the step
draws nothing.  ``--conversion_plane <source> <target>`` maps the planes to
slice axes (``PLANE_TO_AXIS``); the third plane is the remaining one.  One
step mirrors ``make_athena_step``: the G loss through the frozen
discriminators, then the D loss on the detached, pre-update fake and
reconstruction, then Adam on both.  The D loss's real side is not
symmetric, as in JAX: D_A_xy, D_A_yz and D_A_xz all see the real crop on the
target axis, D_B_xy on the target, D_B_yz on the source and D_B_xz on the
remaining axis.  ``--pool_size`` is taken and unused, as the JAX package
declares it.
"""

from __future__ import annotations

import torch

from ..nn import factory
from ..nn.losses import l1_loss
from . import gan_common as gc
from .axial_to_lateral_gan_apollo_model import check_nets
from .base_model import BaseModel

PLANE_TO_AXIS = {"xy": 0, "xz": 1, "yz": 2}
LOSS_NAMES = ["D_A_xy", "D_A_xz", "D_A_yz", "G_A", "G_A_xy", "G_A_xz", "G_A_yz", "cycle_A",
              "D_B_xy", "D_B_xz", "D_B_yz", "G_B", "G_B_xy", "G_B_xz", "G_B_yz"]
G_NAMES = ["G_A", "G_B"]
D_NAMES = ["D_A_xy", "D_A_xz", "D_A_yz", "D_B_xy", "D_B_xz", "D_B_yz"]
MODEL_NAMES = G_NAMES + D_NAMES
# (discriminator, real's axis, the other volume, its axis) of each D pair,
# by "target", "source" or "remain" (make_athena_step.d_loss_fn)
D_PAIRS = [("D_A_xy", "target", "fake", "target"), ("D_A_yz", "target", "fake", "source"),
           ("D_A_xz", "target", "fake", "remain"), ("D_B_xy", "target", "rec", "target"),
           ("D_B_yz", "source", "rec", "source"), ("D_B_xz", "remain", "rec", "remain")]


def modify_commandline_options(parser):
    """Athena's options (``AxialToLateralGANAthenaModel.modify_commandline_options``)."""
    parser.add_argument("--lambda_A", type=float, default=10.0,
                        help="strength of the A->B->A reconstruction (cycle) term")
    parser.add_argument("--pool_size", type=int, default=50,
                        help="no effect: declared by the original model and never used")
    parser.add_argument("--gan_mode", default="vanilla", help="vanilla | lsgan | wgangp")
    parser.add_argument("--conversion_plane", nargs="+", default=["yz", "xy"],
                        help="slicing planes of the conversion: <source> <target>")
    parser.add_argument("--lambda_plane", type=int, nargs="+", default=[1, 1, 1],
                        help="relative weights of the target- / source- / remaining-plane terms")
    parser.add_argument("--netG_B", default="deep_linear_gen",
                        help="generator of the backward (B->A) path")
    return parser


def plane_axes(conversion_plane) -> dict:
    """{"source", "target", "remain"} -> slice axis of ``--conversion_plane``."""
    src, tgt = conversion_plane
    if src not in PLANE_TO_AXIS or tgt not in PLANE_TO_AXIS or src == tgt:
        raise ValueError(f"--conversion_plane {conversion_plane}: two of {list(PLANE_TO_AXIS)}")
    remain = [p for p in PLANE_TO_AXIS if p not in (src, tgt)][0]
    return {"source": PLANE_TO_AXIS[src], "target": PLANE_TO_AXIS[tgt],
            "remain": PLANE_TO_AXIS[remain]}


class AthenaModel(BaseModel):
    """The eight nets, their f32 parameters and the two Adams, on ``device``."""

    G_NAMES, D_NAMES, LOSS_NAMES = G_NAMES, D_NAMES, LOSS_NAMES
    TAKES_BATCH = True
    modify_commandline_options = staticmethod(modify_commandline_options)

    def __init__(self, opt, device=None, plain: bool = False):
        check_nets(opt)
        super().__init__(opt, device)
        self.axes = plane_axes(opt.conversion_plane)
        plane = {v: k for k, v in PLANE_TO_AXIS.items()}
        print(f"source plane is {plane[self.axes['source']]}\ntarget plane is "
              f"{plane[self.axes['target']]}\nremaining plane is {plane[self.axes['remain']]}",
              flush=True)
        self.nets = {
            "G_A": factory.define_G(1, 1, 64, opt.netG, opt.norm, plain=plain),
            "G_B": factory.define_G(1, 1, 64, opt.netG_B, opt.norm, plain=plain),
        }
        for name in D_NAMES:
            self.nets[name] = factory.define_D(1, 64, opt.netD, opt.n_layers_D, opt.norm,
                                               plain=plain)
        self._finish(opt)

    def draw_probes(self, crop_shape, generator: torch.Generator):
        """Athena draws nothing: every probe takes every slice."""
        return None

    def _all(self, vol, plane: str, d: str):
        return gc.probe_all_slices(vol, self.axes[plane], self.nets[d])

    def g_loss(self, real):
        """``g_loss_fn``: (total, terms, fake, rec); the discriminators are
        only read (their gradients are not taken)."""
        lam_t, lam_s, lam_r = self.cfg.lambda_norm
        fake = gc.maybe_remat(self.nets["G_A"], self.cfg)(real)
        rec = gc.maybe_remat(self.nets["G_B"], self.cfg)(fake)
        g_a_xy = gc.g_gan(self._all(fake, "target", "D_A_xy"), self.cfg) * lam_t
        g_a_yz = gc.g_gan(self._all(fake, "source", "D_A_yz"), self.cfg) * lam_s
        g_a_xz = gc.g_gan(self._all(fake, "remain", "D_A_xz"), self.cfg) * lam_r
        g_a = g_a_xy + g_a_yz + g_a_xz
        g_b_xy = gc.g_gan(self._all(rec, "target", "D_B_xy"), self.cfg) * (1 / 3)
        g_b_yz = gc.g_gan(self._all(rec, "source", "D_B_yz"), self.cfg) * (1 / 3)
        g_b_xz = gc.g_gan(self._all(rec, "remain", "D_B_xz"), self.cfg) * (1 / 3)
        g_b = g_b_xy + g_b_yz + g_b_xz
        cycle = l1_loss(rec, real) * self.cfg.lambda_A
        terms = {"G_A": g_a, "G_A_xy": g_a_xy, "G_A_yz": g_a_yz, "G_A_xz": g_a_xz,
                 "G_B": g_b, "G_B_xy": g_b_xy, "G_B_yz": g_b_yz, "G_B_xz": g_b_xz,
                 "cycle_A": cycle}
        return g_a + g_b + cycle, terms, fake, rec

    def d_loss(self, real, fake, rec):
        """``d_loss_fn`` on the detached fake and reconstruction: (total,
        terms), the pairs of ``D_PAIRS`` in JAX's order of addition."""
        vols = {"fake": fake, "rec": rec}
        terms = {d: gc.d_pair(self._all(real, real_plane, d), self._all(vols[v], plane, d),
                              self.cfg)
                 for d, real_plane, v, plane in D_PAIRS}
        total = (terms["D_A_xy"] + terms["D_A_yz"] + terms["D_A_xz"] + terms["D_B_xy"]
                 + terms["D_B_yz"] + terms["D_B_xz"])
        return total, terms

    def gradients(self, real, draws=None):
        """One crop's losses, fake, rec and gradients at the current
        parameters, without an update: (losses, fake, rec, g_grads,
        d_grads), the gradients in the order of ``g_params``/``d_params``."""
        real = real.to(self.device, self.cfg.compute_dtype)
        g_total, g_terms, fake, rec = self.g_loss(real)
        g_grads = torch.autograd.grad(g_total, self.g_params)
        fake, rec = fake.detach(), rec.detach()
        d_total, d_terms = self.d_loss(real, fake, rec)
        d_grads = torch.autograd.grad(d_total, self.d_params)
        terms = {**g_terms, **d_terms}
        losses = {name: terms[name].detach() for name in LOSS_NAMES}
        return losses, fake, rec, g_grads, d_grads


AxialToLateralGANAthenaModel = AthenaModel  # the name the registry looks for
