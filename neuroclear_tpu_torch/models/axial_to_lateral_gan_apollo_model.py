"""Apollo, the production axial-to-lateral CycleGAN: the port of
``neuroclear_tpu/models/axial_to_lateral_gan_apollo_model.py``, one crop per
step or, with ``--grad_accum N``, N crops per step in the JAX package's
default form (``host_step``, ``accumulate`` here).

Two 3D generators (G_A ``--netG``, production ``unet_deconv``; G_B
``--netG_B``, production ``deep_linear_gen``) and four 2D discriminators
(``--netD``, production ``basic``), any of ``GAN_NET_G`` / ``GAN_NET_D``
with any ``--norm``.  D_A compares a random real XY slice with random-depth MIPs
of the fake volume along each axis; D_B compares slices of the real volume
with slices of the reconstruction; the cycle term is forward L1 only.  One
step mirrors ``make_apollo_step``:
  1. G forward, six G-side probes through the frozen discriminators, the G
     gradients with respect to the G parameters only;
  2. twelve D-side probes of the real crop and of the detached, pre-update
     fake and reconstruction, the D gradients;
  3. Adam on both (the D gradients do not depend on the G update, so the
     order of the two updates does not matter).
Parameters and Adam stay in f32; the nets compute in ``--precision``; each
step's learning rate is the base rate times the schedule's scale
(``setup``'s two ``LRController``s, stepped by ``update_learning_rate``).
With ``--remat`` the two generators inside the G loss recompute their
activations in its backward (``gan_common.maybe_remat``); the D loss and
inference run as without it.
The probe draws (the MIP depth and the 18 indices or window starts) are an
input of the step: the trainer draws them from its generator with
``draw_probes``, a test hands in the ones the JAX keys make.  Checkpoints
carry the optimizer state in the JAX layout (``models/base_model.py``).
"""

from __future__ import annotations

import torch

from ..nn import factory
from ..nn.losses import l1_loss
from . import gan_common as gc
from .base_model import BaseModel, ProbeDraws

LAT, AX1, AX2 = 0, 1, 2  # XY, XZ, YZ (apollo_model.py:86-88)
LOSS_NAMES = ["D_A_lateral", "D_A_axial", "G_A", "G_A_lateral", "G_A_axial", "cycle",
              "D_B_lateral", "D_B_axial", "G_B", "G_B_lateral", "G_B_axial"]
G_NAMES = ["G_A", "G_B"]
D_NAMES = ["D_A_lateral", "D_A_axial", "D_B_lateral", "D_B_axial"]
MODEL_NAMES = G_NAMES + D_NAMES

# (kind, volume, axis, discriminator) of each probe, in the order of the JAX
# step's key splits: kg = split(k_g, 6) for the G loss, kd = split(k_d, 12)
# for the D loss (make_apollo_step.build_loss_fns); the D loss pairs them
# (real, fake) two by two
G_PROBES = [("proj", "fake", LAT, "D_A_lateral"), ("proj", "fake", AX1, "D_A_axial"),
            ("proj", "fake", AX2, "D_A_axial"), ("slice", "rec", LAT, "D_B_lateral"),
            ("slice", "rec", AX1, "D_B_axial"), ("slice", "rec", AX2, "D_B_axial")]
D_PROBES = [("slice", "real", LAT, "D_A_lateral"), ("proj", "fake", LAT, "D_A_lateral"),
            ("slice", "real", LAT, "D_A_axial"), ("proj", "fake", AX1, "D_A_axial"),
            ("slice", "real", LAT, "D_A_axial"), ("proj", "fake", AX2, "D_A_axial"),
            ("slice", "real", LAT, "D_B_lateral"), ("slice", "rec", LAT, "D_B_lateral"),
            ("slice", "real", AX1, "D_B_axial"), ("slice", "rec", AX1, "D_B_axial"),
            ("slice", "real", AX2, "D_B_axial"), ("slice", "rec", AX2, "D_B_axial")]


def modify_commandline_options(parser, is_train: bool = True):
    """Apollo's options (``AxialToLateralGANApolloModel.modify_commandline_options``;
    ``is_train`` False: test_dice's, the backward generator alone)."""
    parser.set_defaults(no_dropout=True)
    if is_train:
        parser.add_argument("--lambda_A", type=float, default=10.0,
                            help="strength of the A->B->A reconstruction (cycle) term")
        parser.add_argument("--gan_mode", default="vanilla", help="vanilla | lsgan | wgangp")
        parser.add_argument("--lambda_plane", type=int, nargs="+", default=[1, 1, 1],
                            help="relative weights of the lateral / axial-XZ / axial-YZ terms")
        parser.add_argument("--randomize_projection_depth", action="store_true",
                            help="sample a fresh MIP window depth every iteration")
        parser.add_argument("--projection_depth", type=int, default=10,
                            help="MIP window depth; the upper bound when randomized")
        parser.add_argument("--min_projection_depth", type=int, default=2,
                            help="lower bound of the randomized MIP window depth (at least 2)")
    parser.add_argument("--netG_B", default="deep_linear_gen",
                        help="generator of the backward (B->A) path")
    return parser


# The --netG / --netG_B and --netD values with which the JAX package's three
# GAN models build and take a step (tests/test_torch_zoo_accept.py holds
# each value against them): the 3D generators with one output (not the
# two-headed unet_twoouts, the 2D resnet_* and VGG, or fixed_kernel, which
# has no init), and every discriminator
GAN_NET_G = ("unet_deconv", "unet_vanilla", "deep_linear_gen", "linearkernel",
             "linearkernel_double", "linearkernel_LK31", "linearkernel_NC")
GAN_NET_D = factory.NET_D


def check_nets(opt, netG_B: bool = True) -> None:
    """NotImplementedError for a --netG, --netG_B or --netD value with which
    the JAX package's GAN models do not run."""
    for flag, values in (("netG", GAN_NET_G), ("netG_B", GAN_NET_G if netG_B else None),
                         ("netD", GAN_NET_D)):
        if values is not None and getattr(opt, flag) not in values:
            raise NotImplementedError(
                f"--{flag} {getattr(opt, flag)}: the JAX package's GAN models do not run it, "
                f"so the port refuses it (ROADMAP.md, queue 1); they take {values}")


class ApolloModel(BaseModel):
    """The six nets, their f32 parameters and the two Adams, on ``device``."""

    G_NAMES, D_NAMES, LOSS_NAMES = G_NAMES, D_NAMES, LOSS_NAMES
    G_PROBES, D_PROBES = G_PROBES, D_PROBES
    modify_commandline_options = staticmethod(modify_commandline_options)

    def __init__(self, opt, device=None, plain: bool = False):
        check_nets(opt)
        super().__init__(opt, device)
        # one channel in and out (the JAX CLI's defaults); --ndf sizes the
        # discriminators, --ngf only the ResNet generators, which no GAN
        # model runs
        self.nets = {
            "G_A": factory.define_G(1, 1, opt.ngf, opt.netG, opt.norm, plain=plain),
            "G_B": factory.define_G(1, 1, opt.ngf, opt.netG_B, opt.norm, plain=plain),
        }
        for name in D_NAMES:
            self.nets[name] = factory.define_D(1, opt.ndf, opt.netD, opt.n_layers_D, opt.norm,
                                               plain=plain)
        self._finish(opt)

    def g_loss(self, real, draws: ProbeDraws):
        """``g_loss_fn``: (total, terms, fake, rec); the discriminators are
        only read (their gradients are not taken)."""
        fake = gc.maybe_remat(self.nets["G_A"], self.cfg)(real)
        total, terms, rec = self.g_loss_given_fake(real, fake, draws)
        return total, terms, fake, rec

    def g_loss_given_fake(self, real, fake, draws: ProbeDraws):
        """The G loss from G_A's output on: (total, terms, rec)."""
        lam_t, lam_s, _ = self.cfg.lambda_norm
        rec = gc.maybe_remat(self.nets["G_B"], self.cfg)(fake)
        t = [gc.g_gan(pred, self.cfg) for pred in
             self._probes(G_PROBES, draws.g, draws.depth, {"fake": fake, "rec": rec})]
        g_a_lat = t[0] * lam_t
        g_a_ax = t[1] * lam_s + t[2] * lam_s
        g_a = g_a_lat + g_a_ax * 0.5
        g_b_lat = t[3] * lam_t
        g_b_ax = t[4] * lam_s + t[5] * lam_s
        g_b = g_b_lat + g_b_ax * 0.5
        cycle = l1_loss(rec, real) * self.cfg.lambda_A
        terms = {"G_A": g_a, "G_A_lateral": g_a_lat, "G_A_axial": g_a_ax,
                 "G_B": g_b, "G_B_lateral": g_b_lat, "G_B_axial": g_b_ax, "cycle": cycle}
        return g_a + g_b + cycle, terms, rec

    def d_loss(self, real, fake, rec, draws: ProbeDraws):
        """``d_loss_fn`` on the detached fake and reconstruction: (total,
        terms).  D_A_axial's gradient is the sum of its two terms, its logged
        loss their mean."""
        preds = self._probes(D_PROBES, draws.d, draws.depth,
                             {"real": real, "fake": fake, "rec": rec})
        pairs = [gc.d_pair(preds[2 * i], preds[2 * i + 1], self.cfg) for i in range(6)]
        terms = {"D_A_lateral": pairs[0], "D_A_axial": (pairs[1] + pairs[2]) * 0.5,
                 "D_B_lateral": pairs[3], "D_B_axial": (pairs[4] + pairs[5]) * 0.5}
        return sum(pairs), terms

    def gradients(self, real, draws: ProbeDraws):
        """One crop's losses, fake, rec and gradients at the current
        parameters, without an update: (losses, fake, rec, g_grads,
        d_grads), the gradients in the order of ``g_params``/``d_params``.
        The counterpart of the JAX step's ``_micro``."""
        real = real.to(self.device, self.cfg.compute_dtype)
        g_total, g_terms, fake, rec = self.g_loss(real, draws)
        g_grads = torch.autograd.grad(g_total, self.g_params)
        fake, rec = fake.detach(), rec.detach()
        d_total, d_terms = self.d_loss(real, fake, rec, draws)
        d_grads = torch.autograd.grad(d_total, self.d_params)
        terms = {**g_terms, **d_terms}
        losses = {name: terms[name].detach() for name in LOSS_NAMES}
        return losses, fake, rec, g_grads, d_grads


AxialToLateralGANApolloModel = ApolloModel  # the name the registry looks for
