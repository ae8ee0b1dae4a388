"""Apollo, the production axial-to-lateral CycleGAN: the port of
``neuroclear_tpu/models/axial_to_lateral_gan_apollo_model.py``, one crop per
step or, with ``--grad_accum N``, N crops per step in the JAX package's
default form (``host_step``, ``accumulate`` here).

Two 3D generators (G_A ``unet_deconv``, G_B ``deep_linear_gen``) and four 2D
discriminators.  D_A compares a random real XY slice with random-depth MIPs
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

import dataclasses
import os

import torch

from .. import resolve_device
from ..nn import factory
from ..nn.schedulers import LRController
from ..nn.losses import l1_loss
from ..utils.weights import count_params, init_flat, params_from_numpy
from . import base_model
from . import gan_common as gc

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


@dataclasses.dataclass(frozen=True)
class ProbeDraws:
    """One step's draws: the MIP depth, then per probe of ``G_PROBES`` and
    ``D_PROBES`` a slice index in [0, n) or a window start in
    [0, n - depth)."""
    depth: int
    g: tuple
    d: tuple


class ApolloModel:
    """The six nets, their f32 parameters and the two Adams, on ``device``.
    ``plain`` builds the nets on the kernels' plain versions (the reference
    a run on the card is held against)."""

    def __init__(self, opt, device=None, plain: bool = False):
        if opt.netG != "unet_deconv" or opt.netG_B != "deep_linear_gen":
            raise NotImplementedError("the port's Apollo model has netG unet_deconv and "
                                      "netG_B deep_linear_gen (ROADMAP.md, queue 1)")
        self.device = resolve_device(device)
        self.save_dir = os.path.join(opt.checkpoints_dir, opt.name)
        self.cfg = gc.GanStepConfig(
            gan_mode=opt.gan_mode, lambda_A=opt.lambda_A,
            lambda_plane=tuple(opt.lambda_plane),
            randomize_projection_depth=opt.randomize_projection_depth,
            projection_depth=opt.projection_depth, precision=opt.precision,
            remat=opt.remat)
        # one channel in and out, 64 filters, 3-layer discriminators: the
        # production configuration's (the JAX CLI's defaults)
        self.nets = {
            "G_A": factory.define_G(1, 1, 64, opt.netG, opt.norm, plain=plain),
            "G_B": factory.define_G(1, 1, 64, opt.netG_B, opt.norm, plain=plain),
        }
        for name in D_NAMES:
            self.nets[name] = factory.define_D(1, 64, opt.netD, 3, opt.norm, plain=plain)
        for net in self.nets.values():
            net.to(self.device)
        self.g_params = [p for n in G_NAMES for p in self.nets[n].parameters()]
        self.d_params = [p for n in D_NAMES for p in self.nets[n].parameters()]
        self.optim_g = gc.make_adam(self.g_params, opt.lr, opt.beta1)
        self.optim_d = gc.make_adam(self.d_params, opt.lr, opt.beta1)
        self.base_lr = opt.lr
        self.lr_controllers = []
        self.visuals = {}

    # ------------------------------------------------------- setup and lr

    def setup(self, opt) -> None:
        """``BaseModel.setup``: the two learning-rate controllers, then with
        ``--continue_train`` the checkpoint ``iter_{load_iter}`` (or
        ``--epoch``) with its optimizer state."""
        self.lr_controllers = [LRController(opt.lr_policy, opt) for _ in range(2)]
        if opt.continue_train:
            self.load_networks(f"iter_{opt.load_iter}" if opt.load_iter > 0 else opt.epoch)
        self.print_networks(opt.verbose)

    @property
    def lr_scale(self) -> float:
        return self.lr_controllers[0].scale if self.lr_controllers else 1.0

    def update_learning_rate(self) -> None:
        """Step the schedules (the plateau policy sees the metric 0, as the
        JAX model passes it)."""
        for c in self.lr_controllers:
            c.step(0.0)

    # ------------------------------------------------------------- weights

    def init_weights(self, seed: int, init_type: str = "kaiming", gain: float = 0.02) -> None:
        """Random weights by ``init_type`` (``utils/weights.py::init_flat``;
        the production command's is kaiming), net i drawn from numpy seed
        ``seed * 16 + i``."""
        self.load_flats({name: init_flat(self.nets[name], init_type, gain, seed * 16 + i)
                         for i, name in enumerate(MODEL_NAMES)})

    def load_flats(self, flats: dict) -> None:
        """{NAME: JAX flat dict} -> the nets' parameters."""
        for name, flat in flats.items():
            net = self.nets[name]
            net.load_state_dict(params_from_numpy(flat, net))

    def _optim_groups(self):
        """The two Adams in the JAX state's order ("D", then "G")."""
        return [(self.optim_d, {n: self.nets[n] for n in D_NAMES}),
                (self.optim_g, {n: self.nets[n] for n in G_NAMES})]

    def save_networks(self, suffix: str) -> list:
        """The six nets and ``{suffix}_optim.npz``; returns the paths."""
        paths = base_model.save_networks(self.nets, self.save_dir, suffix)
        path = os.path.join(self.save_dir, f"{suffix}_optim.npz")
        base_model.save_optim(path, self._optim_groups(), self.lr_controllers)
        return paths + [path]

    def load_networks(self, suffix: str) -> None:
        base_model.load_networks(self.nets, self.save_dir, suffix)
        base_model.load_optim(os.path.join(self.save_dir, f"{suffix}_optim.npz"),
                              self._optim_groups(), self.lr_controllers)

    def print_networks(self, verbose: bool = False) -> None:
        print("---------- Networks initialized -------------", flush=True)
        for name in MODEL_NAMES:
            if verbose:
                print(self.nets[name], flush=True)
            print(f"[Network {name}] Total number of parameters : "
                  f"{count_params(self.nets[name]) / 1e6:.3f} M", flush=True)
        print("-----------------------------------------------", flush=True)

    # ---------------------------------------------------------------- step

    def draw_probes(self, crop_shape, generator: torch.Generator) -> ProbeDraws:
        """Depth first, then each probe's index or start, in plan order."""
        depth = gc.sample_projection_depth(self.cfg, generator)

        def draw(plan):
            out = []
            for kind, _, axis, _ in plan:
                n = crop_shape[axis]
                hi = n - depth if kind == "proj" else n
                if hi <= 0:
                    raise ValueError(f"projection depth {depth} does not fit axis {axis} "
                                     f"of the crop {tuple(crop_shape)}")
                out.append(int(torch.randint(0, hi, (), generator=generator)))
            return tuple(out)

        return ProbeDraws(depth, draw(G_PROBES), draw(D_PROBES))

    def _probes(self, plan, positions, depth, vols):
        """The discriminators' predictions for each probe of ``plan``."""
        out = []
        for (kind, v, axis, d), pos in zip(plan, positions):
            if kind == "proj":
                out.append(gc.probe_proj(vols[v], pos, depth, axis, self.nets[d]))
            else:
                out.append(gc.probe_slice(vols[v], pos, axis, self.nets[d]))
        return out

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

    def gradients(self, real: torch.Tensor, draws: ProbeDraws):
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

    def accumulate(self, crop, n: int, draws: ProbeDraws):
        """The ``--grad_accum n`` step's gradients without the update, as
        ``host_step`` computes them: ``gradients`` of crop ``crop(i)`` for i
        in order, each at the current (pre-update) parameters and under the
        one set of ``draws``, added into f32 accumulators that start at zero,
        then divided by n.  ``crop`` is called just before its crop's
        micro-step, so the n crops are never resident together.  Returns
        (losses, real, fake, rec, g_grads, d_grads): the mean of the
        per-crop losses, the last crop's real, fake and rec, the mean
        gradients."""
        g_acc = [torch.zeros_like(p) for p in self.g_params]
        d_acc = [torch.zeros_like(p) for p in self.d_params]
        per_crop = []
        for i in range(n):
            real = crop(i)
            losses, fake, rec, g_grads, d_grads = self.gradients(real, draws)
            torch._foreach_add_(g_acc, list(g_grads))
            torch._foreach_add_(d_acc, list(d_grads))
            per_crop.append(losses)
            del g_grads, d_grads
        torch._foreach_div_(g_acc, float(n))
        torch._foreach_div_(d_acc, float(n))
        losses = {name: torch.stack([l[name] for l in per_crop]).mean() for name in LOSS_NAMES}
        return losses, real, fake, rec, g_acc, d_acc

    def apply_gradients(self, g_grads, d_grads) -> None:
        """Adam on both parameter sets at the base rate times the schedule's
        scale."""
        lr = self.base_lr * self.lr_scale
        for params, grads, optim in ((self.g_params, g_grads, self.optim_g),
                                     (self.d_params, d_grads, self.optim_d)):
            for group in optim.param_groups:
                group["lr"] = lr
            for p, g in zip(params, grads):
                p.grad = g
            optim.step()
            optim.zero_grad(set_to_none=True)

    def optimize_parameters(self, real: torch.Tensor, draws: ProbeDraws):
        """One training step: (losses, fake, rec); the three volumes are
        kept as the visuals, on the device."""
        losses, fake, rec, g_grads, d_grads = self.gradients(real, draws)
        self.apply_gradients(g_grads, d_grads)
        self.visuals = {"real": real, "fake": fake, "rec": rec}
        return losses, fake, rec

    def optimize_parameters_accum(self, crop, n: int, draws: ProbeDraws):
        """One ``--grad_accum n`` training step (``accumulate``, then one
        Adam update on the mean gradients): (losses, fake, rec); the last
        crop's real, fake and rec are kept as the visuals."""
        losses, real, fake, rec, g_grads, d_grads = self.accumulate(crop, n, draws)
        self.apply_gradients(g_grads, d_grads)
        self.visuals = {"real": real, "fake": fake, "rec": rec}
        return losses, fake, rec
