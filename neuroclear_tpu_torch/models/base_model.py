"""``BaseModel``, the port of ``neuroclear_tpu/models/base_model.py``: what
the three GAN models share (the nets, the G and D Adams in the JAX layout,
the schedules, weights, checkpoints, the per-crop accumulation and the
update), and its checkpoint side: one ``{suffix}_net_{NAME}.npz`` per
network in the JAX flat format, and the optimizer state as
``{suffix}_optim.npz`` in the JAX layout, each written atomically (a
temporary file, then a rename), so that either package loads what the other
wrote.

The JAX package's optimizer state is ``{"D": ScaleByAdamState, "G":
ScaleByAdamState}`` (optax's ``count, mu, nu``), tree-flattened to arrays
``"0"`` .. ``"N-1"``: D's count, D's mu leaves, D's nu leaves, then G's.
The leaves of mu and nu follow JAX's dict order, sorted key by key along
each leaf's path ({net: {module: ... {"w", "b"}}}), with conv kernels in
the (k..., I, O) layout.  Every leaf of the JAX parameter tree has its
slot, the buffers too (a batch norm's running statistics, a spectral conv's
``u``): their gradient is zero in JAX, so Adam's moments stay exactly zero
there; the port writes zeros and reads nothing back into them.
``__lr{i}__`` holds the i-th learning-rate controller's position
(``LRController.state()``).  A ``torch.optim.Adam``
maps onto it as count -> every parameter's ``step``, mu -> ``exp_avg``, nu
-> ``exp_avg_sq``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import resolve_device
from ..nn import norms
from ..nn.schedulers import LRController
from ..parallel import train_parallel
from ..utils.weights import count_params, flat_from_module, init_flat, jax_leaves, load_npz, \
    params_from_numpy, to_numpy
from . import gan_common as gc


def atomic_savez(path: str, arrays: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # a file handle: savez appends no '.npz'
        np.savez(f, **arrays)
    os.replace(tmp, path)


def save_networks(nets: dict, save_dir: str, suffix: str) -> list:
    """Write every net of ``nets`` ({NAME: module}); returns the paths."""
    os.makedirs(save_dir, exist_ok=True)
    paths = []
    for name, net in nets.items():
        path = os.path.join(save_dir, f"{suffix}_net_{name}.npz")
        atomic_savez(path, flat_from_module(net))
        paths.append(path)
    return paths


def load_networks(nets: dict, save_dir: str, suffix: str) -> None:
    """Load ``{suffix}_net_{NAME}.npz`` into every net of ``nets``."""
    for name, net in nets.items():
        path = os.path.join(save_dir, f"{suffix}_net_{name}.npz")
        print(f"loading the model from {path}", flush=True)
        net.load_state_dict(params_from_numpy(load_npz(path), net))


def _leaves(nets: dict):
    """(to_jax, from_jax, tensor, is_parameter) of every leaf of ``nets`` in
    the order of JAX's flattening of {NAME: param tree}."""
    entries = [((name, *key.split(".")), to_jax, from_jax, t, param)
               for name, net in nets.items()
               for key, _, to_jax, from_jax, t, param in jax_leaves(net)]
    entries.sort(key=lambda e: e[0])
    return [e[1:] for e in entries]


def optim_arrays(groups, lr_controllers) -> dict:
    """``groups``: [(optimizer, {NAME: net})] in JAX's order (D, then G).
    Returns the ``{suffix}_optim.npz`` arrays."""
    flat = []
    for optim, nets in groups:
        leaves = _leaves(nets)
        states = [optim.state.get(p, {}) if param else None for _, _, p, param in leaves]
        steps = {int(s["step"]) if s else 0 for s in states if s is not None}
        if len(steps) != 1:
            raise RuntimeError(f"the parameters of one optimizer are at steps {sorted(steps)}")
        mu = [to_numpy(to_jax(s["exp_avg"])) if s else np.zeros(to_jax(p).shape, np.float32)
              for (to_jax, _, p, _), s in zip(leaves, states)]
        nu = [to_numpy(to_jax(s["exp_avg_sq"])) if s else np.zeros(to_jax(p).shape, np.float32)
              for (to_jax, _, p, _), s in zip(leaves, states)]
        flat += [np.asarray(steps.pop(), np.int32), *mu, *nu]
    arrays = {str(i): a for i, a in enumerate(flat)}
    for i, c in enumerate(lr_controllers):
        arrays[f"__lr{i}__"] = np.asarray(c.state(), np.float64)
    return arrays


def save_optim(path: str, groups, lr_controllers) -> None:
    atomic_savez(path, optim_arrays(groups, lr_controllers))


def load_optim(path: str, groups, lr_controllers) -> bool:
    """Restore the learning-rate controllers and the Adam state from
    ``path`` where it exists; as the JAX package does, a file whose leaf
    count does not match is reported and skipped.  Returns whether the
    optimizer state was restored."""
    if not os.path.exists(path):
        return False
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    for i, c in enumerate(lr_controllers):
        if f"__lr{i}__" in arrays:
            c.restore(arrays[f"__lr{i}__"])
    n = len([k for k in arrays if not k.startswith("__lr")])
    plan = [(optim, _leaves(nets)) for optim, nets in groups]
    if n != sum(1 + 2 * len(leaves) for _, leaves in plan):
        print(f"optimizer state at {path} does not match; skipping", flush=True)
        return False
    i = 0
    for optim, leaves in plan:
        count = float(arrays[str(i)])
        mu = [arrays[str(i + 1 + j)] for j in range(len(leaves))]
        nu = [arrays[str(i + 1 + len(leaves) + j)] for j in range(len(leaves))]
        i += 1 + 2 * len(leaves)
        for (_, from_jax, p, param), m, v in zip(leaves, mu, nu):
            if not param:
                continue

            def load(a):
                return from_jax(np.asarray(a, np.float32)).to(p.device).contiguous()
            optim.state[p] = {"step": torch.tensor(count, dtype=torch.float32),
                              "exp_avg": load(m), "exp_avg_sq": load(v)}
    print(f"restored optimizer state from {path}", flush=True)
    return True


@dataclasses.dataclass(frozen=True)
class ProbeDraws:
    """One step's draws: the MIP depth, then per probe of the model's
    ``G_PROBES`` and ``D_PROBES`` a slice index in [0, n) or a window start
    in [0, n - depth)."""
    depth: int
    g: tuple
    d: tuple


class BaseModel:
    """The nets of a GAN model, their f32 parameters and the two Adams, on
    ``device``.  A subclass names its nets (``G_NAMES``, ``D_NAMES``), its
    losses (``LOSS_NAMES``) and visuals (``VISUAL_NAMES``: the real crop,
    then what ``gradients`` returns after the losses), builds ``self.nets``
    and then calls ``_finish``; it defines ``gradients(real, draws)`` ->
    (losses, *VISUAL_NAMES[1:], g_grads, d_grads) at the current parameters
    and, where its step draws probes, ``G_PROBES``/``D_PROBES`` as (kind,
    volume, axis, discriminator).  ``plain`` builds the nets on the kernels'
    plain versions (the reference a run on the card is held against).
    ``reduce_gradients`` (None in one process; ``DataParallel.reduce`` under
    data parallelism) maps a step's (losses, g_grads, d_grads) to their
    means over the ranks before the update."""

    G_NAMES: list = []
    D_NAMES: list = []
    LOSS_NAMES: list = []
    VISUAL_NAMES: list = ["real", "fake", "rec"]
    G_PROBES: list = []
    D_PROBES: list = []
    # how the JAX model takes a --grad_accum step's crops: one at a time from
    # a sampler (Apollo without --fused_accum: train_onecube hands it per-crop
    # samplers, and the batch-norm refresh runs on the last crop), or as the
    # resident batch of all N (Athena and Dryops: ``optimize_parameters_batch``,
    # the refresh on all N)
    TAKES_BATCH = False

    def __init__(self, opt, device=None):
        self.device = resolve_device(device)
        self.norm = opt.norm
        self.save_dir = os.path.join(opt.checkpoints_dir, opt.name)
        self.cfg = gc.GanStepConfig(
            gan_mode=opt.gan_mode, lambda_A=opt.lambda_A,
            lambda_plane=tuple(opt.lambda_plane),
            randomize_projection_depth=getattr(opt, "randomize_projection_depth", False),
            projection_depth=getattr(opt, "projection_depth", 10), precision=opt.precision,
            remat=opt.remat)
        self.nets = {}
        self.base_lr = opt.lr
        self.lr_controllers = []
        self.visuals = {}
        self.reduce_gradients = None
        self.supports_input_sampler = (not self.TAKES_BATCH
                                       and getattr(opt, "grad_accum", 1) > 1
                                       and not getattr(opt, "fused_accum", False))

    @property
    def model_names(self) -> list:
        return self.G_NAMES + self.D_NAMES

    @property
    def loss_names(self) -> list:
        return self.LOSS_NAMES

    @property
    def visual_names(self) -> list:
        return self.VISUAL_NAMES

    def _finish(self, opt) -> None:
        """Move the nets to the device and build the G and D Adams."""
        for net in self.nets.values():
            net.to(self.device)
        self.g_params = [p for n in self.G_NAMES for p in self.nets[n].parameters()]
        self.d_params = [p for n in self.D_NAMES for p in self.nets[n].parameters()]
        self.optim_g = gc.make_adam(self.g_params, opt.lr, opt.beta1)
        self.optim_d = gc.make_adam(self.d_params, opt.lr, opt.beta1)

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
        """Random weights by ``init_type`` (``utils/weights.py::init_flat``),
        net i of ``model_names`` drawn from numpy seed ``seed * 16 + i``."""
        self.load_flats({name: init_flat(self.nets[name], init_type, gain, seed * 16 + i)
                         for i, name in enumerate(self.model_names)})

    def load_flats(self, flats: dict) -> None:
        """{NAME: JAX flat dict} -> the nets' parameters."""
        for name, flat in flats.items():
            net = self.nets[name]
            net.load_state_dict(params_from_numpy(flat, net))

    def _optim_groups(self):
        """The two Adams in the JAX state's order ("D", then "G")."""
        return [(self.optim_d, {n: self.nets[n] for n in self.D_NAMES}),
                (self.optim_g, {n: self.nets[n] for n in self.G_NAMES})]

    def optim_arrays(self) -> dict:
        """The ``{suffix}_optim.npz`` arrays of the two Adams and schedules."""
        return optim_arrays(self._optim_groups(), self.lr_controllers)

    def save_networks(self, suffix: str) -> list:
        """Every net and ``{suffix}_optim.npz``; returns the paths.  Under
        data parallelism rank 0 writes (every rank holds the same state) and
        the others return []."""
        if not train_parallel.is_main():
            return []
        paths = save_networks(self.nets, self.save_dir, suffix)
        path = os.path.join(self.save_dir, f"{suffix}_optim.npz")
        save_optim(path, self._optim_groups(), self.lr_controllers)
        return paths + [path]

    def load_networks(self, suffix: str) -> None:
        load_networks(self.nets, self.save_dir, suffix)
        self.load_optim(os.path.join(self.save_dir, f"{suffix}_optim.npz"))

    def load_optim(self, path: str) -> bool:
        return load_optim(path, self._optim_groups(), self.lr_controllers)

    def print_networks(self, verbose: bool = False) -> None:
        print("---------- Networks initialized -------------", flush=True)
        for name in self.model_names:
            if verbose:
                print(self.nets[name], flush=True)
            print(f"[Network {name}] Total number of parameters : "
                  f"{count_params(self.nets[name]) / 1e6:.3f} M", flush=True)
        print("-----------------------------------------------", flush=True)

    # ---------------------------------------------------------------- step

    def draw_probes(self, crop_shape, generator: torch.Generator):
        """The step's draws from ``generator``: depth first, then each
        probe's index or start, in plan order (``ProbeDraws``)."""
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

        return ProbeDraws(depth, draw(self.G_PROBES), draw(self.D_PROBES))

    def _probes(self, plan, positions, depth, vols):
        """The discriminators' predictions for each probe of ``plan``."""
        out = []
        for (kind, v, axis, d), pos in zip(plan, positions):
            if kind == "proj":
                out.append(gc.probe_proj(vols[v], pos, depth, axis, self.nets[d]))
            else:
                out.append(gc.probe_slice(vols[v], pos, axis, self.nets[d]))
        return out

    def gradients(self, real: torch.Tensor, draws):
        raise NotImplementedError

    def accumulate(self, crop, n: int, draws):
        """The ``--grad_accum n`` step's gradients without the update, as
        ``host_step`` (and ``grad_accum_scan``) compute them: ``gradients``
        of crop ``crop(i)`` for i in order, each at the current (pre-update)
        parameters and under the one set of ``draws``, added into f32
        accumulators that start at zero, then divided by n.  ``crop`` is
        called just before its crop's micro-step, so the n crops are never
        resident together.  Returns (losses, real, *outs, g_grads, d_grads):
        the mean of the per-crop losses, the last crop's real and outputs
        (``VISUAL_NAMES``), the mean gradients."""
        g_acc = [torch.zeros_like(p) for p in self.g_params]
        d_acc = [torch.zeros_like(p) for p in self.d_params]
        per_crop = []
        for i in range(n):
            real = crop(i)
            losses, *outs, g_grads, d_grads = self.gradients(real, draws)
            torch._foreach_add_(g_acc, list(g_grads))
            torch._foreach_add_(d_acc, list(d_grads))
            per_crop.append(losses)
            del g_grads, d_grads
        torch._foreach_div_(g_acc, float(n))
        torch._foreach_div_(d_acc, float(n))
        losses = {name: torch.stack([l[name] for l in per_crop]).mean()
                  for name in self.LOSS_NAMES}
        return (losses, real, *outs, g_acc, d_acc)

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

    @torch.no_grad()
    def refresh_norm_stats(self, real: torch.Tensor) -> None:
        """``refresh_norm_stats`` of the JAX package: after an update, one
        pass without gradients on ``real`` in f32 collects every batch
        norm's batch statistics (the G nets chained: G_A on ``real``, G_B on
        its output; each D net on the 2-batch of the middle lateral slice of
        ``real`` and of the first G's output), then the EMA with momentum
        0.1 refreshes their running statistics.  A no-op unless ``--norm
        batch``."""
        if self.norm != "batch":
            return
        x = real.to(self.device, torch.float32)
        with norms.collect_batch_stats() as stats:
            inp = fake = x
            for i, name in enumerate(self.G_NAMES):
                inp = self.nets[name](inp)
                if i == 0:
                    fake = inp
            if self.D_NAMES and x.dim() == 5:
                mid = x.shape[1] // 2
                d_in = torch.cat([x[:, mid], fake[:, mid]], dim=0)
                for name in self.D_NAMES:
                    self.nets[name](d_in)
        norms.ema_update_stats(stats)

    def _reduce(self, losses, g_grads, d_grads):
        if self.reduce_gradients is None:
            return losses, g_grads, d_grads
        return self.reduce_gradients(losses, g_grads, d_grads)

    def optimize_parameters(self, real: torch.Tensor, draws):
        """One training step on the batch ``real`` (N crops; the losses are
        means over it, every probe takes one index for all N): (losses,
        *outs); the real batch and the outputs are kept as the visuals, on
        the device.  Under data parallelism ``real`` is this rank's share
        and the losses and gradients are averaged over the ranks before the
        update.  Then the batch-norm refresh on ``real``."""
        losses, *outs, g_grads, d_grads = self.gradients(real, draws)
        losses, g_grads, d_grads = self._reduce(losses, g_grads, d_grads)
        self.apply_gradients(g_grads, d_grads)
        self.visuals = dict(zip(self.VISUAL_NAMES, (real, *outs)))
        self.refresh_norm_stats(real)
        return (losses, *outs)

    def optimize_parameters_accum(self, crop, n: int, draws, batch=None):
        """One ``--grad_accum n`` training step (``accumulate``, then one
        Adam update on the mean gradients): (losses, *outs); the last crop's
        real and outputs are kept as the visuals.  Then the batch-norm
        refresh on the last crop, or on all n (``TAKES_BATCH``, or
        ``batch``: the n crops resident together)."""
        losses, real, *outs, g_grads, d_grads = self.accumulate(crop, n, draws)
        losses, g_grads, d_grads = self._reduce(losses, g_grads, d_grads)
        self.apply_gradients(g_grads, d_grads)
        self.visuals = dict(zip(self.VISUAL_NAMES, (real, *outs)))
        if self.norm == "batch":
            if batch is None and self.TAKES_BATCH:
                batch = torch.cat([crop(i) for i in range(n)])
            self.refresh_norm_stats(real if batch is None else batch)
        return (losses, *outs)

    def optimize_parameters_batch(self, batch: torch.Tensor, draws):
        """The ``--grad_accum`` step on the (N, cz, cy, cx, 1) batch of crops
        cut first and resident together, JAX's one-program form (Apollo's
        ``--fused_accum``, Athena's and Dryops' only form): the micro-steps of
        ``optimize_parameters_accum`` on its rows in order, the same update,
        so bit for bit the per-crop form on the same crops; the batch-norm
        refresh on the whole batch, as the JAX model refreshes on its input."""
        return self.optimize_parameters_accum(lambda i: batch[i:i + 1], batch.shape[0], draws,
                                              batch=batch)
