"""Shared machinery of the axial-to-lateral GAN models, the port of
``neuroclear_tpu/models/gan_common.py``: the step's configuration, the
discriminator probes, the adversarial terms and Adam.

The JAX package draws every probe's index or window start from a PRNG split
inside its jitted step.  The port's probes take them as arguments; the step
draws them from an explicit ``torch.Generator`` unless the caller hands them
in (a test hands it the draws the JAX keys make).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..nn import generators
from ..nn.losses import gan_loss
from ..ops.sampling import all_slices, random_projection, random_slice


@dataclasses.dataclass(frozen=True)
class GanStepConfig:
    gan_mode: str = "lsgan"
    lambda_A: float = 10.0
    lambda_plane: tuple = (1, 1, 1)
    randomize_projection_depth: bool = False
    projection_depth: int = 10
    min_projection_depth: int = 2
    precision: str = "float32"  # compute dtype; params and Adam stay f32
    remat: bool = False  # recompute the generators' activations in the G loss

    @property
    def lambda_norm(self):
        s = sum(self.lambda_plane)
        return tuple(f / s for f in self.lambda_plane)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.precision == "bfloat16" else torch.float32


def maybe_remat(net, cfg: GanStepConfig):
    """``net``'s forward with its activations recomputed in the backward
    when ``cfg.remat`` (``maybe_remat`` of the JAX package): per block for a
    net that has it (``block_remat``, the U-Net), else the whole forward
    (``DeepLinearGenerator``: only its input and output are kept)."""
    if not cfg.remat:
        return net
    if getattr(net, "block_remat", False):
        return functools.partial(net, remat=True)
    return lambda x: generators.checkpointed(net, x)


def make_adam(params, lr: float, beta1: float) -> torch.optim.Adam:
    """``make_adam`` + ``apply_updates`` of the JAX package:
    torch.optim.Adam(lr, betas=(beta1, 0.999), eps=1e-8)."""
    return torch.optim.Adam(params, lr=lr, betas=(beta1, 0.999), eps=1e-8)


def probe_slice(vol, idx: int, axis: int, d_apply):
    """D on one slice (apollo_model.py:310-314)."""
    return d_apply(random_slice(vol, idx, axis))


def probe_proj(vol, start: int, depth: int, axis: int, d_apply):
    """D on a window MIP (apollo_model.py:316-320)."""
    return d_apply(random_projection(vol, start, depth, axis))


def probe_all_slices(vol, axis: int, d_apply):
    """D on every slice along ``axis``, batched (Athena's probe,
    gan_common.py:44-47 of the JAX package)."""
    return d_apply(all_slices(vol, axis))


def sample_projection_depth(cfg: GanStepConfig, generator: torch.Generator) -> int:
    """Per-step MIP depth (apollo_model.py:157-160): uniform on
    [max(2, min_projection_depth), projection_depth] when randomized, as
    ``sample_projection_depth`` of the JAX package draws it."""
    if not cfg.randomize_projection_depth:
        return cfg.projection_depth
    return int(torch.randint(max(2, cfg.min_projection_depth), cfg.projection_depth + 1, (),
                             generator=generator))


def g_gan(pred, cfg: GanStepConfig):
    return gan_loss(pred, True, cfg.gan_mode)


def d_pair(pred_real, pred_fake, cfg: GanStepConfig):
    """(GAN(real, True) + GAN(fake, False)) * 0.5, backward_D_* parity."""
    return (gan_loss(pred_real, True, cfg.gan_mode)
            + gan_loss(pred_fake, False, cfg.gan_mode)) * 0.5
