"""GAN objectives, the port of ``neuroclear_tpu/nn/losses.py`` (without the
gradient penalty, which no ported model uses).  Both take the prediction in
f32, as the JAX package does."""

from __future__ import annotations

import torch


def gan_loss(prediction: torch.Tensor, target_is_real: bool, gan_mode: str,
             real_label: float = 1.0, fake_label: float = 0.0) -> torch.Tensor:
    """lsgan -> MSE, vanilla -> BCE-with-logits, wgan* -> -+mean."""
    pred = prediction.float()
    if gan_mode == "lsgan":
        target = real_label if target_is_real else fake_label
        return torch.mean(torch.square(pred - target))
    if gan_mode == "vanilla":
        target = real_label if target_is_real else fake_label
        # BCEWithLogits: max(x, 0) - x t + log(1 + exp(-|x|))
        return torch.mean(torch.clamp(pred, min=0) - pred * target
                          + torch.log1p(torch.exp(-torch.abs(pred))))
    if "wgan" in gan_mode:
        return -torch.mean(pred) if target_is_real else torch.mean(pred)
    raise NotImplementedError(f"gan mode {gan_mode} not implemented")


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a.float() - b.float()))
