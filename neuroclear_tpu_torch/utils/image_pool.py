"""The CycleGAN history buffer of fake images, the twin of
``neuroclear_tpu/utils/image_pool.py``.  No model calls it, as in the JAX
package (Athena's ``--pool_size`` is declared and unused); the 50% swap
draws from an explicit ``random.Random`` instead of the ``random`` module."""

from __future__ import annotations

import random

import torch


class ImagePool:
    def __init__(self, pool_size: int, rng: random.Random | None = None):
        self.pool_size = pool_size
        self.rng = rng if rng is not None else random.Random()
        if self.pool_size > 0:
            self.num_imgs = 0
            self.images = []

    def query(self, images: torch.Tensor) -> torch.Tensor:
        """``images`` (N, ...) -> N images: while the pool fills, each image
        goes in and comes back; once it is full, with probability 1/2 an
        image is swapped with a random stored one (which comes back), else
        it comes back itself.  ``pool_size`` 0 returns ``images``."""
        if self.pool_size == 0:
            return images
        out = []
        for image in images:
            image = image[None]
            if self.num_imgs < self.pool_size:
                self.num_imgs += 1
                self.images.append(image)
                out.append(image)
            elif self.rng.uniform(0, 1) > 0.5:
                i = self.rng.randint(0, self.pool_size - 1)
                out.append(self.images[i].clone())
                self.images[i] = image
            else:
                out.append(image)
        return torch.cat(out, 0)
