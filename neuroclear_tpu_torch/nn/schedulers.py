"""Learning-rate policies, a copy of ``neuroclear_tpu/nn/schedulers.py``
(the original repository's ``models/networks.py`` ``get_scheduler``).

An ``LRController`` is stepped once per ``update_learning_rate()`` call, per
iteration in the single-volume trainer; its ``scale`` multiplies the base
learning rate, which the model writes into its optimizers' parameter groups
before each step.

Policies: linear | constant | step | plateau | cosine.
"""

from __future__ import annotations

import math


class LRController:
    def __init__(self, policy: str, opt):
        self.policy = policy
        self.count = opt.epoch_count - 1 if hasattr(opt, "epoch_count") else 0
        self.n_epochs = getattr(opt, "n_epochs", 100)
        self.n_epochs_decay = getattr(opt, "n_epochs_decay", 100)
        self.epoch_count = getattr(opt, "epoch_count", 1)
        self.lr_decay_iters = getattr(opt, "lr_decay_iters", 50)
        # plateau state (torch ReduceLROnPlateau(mode=min, factor=0.2,
        # threshold=0.01, patience=5) semantics, rel threshold)
        self._best = math.inf
        self._bad = 0
        self._plateau_scale = 1.0
        self.scale = self._compute(self.count)

    def _compute(self, epoch: int) -> float:
        if self.policy == "linear":
            return 1.0 - max(0, epoch + 1 + self.epoch_count - self.n_epochs) / float(
                self.n_epochs_decay + 1)
        if self.policy == "constant":
            return 1.0
        if self.policy == "step":
            return 0.1 ** (epoch // self.lr_decay_iters)
        if self.policy == "cosine":
            return 0.5 * (1.0 + math.cos(math.pi * epoch / self.n_epochs))
        if self.policy == "plateau":
            return self._plateau_scale
        raise NotImplementedError(
            f"learning rate policy [{self.policy}] is not implemented")

    def state(self):
        """Schedule position as a flat float vector (checkpointed alongside
        the optimizer state so resume continues the lr trajectory)."""
        return [float(self.count), float(self._best), float(self._bad),
                float(self._plateau_scale)]

    def restore(self, vec) -> None:
        self.count = int(vec[0])
        self._best = float(vec[1])
        self._bad = int(vec[2])
        self._plateau_scale = float(vec[3])
        self.scale = self._compute(self.count)

    def step(self, metric: float = 0.0) -> float:
        self.count += 1
        if self.policy == "plateau":
            if metric < self._best * (1 - 0.01):
                self._best = metric
                self._bad = 0
            else:
                self._bad += 1
                if self._bad > 5:
                    self._plateau_scale *= 0.2
                    self._bad = 0
        self.scale = self._compute(self.count)
        return self.scale
