"""Norm-layer factory, the port of ``neuroclear_tpu/nn/norms.py``.

  * 'instance' (production): affine-free, no running statistics, the
    following activation fused (``core.InstanceNorm``, the norm kernels).
  * 'batch': ``BatchNorm``, affine (``scale`` ~ N(1, gain), ``offset`` 0)
    with the buffers ``running_mean`` (0) and ``running_var`` (1).  It
    normalises with the batch's statistics over batch and space (biased
    variance, in f32 (float64 for a float64 input), cast back) unless its ``use_running`` switch is on,
    which ``set_eval`` turns on explicitly (``--eval``; the JAX package's
    ``eval_mode``), never ``nn.Module.training``.  Its forward does not touch
    the buffers: the models refresh them once per step in a pass of their
    own (``BaseModel.refresh_norm_stats``), through ``collect_batch_stats``
    and ``ema_update_stats``, with the biased variance, as the JAX package
    does.  Under data parallelism (``parallel/train_parallel.py``) its
    statistics are the global batch's, as JAX's over a sharded batch: the
    two passes' sums (Σx, then Σ(x − mean)²) are all-reduced over the ranks
    by a function whose backward all-reduces the gradient
    (``set_cross_rank``).
  * 'spectral' and 'none': identity (spectral norm is applied at the conv
    level in the ``*_SN`` discriminators).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .core import InstanceNorm
from ..ops.inorm import activation

EPS = 1e-5
NORMS = ("instance", "batch", "spectral", "none")

# Under data parallelism: (the differentiable sum over the ranks, the world
# size); None in one process
_CROSS_RANK = None

# Collector of batch statistics: while a list is installed here, every
# BatchNorm forward in batch-statistics mode appends (module, mean, var)
_STATS_COLLECTOR: list | None = None


class collect_batch_stats:
    """Context manager: collect (module, batch mean, batch var) of every
    BatchNorm forward run inside it."""

    def __init__(self):
        self.stats = []

    def __enter__(self):
        global _STATS_COLLECTOR
        self._prev = _STATS_COLLECTOR
        _STATS_COLLECTOR = self.stats
        return self.stats

    def __exit__(self, *exc):
        global _STATS_COLLECTOR
        _STATS_COLLECTOR = self._prev
        return False


def set_cross_rank(sum_fn, world: int) -> None:
    """Take every batch norm's statistics over the ranks: ``sum_fn``
    all-reduces a tensor (and its gradient), ``world`` ranks hold equal
    shares of the batch."""
    global _CROSS_RANK
    _CROSS_RANK = (sum_fn, world)


class local_stats:
    """Context manager: batch norms take this process's batch statistics
    inside it (a single-process reference run beside data parallelism)."""

    def __enter__(self):
        global _CROSS_RANK
        self._prev, _CROSS_RANK = _CROSS_RANK, None

    def __exit__(self, *exc):
        global _CROSS_RANK
        _CROSS_RANK = self._prev
        return False


def batch_stats(xf: torch.Tensor, axes: tuple):
    """(mean, biased variance) of ``xf`` over ``axes`` and, under
    ``set_cross_rank``, over the ranks: two passes, each an all-reduced
    sum."""
    if _CROSS_RANK is None:
        mean = xf.mean(dim=axes)
        return mean, torch.square(xf - mean).mean(dim=axes)
    sum_fn, world = _CROSS_RANK
    n = world * (xf.numel() // xf.shape[-1])
    mean = sum_fn(xf.sum(dim=axes)) / n
    return mean, sum_fn(torch.square(xf - mean).sum(dim=axes)) / n


@torch.no_grad()
def ema_update_stats(stats, momentum: float = 0.1) -> None:
    """For each collected (module, mean, var): ``running = (1 - momentum) *
    running + momentum * batch``, in f32, written into the module's buffers."""
    for module, mean, var in stats:
        module.running_mean.copy_((1 - momentum) * module.running_mean + momentum * mean)
        module.running_var.copy_((1 - momentum) * module.running_var + momentum * var)


class BatchNorm(nn.Module):
    """Batch norm over every axis but the last (channels-last), eps 1e-5,
    then ``act`` ('relu', 'leaky' or None), as ``NormSpec.apply`` and the
    activation after it."""

    def __init__(self, nc: int, act=None):
        super().__init__()
        self.act = act
        self.use_running = False
        self.scale = nn.Parameter(torch.ones(nc))
        self.offset = nn.Parameter(torch.zeros(nc))
        self.register_buffer("running_mean", torch.zeros(nc))
        self.register_buffer("running_var", torch.ones(nc))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x if x.dtype == torch.float64 else x.float()
        if self.use_running:
            mean, var = self.running_mean, self.running_var
        else:
            mean, var = batch_stats(xf, tuple(range(x.dim() - 1)))
            if _STATS_COLLECTOR is not None:
                _STATS_COLLECTOR.append((self, mean.detach(), var.detach()))
        y = (xf - mean) * torch.rsqrt(var + EPS)
        y = y * self.scale + self.offset
        return activation(y.to(x.dtype), self.act)


class NoNorm(nn.Module):
    """Identity, then ``act``."""

    def __init__(self, act=None):
        super().__init__()
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return activation(x, self.act)


def set_eval(net: nn.Module, on: bool = True) -> None:
    """Switch every BatchNorm of ``net`` to its running statistics (``on``)
    or back to the batch's."""
    for m in net.modules():
        if isinstance(m, BatchNorm):
            m.use_running = on


@dataclasses.dataclass(frozen=True)
class NormSpec:
    kind: str  # 'instance' | 'batch' | 'none'
    dim: int = 3

    @property
    def has_params(self) -> bool:
        return self.kind == "batch"

    def layer(self, nc: int, act=None, plain: bool = False) -> nn.Module:
        """The norm over ``nc`` channels followed by ``act`` (fused for the
        instance norm)."""
        if self.kind == "instance":
            return InstanceNorm(act, plain=plain)
        if self.kind == "batch":
            return BatchNorm(nc, act)
        return NoNorm(act)


def get_norm_spec(norm_type: str = "instance", dim: int = 3) -> NormSpec:
    if norm_type in ("instance", "batch"):
        return NormSpec(norm_type, dim)
    if norm_type in ("spectral", "none"):
        return NormSpec("none", dim)
    raise NotImplementedError(f"normalization layer [{norm_type}] is not found")
