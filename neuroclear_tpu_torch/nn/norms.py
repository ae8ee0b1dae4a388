"""Norm-layer factory, the port of ``neuroclear_tpu/nn/norms.py`` for the
production 'instance' norm only (affine-free, no running statistics)."""

from __future__ import annotations

import dataclasses

from .core import InstanceNorm


@dataclasses.dataclass(frozen=True)
class NormSpec:
    kind: str  # 'instance'
    dim: int = 3

    def layer(self, act=None, plain: bool = False) -> InstanceNorm:
        """The norm followed by ``act``, fused."""
        return InstanceNorm(act, plain=plain)


def get_norm_spec(norm_type: str = "instance", dim: int = 3) -> NormSpec:
    if norm_type == "instance":
        return NormSpec("instance", dim)
    raise NotImplementedError(f"normalization layer [{norm_type}] is not ported yet "
                              "(ROADMAP.md, queue 1)")
