"""Conv and matmul FLOPs of a run, by the JAX package's definition
(``scripts/count_step_flops.py``): 2 x out x prod(kernel) x cin for every
convolution (forward, input gradient and weight gradient alike) and 2 x out
x K for every product; elementwise, norm and reduction work is not counted.

``FlopCounter`` is a dispatch mode: every ``aten`` convolution, convolution
gradient and matrix product that runs inside it adds its count.  Each
convolution is counted as the JAX package's ``conv_general_dilated`` of the
same function, zeros of a dilation included: a transposed conv as the
input-dilated conv that ``conv_transpose`` is, its gradients as JAX's
transpose rules write them (the input gradient 2 x numel(x) x prod(kernel) x
cout, the weight gradient 2 x numel(w) x numel(gy) / cout).  So the count of
a step equals JAX's ``count_jaxpr`` of the same step.

A hand kernel launched through ctypes is not an ``aten`` operation: each
wrapper calls ``hand`` with its own count where it launches its kernel, and
its plain version, a sum of ``aten`` products, is counted by the mode.  The
two give the same number (``tests/test_torch_count_step_flops.py``), so the
count of a step does not depend on the route a conv takes.
"""

from __future__ import annotations

import collections
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_aten = torch.ops.aten
_OPEN: list = []  # the counters open, innermost last


def conv(out_numel: int, contraction: int) -> int:
    """2 x out x (the products summed into each output element)."""
    return 2 * int(out_numel) * int(contraction)


def hand(kind: str, flops: int) -> None:
    """A hand kernel's FLOPs, added to every open counter under ``kind``."""
    for counter in _OPEN:
        counter.add(kind, flops)


def _aten_flops(func, args, out) -> tuple:
    """(kind, FLOPs) of one ``aten`` call, or None."""
    packet = func.overloadpacket
    if packet in (_aten.mm, _aten.bmm):
        return "matmul", conv(out.numel(), args[0].shape[-1])
    if packet in (_aten.addmm, _aten.baddbmm):
        return "matmul", conv(out.numel(), args[1].shape[-1])
    if packet is _aten.convolution:
        # (input, weight, bias, stride, padding, dilation, transposed, ...,
        # groups): cin per group is weight dim 0 of a transposed conv
        w, transposed, groups = args[1], args[6], args[8]
        cin = w.shape[0] // groups if transposed else w.shape[1]
        return "conv", conv(out.numel(), math.prod(w.shape[2:]) * cin)
    if packet is _aten.convolution_backward:
        gy, x, w, mask = args[0], args[1], args[2], args[10]
        taps, cout = math.prod(w.shape[2:]), gy.shape[1]
        flops = 0
        if mask[0]:
            flops += conv(x.numel(), taps * cout)
        if mask[1]:
            flops += conv(w.numel(), gy.numel() // cout)
        return "conv_backward", flops
    return None


class FlopCounter(TorchDispatchMode):
    """``with FlopCounter() as c: ...``: ``c.total`` is the FLOPs of what ran
    inside, ``c.by_kind`` their split ("conv", "conv_backward", "matmul" from
    ``aten``; the hand kernels' names from ``hand``)."""

    def __init__(self):
        super().__init__()
        self.by_kind = collections.Counter()

    @property
    def total(self) -> int:
        return sum(self.by_kind.values())

    def add(self, kind: str, flops: int) -> None:
        self.by_kind[kind] += int(flops)

    def __enter__(self):
        _OPEN.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _OPEN.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        counted = _aten_flops(func, args, out)
        if counted is not None:
            self.add(*counted)
        return out
