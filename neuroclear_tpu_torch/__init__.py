"""neuroclear_tpu_torch: the PyTorch/CUDA port of neuroclear_tpu for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package ``neuroclear_tpu`` stays the reference; this package imports
neither it nor JAX.  Its subpackages mirror the JAX package's names.  Tensors
are channels-last (N, D, H, W, C) at the public functions, as in the JAX
package.  Entry points run on the card unless the caller passes
``device="cpu"``; they never fall back to the CPU on their own.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, ``cuda`` when None.  Raises when a CUDA
    device is asked for and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev}: the port runs on cuda or cpu")
    return dev
