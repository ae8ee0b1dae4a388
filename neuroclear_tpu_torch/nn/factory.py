"""Network factory, the port of ``neuroclear_tpu/nn/factory.py`` for the
production generator only."""

from __future__ import annotations

from . import generators as G


def define_G(input_nc: int, output_nc: int, ngf: int, netG: str, norm: str = "instance",
             plain: bool = False):
    """Return a generator module (weights zero until loaded).  ``ngf`` is
    kept for the reference's signature; UNetDeconv derives its widths from
    input_nc, as in the JAX package."""
    if netG == "unet_deconv":
        return G.UNetDeconv(1, output_nc, norm=norm, plain=plain)
    raise NotImplementedError(f"generator [{netG}] is not ported yet (ROADMAP.md, queue 1)")
