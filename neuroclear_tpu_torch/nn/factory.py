"""Network factory, the port of ``neuroclear_tpu/nn/factory.py`` for the
production Apollo nets: the generators ``unet_deconv`` and
``deep_linear_gen`` and the discriminators ``basic`` and ``n_layers``."""

from __future__ import annotations

from . import discriminators as D
from . import generators as G


def define_G(input_nc: int, output_nc: int, ngf: int, netG: str, norm: str = "instance",
             plain: bool = False):
    """Return a generator module (weights zero until loaded).  ``ngf`` is
    kept for the reference's signature; these generators derive their widths
    from input_nc, as in the JAX package."""
    if netG == "unet_deconv":
        return G.UNetDeconv(1, output_nc, norm=norm, plain=plain)
    if netG == "deep_linear_gen":
        return G.DeepLinearGenerator(input_nc, output_nc, plain=plain)
    raise NotImplementedError(f"generator [{netG}] is not ported yet (ROADMAP.md, queue 1)")


def define_D(input_nc: int, ndf: int, netD: str, n_layers_D: int = 3, norm: str = "instance",
             use_sigmoid: bool = False, dimension: int = 2, plain: bool = False):
    """Return a discriminator module (weights zero until loaded)."""
    if netD == "basic":
        return D.NLayerDiscriminator(input_nc, ndf, 3, norm, use_sigmoid, dimension, plain)
    if netD == "n_layers":
        return D.NLayerDiscriminator(input_nc, ndf, n_layers_D, norm, use_sigmoid, dimension,
                                     plain)
    raise NotImplementedError(f"discriminator [{netD}] is not ported yet "
                              "(ROADMAP.md, queue 1)")
