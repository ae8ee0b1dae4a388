"""Network factory, the port of ``neuroclear_tpu/nn/factory.py``: every
``--netG`` (12) and ``--netD`` (6) name of the JAX package, with its
argument rules; an unknown name raises NotImplementedError, as in JAX."""

from __future__ import annotations

from . import discriminators as D
from . import generators as G

NET_G = ("unet_twoouts", "unet_deconv", "unet_vanilla", "resnet_9blocks", "resnet_6blocks",
         "VGG", "linearkernel", "linearkernel_double", "linearkernel_LK31", "linearkernel_NC",
         "fixed_kernel", "deep_linear_gen")
NET_D = ("basic", "basic_SN", "n_layers", "n_layers_SN", "pixel", "kernelGAN")


def define_G(input_nc: int, output_nc: int, ngf: int, netG: str, norm: str = "instance",
             plain: bool = False, kernel_size: int = 9, given_psf=None, noise_setting=None,
             dimension: int = 3):
    """Return a generator module (weights zero until loaded).  As in the JAX
    package the U-Nets derive their widths from input_nc (``unet_twoouts``
    is ``UNetTwoOuts(4, ...)``), ``resnet_*`` takes ``ngf``, ``VGG`` is a
    VGG16 with two classes, and ``fixed_kernel`` takes its kernel shape from
    ``given_psf`` (9 per axis without one) and (sigma, peak) from
    ``noise_setting`` ((0.1, 0.1) without one)."""
    if netG == "unet_twoouts":
        return G.UNetTwoOuts(4, output_nc, plain=plain)
    if netG == "unet_deconv":
        return G.UNetDeconv(1, output_nc, norm=norm, plain=plain)
    if netG == "unet_vanilla":
        return G.UNetVanilla(1, output_nc, norm=norm, plain=plain)
    if netG in ("resnet_9blocks", "resnet_6blocks"):
        return G.ResnetGenerator(input_nc, output_nc, ngf, norm=norm,
                                 n_blocks=9 if netG == "resnet_9blocks" else 6, plain=plain)
    if netG == "VGG":
        return G.VGGNet(input_nc, num_classes=2, vgg_type="VGG16", plain=plain)
    if netG in ("linearkernel", "linearkernel_double", "linearkernel_LK31"):
        return G.LinearKernel(input_nc, output_nc, 31 if netG == "linearkernel_LK31"
                              else kernel_size, dim=dimension,
                              double=netG == "linearkernel_double", plain=plain)
    if netG == "linearkernel_NC":
        return G.LinearKernelNC(input_nc, output_nc, kernel_size, dim=dimension, plain=plain)
    if netG == "fixed_kernel":
        ks = (tuple(given_psf.shape[-dimension:]) if given_psf is not None
              else (9,) * dimension)
        sigma, peak = noise_setting if noise_setting is not None else (0.1, 0.1)
        return G.FixedLinearKernel(ks, sigma, peak, dim=dimension)
    if netG == "deep_linear_gen":
        return G.DeepLinearGenerator(input_nc, output_nc, plain=plain)
    raise NotImplementedError(f"Generator model name [{netG}] is not recognized")


def define_D(input_nc: int, ndf: int, netD: str, n_layers_D: int = 3, norm: str = "instance",
             use_sigmoid: bool = False, dimension: int = 2, plain: bool = False):
    """Return a discriminator module (weights zero until loaded)."""
    if netD in ("basic", "basic_SN"):
        return D.NLayerDiscriminator(input_nc, ndf, 3, norm, use_sigmoid, dimension, plain,
                                     spectral=netD == "basic_SN")
    if netD in ("n_layers", "n_layers_SN"):
        return D.NLayerDiscriminator(input_nc, ndf, n_layers_D, norm, use_sigmoid, dimension,
                                     plain, spectral=netD == "n_layers_SN")
    if netD == "pixel":
        return D.PixelDiscriminator(input_nc, ndf, norm, dimension, plain)
    if netD == "kernelGAN":
        return D.KernelPatchDiscriminator(input_nc, ndf, 5, norm, dimension, plain)
    raise NotImplementedError(f"Discriminator model name [{netD}] is not recognized")
