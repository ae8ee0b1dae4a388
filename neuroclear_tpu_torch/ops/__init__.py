"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

``KERNELS`` names each kernel wrapper; each wrapper carries ``launches``, the
count of its kernel launches, which a run resets and reads to show that the
main path went through the kernels.  The conv's input and weight gradients
count apart from its forward, and the norm's backward sums apart from its
forward statistics.  ``conv3x3`` is the dense-K conv that
``NEUROCLEAR_PALLAS_CONV=1`` switches on.
"""

from . import conv3x3, inorm, wconv

KERNELS = {
    "wconv3x3x3": wconv.conv3d,
    "wconv_dx": wconv.conv3d_dx,
    "wconv_dw": wconv.conv3d_dw,
    "pair_sums": inorm.pair_sums,
    "affine_map_act": inorm.affine_map_act,
    "pair_sums_gy": inorm.pair_sums_gy,
    "bwd_map": inorm.bwd_map,
    "conv3x3": conv3x3.conv3d,
}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
