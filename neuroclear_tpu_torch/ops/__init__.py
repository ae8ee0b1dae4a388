"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

``KERNELS`` names each kernel wrapper; each wrapper carries ``launches``, the
count of its kernel launches, which a run resets and reads to show that the
main path went through the kernels.
"""

from . import inorm, wconv

KERNELS = {
    "wconv3x3x3": wconv.conv3d,
    "pair_sums": inorm.pair_sums,
    "affine_map_act": inorm.affine_map_act,
}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
