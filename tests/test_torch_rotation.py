"""The rotation of the port's augmentation (``neuroclear_tpu_torch/ops/
rotation.py`` and ``ops/augment.py::sample_rotated_crop``) against the JAX
package's device chain on the CPU.

The JAX trainer computes the rotation's geometry in float32 inside its
jitted sampler (``rotation_geometry(jnp.float32(X), ..., xp=jnp)``); the
port computes it on the host in numpy float32 in the same operation order,
so its integer geometry is held equal to the jitted one.  Their sin and cos
differ in the last bit at most angles, so the crops' values are held within
an absolute 1e-4 on the [0, 1] scale (measured worst over this file's cases:
1.0e-5, on uint16 noise, the steepest volume there is).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroclear_tpu.ops.augment import sample_rotated_crop as jax_sample_rotated_crop
from neuroclear_tpu.ops.rotation import rotation_geometry as jax_rotation_geometry
from neuroclear_tpu_torch.data.singlevolume_dataset import SingleVolumeDataset
from neuroclear_tpu_torch.ops.augment import (ROT90_ANGLES, crop_draws, sample_rotated_crop)
from neuroclear_tpu_torch.ops.rotation import rotation_geometry

ANGLES = [float(a) for a in range(360)] + [a for a in ROT90_ANGLES if a < 0]
CROP_ATOL = 1e-4
# 256 x 320 slices (Y x X): the angles whose integer geometry differs from
# the jitted chain's (ROADMAP.md, queue 3)
NON_SQUARE_DIFFERING = [23.0, 113.0]


def _jitted_geometry(x, y):
    return jax.jit(lambda a: jax_rotation_geometry(jnp.float32(x), jnp.float32(y), a, xp=jnp))


def _ints(g) -> tuple:
    return tuple(int(v) for v in g[:6])


@pytest.mark.parametrize("n", [96, 160, 700])
def test_geometry_equals_the_jitted_chain_on_square_slices(n):
    jax_geom = _jitted_geometry(n, n)
    bad = [a for a in ANGLES
           if _ints(jax_geom(jnp.float32(a))) != _ints(rotation_geometry(n, n, a))]
    assert not bad, bad


def test_geometry_differences_on_a_non_square_slice():
    jax_geom = _jitted_geometry(320, 256)
    bad = [a for a in ANGLES
           if _ints(jax_geom(jnp.float32(a))) != _ints(rotation_geometry(320, 256, a))]
    assert bad == NON_SQUARE_DIFFERING


def test_180_degrees_follows_the_device_chain_not_the_float64_host_form():
    """At 180 degrees the float32 inscribed crop of an N x N slice is N - 1
    wide and high; the JAX package's float64 host form gives N."""
    g = rotation_geometry(160, 160, 180.0)
    assert (g.crop_w, g.crop_h) == (159, 159)
    host = jax_rotation_geometry(160, 160, 180.0)
    assert (host.crop_w, host.crop_h) == (160, 160)


def _crop_cases():
    rng = np.random.default_rng(5)
    angles = [0.0, 45.0, 90.0, 180.0, 270.0, 359.0, *ROT90_ANGLES]
    angles += [float(a) for a in rng.choice([a for a in range(360)
                                             if a not in NON_SQUARE_DIFFERING], 6)]
    return angles


@pytest.mark.parametrize("angle", _crop_cases())
def test_rotated_crop_matches_jax(angle):
    """Same angle, offsets (both ends of the range and one inside) and
    flips: the crop of jitted ``sample_rotated_crop(rotate=True)`` with
    ``augment_core``'s flips, on a square and a non-square volume."""
    rng = np.random.default_rng(int(angle) % 360)
    worst = 0.0
    for shape, crop in (((20, 48, 48), (12, 24, 20)), ((16, 40, 52), (8, 20, 16))):
        vol = rng.integers(0, 65535, shape, dtype=np.uint16)
        z_n, y_n, x_n = shape
        g = rotation_geometry(x_n, y_n, angle)
        if g.crop_h < crop[1] or g.crop_w < crop[2]:
            assert shape[1] != shape[2]  # the square volume fits at every angle
            continue
        ref_fn = jax.jit(lambda v, a, o: jax_sample_rotated_crop(v, a, o, crop, 1 / 65535.0,
                                                                 rotate=True))
        tv = torch.from_numpy(vol.astype(np.int32))
        for offsets, flips in (((0, 0, 0), (False, False, False)),
                               ((z_n - crop[0], g.crop_h - crop[1], g.crop_w - crop[2]),
                                (True, False, True)),
                               ((1, (g.crop_h - crop[1]) // 2, (g.crop_w - crop[2]) // 3),
                                (False, True, True))):
            ref = ref_fn(jnp.asarray(vol), jnp.float32(angle),
                         tuple(jnp.int32(o) for o in offsets))
            for axis, f in enumerate(flips):
                if f:
                    ref = jnp.flip(ref, axis)
            got = sample_rotated_crop(tv, angle, offsets, crop, 1 / 65535.0, flips)
            assert got.shape == crop and got.dtype == torch.float32
            worst = max(worst, float(np.abs(got.numpy() - np.asarray(ref)).max()))
    assert worst <= CROP_ATOL, worst


def test_draws_stay_inside_the_inscribed_crop_at_180():
    """At 180 degrees on a 48 x 48 slice the inscribed crop is 47 x 47:
    offsets range over it, both ends reached, and a 48-wide crop does not
    fit."""
    gen = torch.Generator().manual_seed(0)
    g = rotation_geometry(48, 48, 180.0)
    assert (g.crop_h, g.crop_w) == (47, 47)
    ys, xs = set(), set()
    for _ in range(300):
        (_, y0, x0), _ = crop_draws((10, 48, 48), (8, 44, 40), gen, 180.0)
        assert y0 + 44 <= g.crop_h and x0 + 40 <= g.crop_w
        ys.add(y0)
        xs.add(x0)
    assert ys == set(range(4)) and xs == set(range(8))
    with pytest.raises(ValueError, match="does not fit"):
        crop_draws((10, 48, 48), (8, 48, 40), gen, 180.0)


def test_dataset_draws_each_rotation():
    """random3Drotate draws angles on {0..359}, random90rotate the six of
    augment_core, and the worst-case fit is checked up front."""
    vol = np.random.default_rng(0).integers(0, 65535, (12, 40, 40), dtype=np.uint16)
    gen = torch.Generator().manual_seed(1)
    tail = "randomcrop_randomflip_addColorChannel_addBatchChannel"
    ds = SingleVolumeDataset(vol, (8, 24, 24), "random3Drotate_" + tail, "cpu")
    angles = {ds.draws(gen)[0] for _ in range(5000)}
    assert angles == set(range(360))
    ds90 = SingleVolumeDataset(vol, (8, 24, 24), "random90rotate_" + tail, "cpu")
    assert {ds90.draws(gen)[0] for _ in range(200)} == set(ROT90_ANGLES)
    sample = ds.sample(gen)
    assert sample.shape == (1, 8, 24, 24, 1) and sample.dtype == torch.float32
    assert 0.0 <= float(sample.min()) and float(sample.max()) <= 1.0
    with pytest.raises(ValueError, match="worst-case"):
        SingleVolumeDataset(vol, (8, 29, 24), "random3Drotate_" + tail, "cpu")
