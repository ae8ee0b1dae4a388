"""The port's random host transform chain (``data/base_dataset.py``,
``data/warp.py``) and the datasets that run it, against cv2 and the JAX
package on the CPU.

``warp_affine_linear`` is held bit for bit against ``cv2.warpAffine(...,
INTER_LINEAR)`` (OpenCV 5.0) on uint8, uint16 and float32 slices at all 360
rotation angles of ``rotate_clean``'s geometry, on square and non-square
slices; ``rotate_clean`` bit for bit against the JAX package's (cv2) one;
the chain with the same ``params`` (angle, crop position, flip axis) bit for
bit against the JAX chain; the ``singlevolume`` host path, the ``cube`` and
``simulationcrop`` datasets against the JAX datasets.
"""

import math
import types

import cv2
import numpy as np
import pytest

from neuroclear_tpu.data import base_dataset as jax_base
from neuroclear_tpu.data.simulationcrop_dataset import SimulationCropDataSet as JaxSimCrop
from neuroclear_tpu.data.singlevolume_dataset import SingleVolumeDataset as JaxSingleVolume
from neuroclear_tpu.ops.rotation import rotation_geometry as jax_geometry
from neuroclear_tpu_torch.data import base_dataset, find_dataset_using_name
from neuroclear_tpu_torch.data.simulationcrop_dataset import SimulationCropDataSet
from neuroclear_tpu_torch.data.singlevolume_dataset import SingleVolumeDataset
from neuroclear_tpu_torch.data.warp import (rotate_clean, rotation_geometry_f64,
                                            warp_affine_linear)
from neuroclear_tpu_torch.utils import tiffio

DTYPES = [np.uint8, np.uint16, np.float32]


def _image(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    top = 255 if dtype == np.uint8 else 65535
    return (rng.random(shape) * top).astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(40, 40), (37, 52), (61, 45), (13, 9)])
def test_warp_is_cv2_bit_for_bit_at_every_angle(dtype, shape):
    img = _image(shape, dtype, seed=shape[0])
    h, w = shape
    for angle in range(360):
        g = jax_geometry(float(w), float(h), float(angle), xp=math)
        m = np.array([[g.fwd[0], g.fwd[1], g.fwd[2]], [g.fwd[3], g.fwd[4], g.fwd[5]]])
        want = cv2.warpAffine(img, m, (int(g.new_w), int(g.new_h)), flags=cv2.INTER_LINEAR)
        got = warp_affine_linear(img, m, (int(g.new_w), int(g.new_h)))
        assert got.dtype == want.dtype and np.array_equal(got, want), angle


@pytest.mark.parametrize("shape", [(40, 40), (37, 52), (700, 700)])
def test_host_geometry_is_the_jax_float64_geometry(shape):
    h, w = shape
    for angle in range(360):
        g = jax_geometry(float(w), float(h), float(angle), xp=math)
        assert rotation_geometry_f64(float(w), float(h), float(angle)) == (
            g.new_w, g.new_h, g.x1, g.y1, g.crop_w, g.crop_h, g.fwd)


def test_warp_one_thirty_second_pixel_off_shows():
    """A forward matrix moved by 1/32 pixel (the quantum of OpenCV 4's
    fixed-point warp) changes the output: the bitwise check would see it."""
    img = _image((40, 40), np.uint16)
    g = jax_geometry(40.0, 40.0, 37.0, xp=math)
    m = np.array([[g.fwd[0], g.fwd[1], g.fwd[2]], [g.fwd[3], g.fwd[4], g.fwd[5]]])
    off = m.copy()
    off[0, 2] += 1 / 32
    size = (int(g.new_w), int(g.new_h))
    assert not np.array_equal(warp_affine_linear(img, off, size),
                              cv2.warpAffine(img, m, size, flags=cv2.INTER_LINEAR))


@pytest.mark.parametrize("dtype", DTYPES)
def test_rotate_clean_of_a_stack_is_jaxs_per_slice(dtype):
    vol = _image((3, 33, 41), dtype, seed=5)
    for angle in range(0, 360, 7):
        want = jax_base.rotate_clean_3d_xy(vol, angle)
        got = rotate_clean(vol, angle)
        assert got.shape == want.shape and np.array_equal(got, want), angle


def _opt(preprocess, crop=(6, 10, 12)):
    return types.SimpleNamespace(preprocess=preprocess, crop_size=list(crop), crop_portion=50,
                                 dataset_mode="cube")


@pytest.mark.parametrize("preprocess", [
    "random3Drotate_randomcrop_randomflip_addColorChannel_addBatchChannel",
    "randomcrop_randomflip_addColorChannel", "random3Drotate_addColorChannel",
    "randomcrop_centercrop_reorderColorChannel", "randomflip"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_chain_with_params_is_the_jax_chain(preprocess, dtype):
    """The same params through both chains: bit-equal float32 arrays, the
    division in float64 before the cast (normalize_dtype's order)."""
    vol = _image((8, 30, 34), dtype, seed=2)
    opt = _opt(preprocess)
    rng = np.random.default_rng(3)
    for _ in range(6):
        params = base_dataset.get_params(opt, (8, 21, 24), rng)
        got = base_dataset.get_transform(opt, params)(vol)
        want = jax_base.get_transform(opt, params)(vol)
        assert got.dtype == want.dtype == np.float32 and got.flags.c_contiguous
        assert got.shape == want.shape and np.array_equal(got, want), params


def test_params_and_random_draws_cover_their_ranges():
    opt = _opt("random3Drotate_randomcrop_randomflip")
    rng = np.random.default_rng(0)
    draws = [base_dataset.get_params(opt, (8, 12, 13), rng) for _ in range(5000)]
    assert {d["angle_3D"] for d in draws} == set(range(360))
    assert {d["flip_axis"] for d in draws} == {0, 1, 2}
    assert {d["crop_pos"] for d in draws} == {(z, y, x) for z in range(3) for y in range(3)
                                              for x in range(2)}
    vol = np.arange(4 * 5 * 6, dtype=np.uint16).reshape(4, 5, 6)
    flips = [base_dataset.random_flip(vol, rng) for _ in range(400)]
    assert 0.4 < np.mean([f[0, 0, 0] != 0 for f in flips]) < 0.95
    crop = base_dataset.random_crop(vol, (2, 0, 3), rng)
    assert crop.shape == (2, 5, 3)


def test_random_chain_is_the_generators():
    """Without params the chain draws from the generator it is given: two
    generators of one seed give one output."""
    vol = _image((8, 30, 30), np.uint16, seed=1)
    opt = _opt("random3Drotate_random90rotate_randomcrop_randomflip_addColorChannel",
               crop=(6, 12, 12))
    a = base_dataset.get_transform(opt, rng=np.random.default_rng(7))
    b = base_dataset.get_transform(opt, rng=np.random.default_rng(7))
    for _ in range(3):
        x, y = a(vol), b(vol)
        assert x.shape == (6, 12, 12, 1) and np.array_equal(x, y)


def test_permutate_is_jaxs():
    vol = _image((3, 4, 5), np.float32)
    assert np.array_equal(base_dataset.permutate(vol), jax_base.permutate(vol))


def test_singlevolume_host_path_is_jaxs(tmp_path):
    """``__getitem__`` runs the host chain on the volume, ten items an epoch."""
    vol = _image((10, 12, 14), np.uint16, seed=4)
    np.save(tmp_path / "v.npy", vol)
    opt = types.SimpleNamespace(dataroot=str(tmp_path), preprocess="addColorChannel_addBatchChannel",
                                crop_size=[10, 12, 14], isTrain=True, dataset_mode="singlevolume")
    ours = SingleVolumeDataset.from_options(opt, np.random.default_rng(0))
    ref = JaxSingleVolume(opt)
    assert len(ours) == len(ref) == 10
    assert np.array_equal(ours[3]["A"], ref[3]["A"]) and ours[3]["A_paths"] == ref[3]["A_paths"]


def test_simulationcrop_cuts_the_jax_datasets_region(tmp_path, monkeypatch):
    """The fixed crop of the original (700^3 at (136, 104, 120)), then the
    diceImage grid; at a small crop in place of the 700^3 one (the same
    code path), the cubes equal the JAX dataset's."""
    assert SimulationCropDataSet.CROP_OFFSET == JaxSimCrop.CROP_OFFSET == (136, 104, 120)
    assert SimulationCropDataSet.CROP_SIZE == JaxSimCrop.CROP_SIZE == 700
    for cls in (SimulationCropDataSet, JaxSimCrop):
        monkeypatch.setattr(cls, "CROP_OFFSET", (3, 2, 1))
        monkeypatch.setattr(cls, "CROP_SIZE", 20)
    vol = _image((26, 25, 24), np.uint16, seed=6)
    tiffio.imwrite(str(tmp_path / "v.tif"), vol)
    opt = types.SimpleNamespace(dataroot=str(tmp_path), dice_size=[8, 8, 8], overlap=2,
                                border_cut=1, preprocess="addColorChannel",
                                dataset_mode="simulationcrop", isTrain=False)
    ours = find_dataset_using_name("simulationcrop")(opt)
    ref = JaxSimCrop(opt)
    assert ours.size_original() == ref.size_original() == (20, 20, 20)
    assert ours.size() == ref.size() and len(ours) == len(ref)
    for i in range(len(ref)):
        assert np.array_equal(ours[i]["A"], ref[i]["A"])
