"""The per-cube loop's host modules against the JAX package's, on the same
arrays, bit for bit: ``DiceCube``, ``Assemble_Dice`` (overlap 0 and > 0,
flip-TTA, histogram matching, the percentile stretch, each output dtype),
the preprocess chain (``get_transform``, ``normalize_dtype``'s float64
division), the dataset and its loader (``create_dataset``: order, batching,
``max_dataset_size``), and ``match_histograms`` /
``crop_for_dicing``.  Numpy on both sides: no tolerance."""

from collections import OrderedDict
from types import SimpleNamespace

import numpy as np
import pytest

from neuroclear_tpu import data as jax_data
from neuroclear_tpu.data.base_dataset import get_transform as jax_get_transform
from neuroclear_tpu.data.dicing import DiceCube as JaxDiceCube
from neuroclear_tpu.utils import imageops as jax_imageops
from neuroclear_tpu.utils import tiffio as jax_tiffio
from neuroclear_tpu.utils.assemble import Assemble_Dice as JaxAssemble
from neuroclear_tpu_torch import data as port_data
from neuroclear_tpu_torch.data.base_dataset import get_transform
from neuroclear_tpu_torch.data.dicing import DiceCube
from neuroclear_tpu_torch.utils import imageops
from neuroclear_tpu_torch.utils.assemble import Assemble_Dice


def _opt(**kw):
    base = dict(dice_size=[8, 8, 8], overlap=2, border_cut=2, data_type="uint16",
                skip_real=False, histogram_match=False, normalize_intensity=False,
                sat_level=[0.25, 99.75], preprocess="addColorChannel", dataset_mode="diceImage",
                batch_size=1, serial_batches=True, num_threads=0,
                max_dataset_size=float("inf"))
    base.update(kw)
    return SimpleNamespace(**base)


class _Sizes:
    def __init__(self, size, original):
        self._size, self._original = size, original

    def size(self):
        return self._size

    def size_original(self):
        return self._original


@pytest.mark.parametrize("shape, roi, overlap, b", [((20, 14, 8), 8, 2, 2), ((16, 8, 8), 8, 0, 0),
                                                   ((22, 22, 15), 8, 3, 3)])
def test_dice_cube_matches_jax(shape, roi, overlap, b):
    vol = np.random.default_rng(sum(shape)).integers(0, 65535, shape).astype(np.uint16)
    ours, ref = DiceCube(vol, roi, overlap, b), JaxDiceCube(vol, roi, overlap, b)
    assert len(ours) == len(ref) > 1
    assert np.array_equal(ours.image, ref.image)
    for i in range(len(ref)):
        assert ours.grid.index_to_3d(i) == ref.indexToCoordinates(i)
        assert np.array_equal(ours[i], ref[i]) and ours[i].shape == (roi + 2 * b,) * 3


def _generator(x):
    """A stand-in output that depends on the position as well as on the
    value, so that a flip undone on the wrong axis shows."""
    return (np.sqrt(x) * 0.9 + 0.004 * np.arange(x.shape[1])[:, None, None, None]).astype(
        np.float32)


CASES = {
    "overlap": dict(),
    "overlap 0": dict(overlap=0, border_cut=0),
    "histogram match": dict(histogram_match=True),
    "normalize, uint8": dict(normalize_intensity=True, data_type="uint8"),
    "float, skip_real": dict(data_type="float", skip_real=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("repetition", [False, True])
def test_assemble_dice_matches_jax(case, repetition):
    """Random cubes for 'real' and a different 'fake' (as the generator
    would give them) through both classes, with the loop of run_legacy."""
    opt = _opt(**CASES[case])
    roi, b, step = opt.dice_size[0], opt.border_cut, opt.dice_size[0] - opt.overlap
    padded = tuple(step * n + opt.overlap for n in (3, 2, 2))
    sizes = _Sizes(padded, (padded[0] - 3, padded[1] - 1, padded[2] - 2))
    ours, ref = Assemble_Dice(opt, dataset=sizes), JaxAssemble(opt, dataset=sizes)
    assert (ours.z_steps, ours.y_steps, ours.x_steps) == (3, 2, 2)
    rng = np.random.default_rng(len(case) + repetition)
    for i in range(12):
        assert ours.indexToCoordinates(i) == ref.indexToCoordinates(i)
        real = rng.random((1, roi + 2 * b, roi + 2 * b, roi + 2 * b, 1)).astype(np.float32)
        if repetition:
            variants = ref.varycubeinput(OrderedDict(A=real, A_paths=str(i)))
            for a, v in zip(ours.varycubeinput(OrderedDict(A=real, A_paths=str(i))), variants,
                            strict=True):
                assert np.array_equal(a["A"], v["A"]) and a["A_paths"] == v["A_paths"]
            outs = [OrderedDict(real=v["A"], fake=_generator(v["A"])) for v in variants]
            cube_ref, cube = ref.combinecube(outs), ours.combinecube(outs)
            for k in cube_ref:
                assert np.array_equal(cube[k], cube_ref[k])
        else:
            cube_ref = cube = {"real": real, "fake": _generator(real)}
        ref.addToStack(cube_ref)
        ours.addToStack(cube)
    ref.assemble_all()
    ours.assemble_all()
    got, want = ours.getDict(), ref.getDict()
    assert list(got) == list(want) == (["fake"] if opt.skip_real else ["real", "fake"])
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == sizes.size_original()
        assert np.array_equal(got[k], want[k]), k
        assert np.array_equal(ours.getSnapshots(3)[k], ref.getSnapshots(3)[k])
    assert got["fake"].std() > 0


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8, np.float32])
@pytest.mark.parametrize("preprocess", ["none", "addColorChannel",
                                        "addColorChannel_addBatchChannel"])
def test_transform_matches_jax(dtype, preprocess):
    """normalize_dtype divides in float64 and the chain casts to float32 at
    its end: f32(x / 65535), which f32(x) * f32(1 / 65535) is not."""
    rng = np.random.default_rng(7)
    top = {np.uint16: 65535, np.uint8: 255, np.float32: 1}[dtype]
    vol = (rng.random((5, 6, 7)) * top).astype(dtype)
    opt = _opt(preprocess=preprocess)
    got, want = get_transform(opt)(vol), jax_get_transform(opt)(vol)
    assert got.dtype == want.dtype == np.float32 and got.flags.c_contiguous
    assert np.array_equal(got, want)
    if dtype == np.uint16:
        assert not np.array_equal(got.reshape(vol.shape),
                                  vol.astype(np.float32) * np.float32(1 / 65535))


@pytest.mark.parametrize("token", ["random3Drotate", "randomcrop", "randomflip",
                                   "random90rotate"])
def test_transform_refuses_the_random_tokens(token):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_transform(_opt(preprocess=f"{token}_addColorChannel"))


@pytest.mark.parametrize("batch_size, max_size", [(1, float("inf")), (2, 5), (3, float("inf")),
                                             (2, 3)])
def test_loader_matches_jax(tmp_path, batch_size, max_size):
    """The dataset's cubes and the loader's batches against the JAX
    package's ``create_dataset`` on the same volume and options (the
    CLI's: file order, no loader threads)."""
    vol = np.random.default_rng(3).integers(0, 65535, (13, 11, 9)).astype(np.uint16)
    (tmp_path / "in").mkdir()
    jax_tiffio.imwrite(str(tmp_path / "in" / "vol.tif"), vol)
    opt = _opt(dataroot=str(tmp_path / "in"), batch_size=batch_size, max_dataset_size=max_size)
    ours, ref = port_data.create_dataset(opt), jax_data.create_dataset(opt)
    assert len(ours) == len(ref) and ours.dataset.shape() == ref.dataset.shape() == (3, 3, 2)
    assert ours.dataset.size() == ref.dataset.size()
    assert ours.dataset.size_original() == ref.dataset.size_original() == vol.shape
    batches, want = list(ours), list(ref)
    assert len(batches) == len(want) == -(-min(18, max_size) // batch_size)
    for got, exp in zip(batches, want):
        assert got.keys() == exp.keys() and got["A_paths"] == exp["A_paths"]
        assert got["A"].dtype == np.float32 and np.array_equal(got["A"], exp["A"])


@pytest.mark.parametrize("serial, threads", [(False, 0), (True, 2)])
def test_loader_reads_neither_order_nor_thread_options(tmp_path, serial, threads):
    """The CLI sets serial_batches and num_threads 0; the loader yields file
    order on the caller's thread whatever the two say."""
    vol = np.random.default_rng(4).integers(0, 65535, (13, 11, 9)).astype(np.uint16)
    (tmp_path / "in").mkdir()
    jax_tiffio.imwrite(str(tmp_path / "in" / "vol.tif"), vol)
    opt = _opt(dataroot=str(tmp_path / "in"), batch_size=4)
    ref = list(jax_data.create_dataset(opt))
    ours = list(port_data.create_dataset(_opt(dataroot=str(tmp_path / "in"), batch_size=4,
                                              serial_batches=serial, num_threads=threads)))
    assert [b["A_paths"] for b in ours] == [b["A_paths"] for b in ref]
    assert all(np.array_equal(a["A"], b["A"]) for a, b in zip(ours, ref))


def test_registry_refuses_unported_datasets():
    assert port_data.find_dataset_using_name("diceImage").__name__ == "DiceImageDataSet"
    assert port_data.find_dataset_using_name("singlevolume").__name__ == "SingleVolumeDataset"
    assert port_data.find_dataset_using_name("cube").__name__ == "CubeDataset"
    assert port_data.find_dataset_using_name("simulationcrop").__name__ == "SimulationCropDataSet"
    for name in ("braincube", "unaligned", "aligned"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            port_data.find_dataset_using_name(name)


def test_match_histograms_and_crop_for_dicing_match_jax():
    rng = np.random.default_rng(5)
    image = rng.random((9, 8, 7)).astype(np.float32)
    reference = (rng.random((9, 8, 7)) ** 2).astype(np.float32)
    got = imageops.match_histograms(image, reference)
    assert got.dtype == np.float32
    assert np.array_equal(got, jax_imageops.match_histograms(image, reference))
    vol = rng.integers(0, 9, (30, 25, 19))
    assert np.array_equal(imageops.crop_for_dicing(vol, 8, 2),
                          jax_imageops.crop_for_dicing(vol, 8, 2))
