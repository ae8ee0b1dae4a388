"""Host-window crops in the port (``ops/augment.py::window_plan`` and
``sample_window_crop``, ``SingleVolumeDataset.window_crop``): the crop cut
from a window of the volume in host memory, uploaded alone, against the JAX
package's ``host_window_sample`` given the same draws, under the bounds of
JAX's own host-window test (``tests/test_transforms.py``: under 0.5% of the
voxels off by more than 1e-4, here over the draws pooled; the median under
2e-5; within 2e-5 without rotation), on a non-square 64 x 96 x 80 volume;
against the port's own card-volume crop (bit for bit: both gathers compute the same source
coordinates from the same host scalars); and through ``train_onecube``,
where JAX's switches choose the form: ``--grad_accum 2`` crops from host
windows and never uploads the volume, ``NEUROCLEAR_ACCUM_DEVICE_VOL=1``
keeps it on the device, ``NEUROCLEAR_HOST_WINDOW=1`` takes host windows at
accum 1.  The host chain (``--host_augment``, or a chain the device path
does not take) runs two iterations, and refuses ``--grad_accum``."""

import os
import shutil

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from neuroclear_tpu.ops.augment import host_window_sample
from neuroclear_tpu_torch import train_onecube
from neuroclear_tpu_torch.data.singlevolume_dataset import (HostVolumeDataset,
                                                            SingleVolumeDataset)
from neuroclear_tpu_torch.ops.augment import window_plan

VOL_SHAPE, CROP = (64, 96, 80), (24, 28, 26)
CHAINS = {"any": "random3Drotate_randomcrop_randomflip_addColorChannel_addBatchChannel",
          "90": "random90rotate_randomcrop_randomflip_addColorChannel_addBatchChannel",
          None: "randomcrop_randomflip_addColorChannel_addBatchChannel"}


@pytest.fixture(scope="module")
def vol():
    return np.random.default_rng(0).integers(0, 65535, VOL_SHAPE, dtype=np.uint16)


def _draws(ds, seed, n=8):
    gen = torch.Generator().manual_seed(seed)
    return [ds.draws(gen) for _ in range(n)]


@pytest.mark.parametrize("rotate", ["any", "90", None])
def test_window_crops_match_jaxs_host_window_sample(vol, rotate):
    """64 draws.  JAX's bound on the share of voxels off by more than 1e-4
    (0.5%) holds over the draws pooled, and its median bound (2e-5) for
    every crop.  It is not held per crop: the voxels so far off are where
    the two packages' float32 maps (the port's follows the jitted chain's
    geometry, JAX's host window its numpy form under XLA's CPU arithmetic)
    put a tap on different sides of an integer, which the volume's border
    clip turns into a jump; on this volume JAX's own host window against
    its own device chain exceeds 0.5% on 2 of 200 keys (up to 1.9%), the
    port's against JAX's host window on 1 to 4 of 200 draws (up to 3.6%, a
    90-degree draw whose crop edge runs along the border)."""
    ds = SingleVolumeDataset(vol, CROP, CHAINS[rotate], "cpu")
    off = total = 0
    for angle, (z0, y0, x0), flips in _draws(ds, seed=3, n=64):
        ours = ds.window_crop(angle, (z0, y0, x0), flips)[0, ..., 0].numpy()
        ref = np.asarray(host_window_sample(
            (float(angle or 0.0), z0, y0, x0, np.asarray(flips)), vol, CROP, ds.inv_scale,
            do_rotate=rotate == "any", do_rot90=rotate == "90", do_flip=True))
        d = np.abs(ours - ref)
        if rotate is None:
            assert d.max() < 2e-5
        assert np.median(d) < 2e-5, (angle, np.median(d))
        off, total = off + (d > 1e-4).sum(), total + d.size
    assert off / total < 0.005, off / total


@pytest.mark.parametrize("rotate", ["any", "90", None])
def test_window_crops_are_the_card_volume_crops(vol, rotate):
    """Bit for bit, over many draws; the window is JAX's (the crop's
    corners in host float32, 2 voxels of slack, ceil(hypot(cy, cx)) + 5
    wide, clipped into the volume) and the volume is never uploaded."""
    ds = SingleVolumeDataset(vol, CROP, CHAINS[rotate], "cpu")
    ref = SingleVolumeDataset(vol, CROP, CHAINS[rotate], "cpu")
    for angle, offsets, flips in _draws(ds, seed=5, n=64):
        assert torch.equal(ds.window_crop(angle, offsets, flips), ref.crop(angle, offsets, flips))
        plan = window_plan(VOL_SHAPE, angle, offsets, CROP)
        assert plan[0] == (offsets[0], offsets[0] + CROP[0])
        if angle is None:
            assert plan[1:] == ((offsets[1], offsets[1] + CROP[1]),
                                (offsets[2], offsets[2] + CROP[2]))
        else:
            wide = int(np.ceil(np.hypot(CROP[1], CROP[2]))) + 5
            assert [hi - lo for lo, hi in plan[1:]] == [min(VOL_SHAPE[1], wide),
                                                        min(VOL_SHAPE[2], wide)]
            assert all(0 <= lo and hi <= n for (lo, hi), n in zip(plan[1:], VOL_SHAPE[1:]))
    assert not ds.uploaded and ref.uploaded


def test_samplers_draw_in_the_trainers_order(vol):
    """The per-crop samplers take the n crops' draws when built, in order;
    the resident batch holds the same crops; ``sample_host_window`` is
    ``sample`` from the same generator state."""
    ds = SingleVolumeDataset(vol, CROP, CHAINS["any"], "cpu")
    samplers = []
    for make in (ds.per_crop_sampler, ds.per_crop_host_window_sampler):
        gen = torch.Generator().manual_seed(9)
        samplers.append(make(gen, 3))
        tail = torch.rand(1, generator=gen)
    batch = ds.sample_batch(torch.Generator().manual_seed(9), 3)
    assert batch.shape == (3, *CROP, 1)
    for i in range(3):
        assert torch.equal(samplers[0](i), samplers[1](i))
        assert torch.equal(samplers[0](i), batch[i:i + 1])
    gen = torch.Generator().manual_seed(9)
    draws = [ds.draws(gen) for _ in range(3)]
    assert torch.equal(torch.rand(1, generator=gen), tail)
    assert torch.equal(samplers[0](2), ds.crop(*draws[2]))
    a, b = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    assert torch.equal(ds.sample_host_window(a), ds.sample(b))


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """Each trainer run writes a 220 MB checkpoint set (the production
    nets and their Adam state): removed after its test."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _volume_dir(tmp):
    rng = np.random.default_rng(4)
    os.makedirs(tmp / "data", exist_ok=True)
    np.save(tmp / "data" / "v.npy",
            (20000 + rng.normal(0, 3000, (40, 40, 40))).clip(0, 65535).astype(np.uint16))
    return str(tmp / "data")


def _train(tmp, *extra, iters=1):
    return train_onecube.main(
        ["--dataroot", _volume_dir(tmp), "--checkpoints_dir", str(tmp / "ck"), "--name", "w",
         "--preprocess", "random3Drotate_randomcrop_randomflip_addColorChannel_addBatchChannel",
         "--crop_size", "24", "24", "24", "--seed", "0", "--device", "cpu", "--no_html",
         "--display_id", "0", "--gan_mode", "lsgan", "--lambda_A", "5", "--init_type", "kaiming",
         "--max_iters", str(iters), *extra])


@pytest.mark.usefixtures("one_thread")
def test_accum_crops_from_host_windows_unless_the_volume_is_kept_on_the_device(
        tmp_path, monkeypatch, capsys):
    """JAX's ``--grad_accum`` default: the volume stays in host memory;
    ``NEUROCLEAR_ACCUM_DEVICE_VOL=1`` uploads it.  The two runs take the
    same crops, so the same step, bit for bit."""
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard", None)
    monkeypatch.delenv("NEUROCLEAR_ACCUM_DEVICE_VOL", raising=False)
    host = _train(tmp_path / "a", "--grad_accum", "2")
    assert host["form"] == "host windows, per crop" and not host["dataset"].uploaded
    monkeypatch.setenv("NEUROCLEAR_ACCUM_DEVICE_VOL", "1")
    dev = _train(tmp_path / "b", "--grad_accum", "2")
    assert dev["form"] == "device volume, per crop" and dev["dataset"].uploaded
    assert host["losses"] == dev["losses"]
    for p, q in zip(host["model"].g_params + host["model"].d_params,
                    dev["model"].g_params + dev["model"].d_params):
        assert torch.equal(p, q)
    assert capsys.readouterr().out.count("augmentation: fused on-device chain") == 2


@pytest.mark.usefixtures("one_thread")
def test_host_window_switch_at_accum_one(tmp_path, monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard", None)
    monkeypatch.setenv("NEUROCLEAR_HOST_WINDOW", "1")
    monkeypatch.setenv("NEUROCLEAR_ACCUM_DEVICE_VOL", "1")  # read only at accum > 1
    res = _train(tmp_path)
    assert res["form"] == "host window" and not res["dataset"].uploaded
    monkeypatch.delenv("NEUROCLEAR_HOST_WINDOW")
    ref = _train(tmp_path / "r")
    assert ref["form"] == "device volume" and ref["losses"] == res["losses"]


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("extra", [
    ["--host_augment"],
    ["--preprocess",
     "random3Drotate_random90rotate_randomcrop_randomflip_addColorChannel_addBatchChannel"],
    ["--preprocess", "randomflip_addColorChannel_addBatchChannel", "--crop_size", "24", "24",
     "24"]])
def test_the_host_chain_trains(tmp_path, monkeypatch, capsys, extra):
    """``--host_augment``, both rotations, or no ``randomcrop`` (the whole
    volume, 40^3, is the crop then): two iterations on host-chain items,
    finite losses, the volume never on the device."""
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard", None)
    res = _train(tmp_path, *extra, iters=2)
    assert res["form"] == "host chain" and isinstance(res["dataset"], HostVolumeDataset)
    assert "augmentation: host (cv2) chain" in capsys.readouterr().out
    assert len(res["losses"]) == 2
    assert all(np.isfinite(v) for step in res["losses"] for v in step.values())
    shape = 40 if "randomflip_addColorChannel_addBatchChannel" in extra else 24
    assert res["model"].visuals["real"].shape == (1, shape, shape, shape, 1)


@pytest.mark.parametrize("extra", [["--host_augment"], ["--crop_size", "24", "0", "24"]])
def test_accum_with_the_host_chain_is_refused(tmp_path, extra):
    with pytest.raises(SystemExit, match="--grad_accum needs the fused on-device sampler"):
        _train(tmp_path, "--grad_accum", "2", *extra)
