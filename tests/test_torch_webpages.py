"""The galleries' pieces against the JAX package's: the PNG writer without PIL
(decoded here with PIL, pixel-equal), ``HTML`` (the same text),
``save_images`` (the same page and pixel-equal thumbnails for float,
integer and 3D visuals) and ``save_test_metrics`` (the same file)."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

from neuroclear_tpu.utils import html as jax_html
from neuroclear_tpu.utils import visualizer as jax_visualizer
from neuroclear_tpu_torch.utils import html, png, visualizer


def _read_png(path):
    with Image.open(path) as im:
        return im.mode, np.asarray(im)


@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (64, 33), (260, 260)])
def test_png_writer_decodes_to_the_array(tmp_path, shape):
    img = np.random.default_rng(shape[0]).integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "a.png")
    png.write_gray8(path, img)
    mode, back = _read_png(path)
    assert mode == "L" and np.array_equal(back, img)
    assert png.read_header(path) == (shape[1], shape[0], 8, 0)


def test_png_writer_refuses_what_it_does_not_write(tmp_path):
    for bad in (np.zeros((4, 4), np.uint16), np.zeros((2, 4, 4), np.uint8),
                np.zeros((0, 4), np.uint8)):
        with pytest.raises(ValueError):
            png.encode_gray8(bad)
    (tmp_path / "x.png").write_bytes(b"GIF89a" + bytes(40))
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_header(str(tmp_path / "x.png"))


@pytest.mark.parametrize("refresh", [0, 5])
def test_html_matches_jax(tmp_path, refresh):
    pages = []
    for mod, sub in ((html, "port"), (jax_html, "jax")):
        page = mod.HTML(str(tmp_path / sub), "Experiment = e, Phase = test", refresh=refresh)
        assert os.path.isdir(page.get_image_dir())
        page.add_header("slice_z0000")
        page.add_images(["images/a/x.png", "images/b/y.png"], ["a", "b"],
                        ["images/a/x.png", "images/b/y.png"], width=384)
        page.save("page.html")
        with open(tmp_path / sub / "page.html") as f:
            pages.append(f.read())
    assert pages[0] == pages[1]


def test_save_images_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    visuals = {"output_xy": rng.integers(100, 60000, (9, 11)).astype(np.uint16),
               "input_xy": rng.integers(0, 200, (9, 11)).astype(np.uint8),
               "flat": np.full((9, 11), 7, np.uint16),
               "float": rng.random((9, 11)).astype(np.float32) * 1.2 - 0.1,
               "cube": rng.random((5, 9, 11)).astype(np.float32)}
    for mod, hmod, sub in ((visualizer, html, "port"), (jax_visualizer, jax_html, "jax")):
        page = hmod.HTML(str(tmp_path / sub), "t")
        mod.save_images(page, visuals, "slice_z0003.tif", width=300)
        mod.save_images(page, {"mip": visuals["output_xy"]}, ["dir/whole.tif"])
        page.save()
    with open(tmp_path / "port" / "index.html") as a, open(tmp_path / "jax" / "index.html") as b:
        assert a.read() == b.read()
    for label in visuals:
        rel = os.path.join("images", label, f"slice_z0003_{label}.png")
        assert _read_png(tmp_path / "port" / rel)[0] == "L"
        assert np.array_equal(_read_png(tmp_path / "port" / rel)[1],
                              _read_png(tmp_path / "jax" / rel)[1]), label
    rel = os.path.join("images", "mip", "whole_mip.png")
    assert np.array_equal(_read_png(tmp_path / "port" / rel)[1],
                          _read_png(tmp_path / "jax" / rel)[1])


def test_save_test_metrics_matches_jax(tmp_path):
    opt = SimpleNamespace(name="exp")
    for mod, sub in ((visualizer, "port"), (jax_visualizer, "jax")):
        (tmp_path / sub).mkdir()
        mod.save_test_metrics(str(tmp_path / sub), opt, [0.5, 0.61, 0.7, 0.81234],
                              [20.0, 25.5, 21.25, 30.125])
    assert ((tmp_path / "port" / "metrics.txt").read_text()
            == (tmp_path / "jax" / "metrics.txt").read_text())
